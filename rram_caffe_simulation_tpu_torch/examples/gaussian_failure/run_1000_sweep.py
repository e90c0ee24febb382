"""The multi-group durable sweep (the reference's
examples/gaussian_failure/run_1000_sweep.py, ported whole): N fault
configs of one solver run as resident `SweepRunner` groups, one after
another, with the next group built while the current one runs.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_1000_sweep \\
        [--configs 1000] [--group 1000] [--block 250] [--iters 5000] \\
        [--chunk 50] [--run-dir sweeps/run0]        # durable
    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_1000_sweep \\
        --resume sweeps/run0

Overlap: each group's runner is built by a `GroupPrefetcher` thread
while the group before it runs (fault draw, placement, dataset decode,
and with `precompile_chunk` the kernel libraries' build and load beside
the decode); `--no-overlap` builds each group serially. The record
reports each group's build seconds hidden that way.

Durability (`--run-dir DIR`): a manifest, an fsynced completion journal
(one line a finished group), per-group fault-state `.npz` files,
per-group metrics JSONL, and in-flight group checkpoints
(`--checkpoint-every`). SIGTERM or SIGINT drains the pipeline, writes a
checkpoint within `--grace-seconds` and exits 75; `--resume DIR` skips
the journaled groups and restores the in-flight one mid-run, bit for
bit against a run that never stopped.

The completion contract: every group runs self-healing; the run ends
when each config is completed or failed with a diagnosis, writes
`<run-dir>/sweep_report.json` and exits 0 (all completed), 65 (some
failed) or 75 (preempted or stalled: resume it).

Where the port differs from the reference's driver, each loudly:
`--device` (default cuda; raises without a card, cpu by name);
`--engine` takes the port's engines (auto, cuda, torch); one process
only (`--multihost`, `--coordinator`, `--num-processes`, `--process-id`
raise, ROADMAP A14); compute runs in float32 (the reference's driver
trains in bfloat16; the port's `compute_dtype` is ROADMAP A4/A12b);
the record has no TPU-pod projection. `--process` takes any spec of
the fault-process registry (fault/processes/), as the reference's does.
Relative paths (the solver, its
net, its Data sources, its snapshot prefix) resolve from the working
directory when they exist there, else from the checkout's root.
"""
import argparse
import json
import math
import os
import shutil
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: EX_TEMPFAIL: preempted (SIGTERM/SIGINT) or stalled; resume the run
PREEMPTED_EXIT = 75

#: EX_DATAERR: finished with permanently failed configs (partial results,
#: a diagnosis a failed config in sweep_report.json)
PARTIAL_EXIT = 65

#: manifest keys that pin the run's math; --resume restores them
MANIFEST_ARGS = ("configs", "group", "block", "iters", "chunk", "mean",
                 "std", "pipeline_depth", "solver", "checkpoint_every",
                 "max_retries", "retry_backoff", "process")

#: the fault process of every run dir without a pin (and the default)
DEFAULT_PROCESS = "endurance_stuck_at"

#: the reference's flags of a multi-process run, refused by name
MULTIPROCESS_FLAGS = ("multihost", "coordinator", "num_processes",
                      "process_id")


def _journal_append(path: str, rec: dict):
    """One fsynced JSONL line: the journal must survive the SIGKILL the
    checkpoint races."""
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _read_journal(path: str):
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    recs.append(json.loads(line))
    return recs


def _ckpt_ready(path: str) -> bool:
    """A usable checkpoint at `path`: the single file, or a distributed
    directory whose manifest.json commit record landed."""
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "manifest.json"))
    return os.path.exists(path)


def _ckpt_iter(path: str) -> int:
    if os.path.isdir(path):
        with open(os.path.join(path, "manifest.json")) as f:
            return int(json.load(f)["meta"]["iter"])
    with np.load(path) as z:
        meta = json.loads(bytes(bytearray(z["__meta__"])).decode())
    return int(meta["iter"])


def _ckpt_remove(path: str):
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass


def _truncate_metrics(path: str, upto_iter: int):
    """Drop the metrics records the restored checkpoint has not replayed
    (a chunk record's `iter` is its last iteration: every record at or
    past the checkpoint's iteration goes), so the re-run chunks do not
    appear twice."""
    if not os.path.exists(path):
        return
    kept = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            it = rec.get("iter")
            if not isinstance(it, int) or it < upto_iter:
                kept.append(line)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for line in kept:
            f.write(line + "\n")
    os.replace(tmp, path)


def _in_checkout(path: str) -> str:
    """A relative path from the working directory when it exists there,
    else from the checkout's root."""
    if not path or os.path.isabs(path) or os.path.exists(path):
        return path
    cand = os.path.join(REPO, path)
    return cand if os.path.exists(cand) else path


def _solver_param(path: str):
    """The solver prototxt with its relative paths resolved
    (`_in_checkout`): the net file (inlined as net_param), every Data
    layer's source and the snapshot prefix."""
    from ...utils.io import read_net_param, read_solver_param
    param = read_solver_param(_in_checkout(path))
    if param.HasField("net"):
        net = read_net_param(_in_checkout(param.net))
        param.ClearField("net")
        param.net_param = net
    for field in ("net_param", "train_net_param"):
        if param.HasField(field):
            for lp in getattr(param, field).layer:
                if lp.HasField("data_param") and lp.data_param.source:
                    lp.data_param.source = _in_checkout(
                        lp.data_param.source)
    prefix = param.snapshot_prefix
    if prefix and not os.path.isabs(prefix):
        param.snapshot_prefix = os.path.join(REPO, prefix)
    return param


def main(argv=None):
    from ...fault.processes import FaultSpec
    from ...parallel.sweep import SWEEP_ENGINES
    p = argparse.ArgumentParser()
    p.add_argument("--configs", type=int, default=1000)
    p.add_argument("--group", type=int, default=1000,
                   help="configs resident per runner")
    p.add_argument("--block", type=int, default=250,
                   help="configs computed per block inside the step "
                        "(activation memory scales with the block, "
                        "resident state with the group); 0 disables "
                        "blocking")
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--mean", type=float, default=1e8)
    p.add_argument("--std", type=float, default=3e7)
    p.add_argument("--solver", default=(
        "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt"),
        help="solver prototxt the per-group Solver is built from "
             "(failure pattern / seed / display are overridden here)")
    p.add_argument("--process", default=None,
                   help="fault-process stack spec (fault/processes/ "
                        "registry; default endurance_stuck_at, the "
                        "fork's model). Pinned in the run-dir manifest: "
                        "--resume refuses a spec whose canonical form "
                        "differs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises "
                        "without a card; cpu by name)")
    p.add_argument("--engine", default="auto", choices=SWEEP_ENGINES,
                   help="crossbar engine: cuda (the kernels), torch (their "
                        "plain versions), auto (cuda on the card); the "
                        "resolution lands in sweep_report.json")
    p.add_argument("--dtype-policy", default="",
                   help="quantized sweep compute ('' | ternary | int8): "
                        "fault-target weight reads through the ADC grid "
                        "(also what arms the crossbar kernel at sigma 0)")
    p.add_argument("--packed-state", action="store_true",
                   help="bit-packed fault banks (fault/packed.py)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="in-flight chunks whose host bookkeeping the "
                        "consumer thread hides; 0 = synchronous "
                        "bookkeeping at every chunk boundary")
    p.add_argument("--no-overlap", action="store_true",
                   help="build each group's runner serially instead of "
                        "prefetching group N+1 while group N runs")
    p.add_argument("--run-dir", default="",
                   help="durable run directory: manifest + completion "
                        "journal + per-group fault/metrics files + "
                        "in-flight checkpoints; SIGTERM/SIGINT then "
                        "checkpoint-and-exit(75) instead of dying")
    p.add_argument("--resume", default="",
                   help="resume a durable run directory: journaled "
                        "groups are skipped, the in-flight group is "
                        "restored mid-run (bit-exact vs uninterrupted)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="iterations between periodic in-flight group "
                        "checkpoints (rounded up to a --chunk "
                        "multiple); 0 = checkpoint only on preemption")
    p.add_argument("--grace-seconds", type=float, default=30.0,
                   help="preemption grace budget: the final checkpoint "
                        "is only attempted while this much time "
                        "remains since the signal landed")
    p.add_argument("--max-retries", type=int, default=1,
                   help="per-config retry budget: how many times a "
                        "quarantined (NaN) config is re-seeded into a "
                        "reclaimed lane before it is failed with a "
                        "diagnosis")
    p.add_argument("--retry-backoff", type=int, default=0,
                   help="iteration backoff per retry: attempt k waits "
                        "k * this many iterations before its lane is "
                        "re-seeded")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="seconds of consumer-heartbeat silence before "
                        "a stalled chunk aborts the run with a "
                        "best-effort checkpoint and exit 75; 0 = off")
    p.add_argument("--trace", action="store_true",
                   help="arm the host span tracer: spans in each group's "
                        "metrics stream, <run-dir>/trace/spans.p0."
                        "trace.json and, on a clean finish, "
                        "trace/merged.trace.json")
    p.add_argument("--inject-nan", default="",
                   help="test hook: 'CFG@ITER' poisons global config "
                        "CFG's params with NaN at the first step "
                        "boundary at/after iteration ITER; append "
                        "':always' to re-poison every attempt")
    p.add_argument("--multihost", action="store_true",
                   help="not ported (ROADMAP A14): raises")
    p.add_argument("--coordinator", default=None,
                   help="not ported (ROADMAP A14): raises")
    p.add_argument("--num-processes", type=int, default=None,
                   help="not ported (ROADMAP A14): raises")
    p.add_argument("--process-id", type=int, default=None,
                   help="not ported (ROADMAP A14): raises")
    args = p.parse_args(argv)

    for flag in MULTIPROCESS_FLAGS:
        if getattr(args, flag) is not None and getattr(args, flag) \
                is not False:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: the multi-process sweep is "
                "not ported to the PyTorch/CUDA package (ROADMAP A14); "
                "the port's driver runs one process")
    from ...device import resolve_device
    device = resolve_device(args.device)
    print("compute_dtype float32: the port's Solver has no compute_dtype "
          "yet (ROADMAP A4/A12b); the reference's driver trains in "
          "bfloat16", flush=True)

    def _preempted(preempt: dict) -> bool:
        """Whether a signal landed (one process: no agreement round)."""
        return bool(preempt)

    run_dir = os.path.abspath(args.resume or args.run_dir) \
        if (args.resume or args.run_dir) else ""
    resuming = bool(args.resume)
    manifest_path = os.path.join(run_dir, "manifest.json") if run_dir \
        else ""
    journal_path = os.path.join(run_dir, "journal.jsonl") if run_dir \
        else ""
    if resuming:
        with open(manifest_path) as f:
            manifest = json.load(f)
        # the fault-process pin: a resume under another process is
        # refused rather than replaying the wrong physics. Specs compare
        # canonical (stack order and number formatting normalized), so
        # an equal spec written another way resumes; an unparseable one
        # compares as text and the Solver raises its parse error
        pinned = manifest.get("process") or DEFAULT_PROCESS

        def _canon(spec):
            try:
                return FaultSpec.parse(spec).canonical()
            except Exception:
                return str(spec).strip()

        if args.process is not None \
                and _canon(args.process) != _canon(pinned):
            p.error(
                f"--resume {run_dir} was trained under fault process "
                f"{pinned!r} (manifest pin) but --process requests "
                f"{args.process!r}; resume without --process, or with "
                "the pinned spec")
        for key in MANIFEST_ARGS:
            setattr(args, key, manifest.get(key, getattr(args, key)))
        print(f"Resuming {run_dir}: manifest restored "
              f"({args.configs} configs, groups of {args.group}, "
              f"{args.iters} iters, process "
              f"{args.process or DEFAULT_PROCESS})", flush=True)
    if args.process is None:
        args.process = DEFAULT_PROCESS
    # the manifest and the record carry the canonical spec (an unknown
    # process or a bad parameter raises here, by name)
    args.process = FaultSpec.parse(args.process).canonical()

    from ...async_exec import StallError
    from ...observe.sink import JsonlSink
    from ...observe import spans as obs_spans
    from ...parallel import GroupPrefetcher, SweepRunner
    from ...solver import Solver

    # one tracer for the whole run: the groups' spans and the prefetched
    # builds that overlap them share one timeline
    tracer = obs_spans.SpanTracer(process_index=0) if args.trace else None
    if tracer is not None:
        tracer.set_thread_role("dispatcher")

    def _write_trace():
        """The process's Chrome trace under <run-dir>/trace/ (nothing
        without --trace and --run-dir)."""
        if tracer is None or not run_dir:
            return None
        return tracer.write_chrome_trace(
            os.path.join(run_dir, "trace", "spans.p0.trace.json"))

    groups = [args.group] * (args.configs // args.group)
    if args.configs % args.group:
        groups.append(args.configs % args.group)

    # completed groups (the journal is append-only and groups run in
    # order, so they are a prefix); the first other group may have an
    # in-flight checkpoint to restore
    done_recs = {}
    if resuming:
        for rec in _read_journal(journal_path):
            if rec.get("event") == "group":
                done_recs[rec["group"]] = rec
    frontier = len(done_recs)

    def ckpt_path(gi):
        return os.path.join(run_dir, f"group_{gi}.ckpt.npz")

    def metrics_path(gi):
        return os.path.join(run_dir, f"metrics_g{gi}.jsonl")

    def journal(rec):
        _journal_append(journal_path, rec)

    def build_runner(gi, n_cfg):
        param = _solver_param(args.solver)
        param.failure_pattern.type = "gaussian"
        param.failure_pattern.mean = args.mean
        param.failure_pattern.std = args.std
        param.random_seed = 7 + gi
        param.display = 0
        param.ClearField("test_interval")
        solver = Solver(param, device=device, fault_process=args.process)
        if run_dir:
            # the in-flight group appends to its records only when its
            # checkpoint landed (no checkpoint: the group restarts, and
            # so do its records); unbuffered, so the records are on disk
            # when a SIGKILL lands
            solver.enable_metrics(JsonlSink(
                metrics_path(gi),
                append=(resuming and gi == frontier
                        and _ckpt_ready(ckpt_path(gi))),
                unbuffered=True))
        # groups at or under the block need none; an indivisible larger
        # remainder falls back to the gcd
        if not args.block or n_cfg <= args.block:
            block = 0
        elif n_cfg % args.block == 0:
            block = args.block
        else:
            block = math.gcd(n_cfg, args.block)
        runner = SweepRunner(solver, n_configs=n_cfg, config_block=block,
                             precompile_chunk=args.chunk,
                             pipeline_depth=args.pipeline_depth,
                             stall_timeout_s=args.stall_timeout or None,
                             engine=args.engine,
                             dtype_policy=args.dtype_policy or None,
                             packed_state=args.packed_state, device=device)
        if tracer is not None:
            runner.enable_tracing(tracer)
        # what ran, never the request; groups that resolve differently
        # report "mixed", and a stale fallback reason is cleared
        engine_info["engine_requested"] = args.engine
        prev = engine_info.get("engine_resolved")
        engine_info["engine_resolved"] = (
            runner.engine_resolved
            if prev in (None, runner.engine_resolved) else "mixed")
        if runner.engine_fallback_reason:
            engine_info["engine_fallback_reason"] = \
                runner.engine_fallback_reason
        elif engine_info["engine_resolved"] == runner.engine_resolved:
            engine_info.pop("engine_fallback_reason", None)
        # the completion contract: every config trains --iters or fails
        # with a diagnosis after its retries
        runner.enable_self_healing(budget=args.iters,
                                   max_retries=args.max_retries,
                                   backoff_iters=args.retry_backoff)
        return runner

    # --- the completion ledger (sweep_report.json): global config id ->
    # its entry; each group's local report offset by the configs before
    offsets = [0]
    for n_cfg in groups[:-1]:
        offsets.append(offsets[-1] + n_cfg)
    ledger: dict = {}
    engine_info: dict = {}

    def _merge_report(gi, report):
        off = offsets[gi]
        for cs, v in (report.get("completed") or {}).items():
            ledger[off + int(cs)] = dict(v, group=gi)
        for cs, v in (report.get("failed") or {}).items():
            ledger[off + int(cs)] = dict(v, group=gi)
        for cs, v in (report.get("active") or {}).items():
            ledger[off + int(cs)] = dict(v, group=gi, status="pending")
        for e in report.get("pending") or []:
            ledger[off + int(e["config"])] = {
                "status": "pending", "group": gi,
                "attempt": int(e["attempt"])}

    def _write_report(status: str, exit_code: int) -> dict:
        """The completion report, every requested config completed,
        failed or pending; written atomically in a durable run."""
        for c in range(args.configs):
            ledger.setdefault(c, {"status": "pending"})
        n_done = sum(1 for v in ledger.values()
                     if v.get("status") == "completed")
        failed = sorted(c for c, v in ledger.items()
                        if v.get("status") == "failed")
        retried = sorted(
            c for c, v in ledger.items()
            if int(v.get("attempts", v.get("attempt", 1)) or 1) > 1)
        report = {
            "schema_version": 1,
            "status": status, "exit_code": exit_code,
            "requested": args.configs,
            "completed": n_done, "failed": failed, "retried": retried,
            "max_retries": args.max_retries,
            "retry_backoff": args.retry_backoff,
            **engine_info,
            "configs": {str(c): ledger[c] for c in sorted(ledger)},
        }
        if run_dir:
            path = os.path.join(run_dir, "sweep_report.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=2)
            os.replace(tmp, path)
        return report

    # --- the NaN injection test hook
    inject = None
    if args.inject_nan:
        spec = args.inject_nan
        always = spec.endswith(":always")
        body = spec[:-len(":always")] if always else spec
        cfg_s, it_s = body.split("@")
        inject = {"config": int(cfg_s), "iter": int(it_s),
                  "always": always, "done": False}

    def _maybe_inject(runner, gi):
        """NaN into the injected config's first fault-target weight once
        it is resident and the iteration reached (a step boundary)."""
        if inject is None or (inject["done"] and not inject["always"]):
            return
        local = inject["config"] - offsets[gi]
        if not (0 <= local < runner.n) or runner.iter < inject["iter"]:
            return
        lane = runner.config_report()["active"].get(local, {}).get("lane")
        if lane is None:
            return
        layer, slot = runner.solver._fault_keys[0].rsplit("/", 1)

        def _poison(row):
            row = np.array(row)
            row.flat[0] = np.nan
            return row

        runner.params[layer][int(slot)] = runner._edit_leaf_rows(
            runner.params[layer][int(slot)], {int(lane): _poison})
        inject["done"] = True
        print(f"Injected NaN into config {inject['config']} "
              f"(lane {lane}) at iteration {runner.iter}", flush=True)

    # --- preemption (durable runs): the handler only sets a flag
    preempt: dict = {}

    def _on_signal(signum, frame):
        preempt.setdefault("signal", signal.Signals(signum).name)
        preempt.setdefault("t", time.monotonic())

    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        if not resuming:
            with open(manifest_path, "w") as f:
                json.dump({k: getattr(args, k) for k in MANIFEST_ARGS},
                          f, indent=2)
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def _close_runner(runner):
        logger = runner.solver.metrics_logger
        runner.close()
        if logger is not None:
            logger.close()

    def _preempt_exit(runner, gi):
        """Drain, checkpoint the in-flight group within the grace
        budget, journal the preemption, write the report ("preempted")
        and exit 75."""
        left = args.grace_seconds - (time.monotonic() - preempt["t"])
        wrote = None
        if runner is not None and left > 0:
            wrote = runner.checkpoint(ckpt_path(gi))
        if runner is not None:
            _merge_report(gi, runner.config_report())
            _close_runner(runner)
        journal({
            "event": "preempt", "signal": preempt["signal"],
            "group": gi,
            "iter": int(runner.iter) if runner is not None else 0,
            "checkpoint": os.path.basename(wrote) if wrote else None})
        _write_trace()
        _write_report("preempted", PREEMPTED_EXIT)
        print(f"Preempted by {preempt['signal']} in group {gi}"
              + (f"; checkpoint {wrote}" if wrote
                 else "; grace budget exhausted, no checkpoint"),
              flush=True)
        sys.exit(PREEMPTED_EXIT)

    def _stall_exit(err, runner, gi):
        """A chunk's bookkeeping stalled past --stall-timeout: move the
        runner's emergency checkpoint into the run dir, journal the
        stall and exit 75 (without a run dir, re-raise)."""
        wrote = None
        if run_dir and getattr(err, "checkpoint_path", None) \
                and os.path.exists(err.checkpoint_path):
            shutil.move(err.checkpoint_path, ckpt_path(gi))
            wrote = ckpt_path(gi)
        if runner is not None:
            _merge_report(gi, runner.config_report())
        if run_dir:
            journal({
                "event": "stall", "group": gi,
                "iter": int(runner.iter) if runner is not None else 0,
                "checkpoint": os.path.basename(wrote) if wrote else None})
            _write_trace()
            _write_report("preempted", PREEMPTED_EXIT)
            print(f"Stalled in group {gi}: {err}"
                  + (f"; checkpoint {wrote}" if wrote else ""),
                  flush=True)
            # the consumer thread is stuck: no close barriers, the
            # daemon threads die with the process
            sys.exit(PREEMPTED_EXIT)
        raise err

    # checkpoint cadence, aligned to chunk boundaries so a resumed run
    # replays the same chunks; the poll slice returns from step() often
    # enough for the preemption flag to be read within the grace budget
    ck_every = 0
    if args.checkpoint_every and run_dir:
        ck_every = max(args.chunk, math.ceil(
            args.checkpoint_every / max(args.chunk, 1)) * args.chunk)
    poll_every = ck_every or (args.chunk * 4 if run_dir else 0)

    t_total = time.perf_counter()
    done = 0
    blocks_used, overlap_s, host_blocked_s = [], [], []
    runner = None
    gi = -1
    # leaving the block (a raised step, a preemption exit) cancels the
    # build in flight
    with GroupPrefetcher() as prefetch:
        prefetch.tracer = tracer
        for gi, n_cfg in enumerate(groups):
            if gi in done_recs:
                rec = done_recs[gi]
                blocks_used.append(rec.get("config_block", 0))
                overlap_s.append(rec.get("setup_overlap_seconds", 0.0))
                host_blocked_s.append(rec.get("host_blocked_seconds",
                                              0.0))
                rep = rec.get("report")
                if rep:
                    _merge_report(gi, {"completed": rep.get("completed",
                                                            {}),
                                       "failed": rep.get("failed", {})})
                else:
                    # a journal without reports: the group finished, each
                    # config completed at its first attempt
                    losses = rec.get("loss") or []
                    _merge_report(gi, {"completed": {
                        str(i): {"status": "completed", "attempts": 1,
                                 "loss": (losses[i] if i < len(losses)
                                          else None)}
                        for i in range(n_cfg)}})
                done += n_cfg
                continue
            if _preempted(preempt):
                # between groups: nothing in flight to checkpoint
                _preempt_exit(None, gi)
            if runner is None:
                restoring = (resuming and gi == frontier
                             and _ckpt_ready(ckpt_path(gi)))
                if restoring:
                    # a run dir a multi-process run of the reference left
                    # keeps process 0's stream
                    p0 = os.path.join(run_dir, f"metrics_g{gi}.p0.jsonl")
                    if not os.path.exists(metrics_path(gi)) \
                            and os.path.exists(p0):
                        shutil.copyfile(p0, metrics_path(gi))
                    # records past the checkpoint would repeat once the
                    # restored state re-runs those chunks
                    _truncate_metrics(metrics_path(gi),
                                      _ckpt_iter(ckpt_path(gi)))
                runner = build_runner(gi, n_cfg)
                if restoring:
                    runner.restore(ckpt_path(gi))
                    print(f"group {gi}: restored in-flight checkpoint "
                          f"at iteration {runner.iter}", flush=True)
            if not args.no_overlap and gi + 1 < len(groups):
                # the next group's whole setup runs behind this group
                prefetch.start(build_runner, gi + 1, groups[gi + 1])
            t0 = time.perf_counter()
            try:
                while not runner.healing_complete():
                    _maybe_inject(runner, gi)
                    runner.step(poll_every or args.iters,
                                chunk=args.chunk)
                    if _preempted(preempt):
                        _preempt_exit(runner, gi)
                    if ck_every and not runner.healing_complete():
                        runner.checkpoint(ckpt_path(gi))
            except StallError as e:
                _stall_exit(e, runner, gi)
            report = runner.config_report()
            completed, failed = report["completed"], report["failed"]
            if run_dir and any(v.get("loss") is None
                               for v in completed.values()):
                # the restored checkpoint already covered every
                # iteration: the final losses are in the last chunk
                # record where the config still held its lane
                mrecs = [r for r in _read_journal(metrics_path(gi))
                         if r.get("type") is None]
                for c, v in completed.items():
                    lane = v.get("lane")
                    if v.get("loss") is not None or lane is None:
                        continue
                    for r in reversed(mrecs):
                        lm = r.get("lane_map")
                        if lm is not None and (lane >= len(lm)
                                               or lm[lane] != int(c)):
                            continue
                        lv = r.get("loss")
                        lv = lv if isinstance(lv, list) else [lv]
                        if lane < len(lv):
                            v["loss"] = lv[lane]
                        break
            final_loss = [completed.get(c, {}).get("loss")
                          for c in range(n_cfg)]
            failed_ids = sorted(failed)
            retried = sorted(c for c, v in {**completed,
                                            **failed}.items()
                             if int(v.get("attempts", 1)) > 1)
            broken_vals = [v.get("broken") for v in completed.values()
                           if v.get("broken") is not None]
            broken_mean = (float(np.mean(broken_vals)) if broken_vals
                           else float(runner.broken_fractions().mean()))
            _merge_report(gi, report)
            dt = time.perf_counter() - t0
            blocks_used.append(runner.config_block)
            pipe = runner.setup_record().get("pipeline", {})
            overlap_s.append(round(pipe.get("setup_overlap_seconds",
                                            0.0), 2))
            host_blocked_s.append(round(pipe.get("host_blocked_seconds",
                                                 0.0), 4))
            fault_npz = None
            if run_dir:
                fault_npz = f"group_{gi}_faults.npz"
                runner.save_fault_states(
                    os.path.join(run_dir, fault_npz), background=False)
            _close_runner(runner)
            runner = None
            # a signal that landed during finalization is serviced after
            # the group's journal line: exiting first would discard a
            # trained group on resume
            if run_dir:
                journal({
                    "event": "group", "group": gi, "n_configs": n_cfg,
                    "iters": args.iters,
                    "config_block": blocks_used[-1],
                    "loss": final_loss,
                    "broken_mean": broken_mean,
                    "quarantine": failed_ids,
                    "report": {
                        "completed": {str(c): v
                                      for c, v in completed.items()},
                        "failed": {str(c): v for c, v in failed.items()}},
                    "fault_npz": fault_npz,
                    "wall_seconds": round(dt, 3),
                    "setup_overlap_seconds": overlap_s[-1],
                    "host_blocked_seconds": host_blocked_s[-1],
                    "checkpoint_write_seconds": round(pipe.get(
                        "checkpoint_write_seconds", 0.0), 4)})
                _ckpt_remove(ckpt_path(gi))      # the group is done
            done += n_cfg
            tail = ""
            if retried:
                tail += f"; retried {retried}"
            if failed_ids:
                tail += f"; failed {failed_ids}"
            print(f"group {gi}: {n_cfg} configs x {args.iters} iters in "
                  f"{dt / 60:.2f} min (broken mean {broken_mean:.3f})"
                  f"{tail}; {done}/{args.configs} done", flush=True)
            if gi + 1 < len(groups) and (gi + 1) not in done_recs:
                if _preempted(preempt):
                    # no grace budget spent on a group about to be
                    # abandoned (leaving the block cancels its build)
                    _preempt_exit(None, gi + 1)
                runner = (build_runner(gi + 1, groups[gi + 1])
                          if args.no_overlap else prefetch.take())
                if _preempted(preempt):
                    _preempt_exit(runner, gi + 1)
    total_min = (time.perf_counter() - t_total) / 60
    if tracer is not None and run_dir:
        _write_trace()
        from ...observe.spans import merge_chrome_traces
        tdir = os.path.join(run_dir, "trace")
        part = os.path.join(tdir, "spans.p0.trace.json")
        merge_chrome_traces([part] if os.path.exists(part) else [],
                            os.path.join(tdir, "merged.trace.json"))
    n_failed = sum(1 for v in ledger.values()
                   if v.get("status") == "failed")
    status = "partial" if n_failed else "clean"
    exit_code = PARTIAL_EXIT if n_failed else 0
    sweep_report = _write_report(status, exit_code)
    rec = {
        "configs": args.configs,
        "iters_per_config": args.iters,
        "batch": 100,
        "groups": groups,
        "config_block": blocks_used,
        "wall_minutes_one_chip": round(total_min, 2),
        "configs_per_hour_one_chip": round(args.configs
                                           / (total_min / 60), 1),
        "compute_dtype": "float32",
        "process": args.process,
        "pipeline_depth": args.pipeline_depth,
        "overlapped_groups": not args.no_overlap,
        # per group: the build seconds take() did not wait for (not
        # wall time saved where the build competed with the group
        # before), and the dispatcher's host-blocked seconds
        "group_setup_overlap_seconds": overlap_s,
        "host_blocked_seconds": host_blocked_s,
        "run_dir": run_dir or None,
        "groups_resumed": len(done_recs),
        "processes": 1,
        "chips": 1,
        "status": status,
        "completed_configs": sweep_report["completed"],
        "failed_configs": sweep_report["failed"],
        "retried_configs": sweep_report["retried"],
    }
    if run_dir:
        journal({"event": "done", "configs": args.configs,
                 "status": status})
    if any(overlap_s):
        print("setup_overlap_seconds: each prefetched build's seconds on "
              "its thread that take() did not wait for; not wall time "
              "saved where the build competed with the running group "
              "(on the card its fault draws share the SMs)", flush=True)
    print(json.dumps(rec), flush=True)
    if exit_code:
        sys.exit(exit_code)
    return rec


if __name__ == "__main__":
    main()
