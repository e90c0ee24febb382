"""The port's multi-group durable sweep driver
(rram_caffe_simulation_tpu_torch/examples/gaussian_failure/
run_1000_sweep.py) against the reference's, on the CPU.

The inputs are those of scripts/check_resume_equivalence.py (the
24-record LMDB, the one-InnerProduct solver; the driver sets lifetimes
N(300, 60), seed 7 + group and self-healing itself): 6 configs in groups
of 4 (groups [4, 2]) and of 2 ([2, 2, 2]), 16 iterations in chunks of 2,
depth 2, a run directory (the poll slice is then 8 iterations: two
step() calls a group).

- Numbers: each group's journal `loss` (within 1e-5 relative),
  `broken_mean` and `group_N_faults.npz` (bit for bit) equal a reference
  `SweepRunner` built as the reference driver's `build_runner` builds it
  (seed 7 + group, the block, precompile_chunk, the self-healing budget),
  at float32: the reference driver's bfloat16 Solver cannot be matched.
- The file contract against the reference's own driver (`main(argv)` on
  the same point, run once): the journal's event sequence and each
  record's keys, sweep_report.json's keys and every config's status, the
  final record's keys (the port's lacks the TPU-pod projection), the
  exit codes.
- Overlapped and `--no-overlap` runs equal in every durable file, timing
  fields aside (the resume guard's TIMING_FIELDS).
- Preemption: `SweepRunner.step` sends SIGTERM at a fixed call (mid-group
  and at a group's end); the run exits 75 with its checkpoint journaled,
  and `--resume` ends equal to the uninterrupted run as the resume guard
  diffs it (journal group records, metrics streams, fault npz, report).
- `--inject-nan 1@2` is retried and exits 0; `1@2:always` exits 65 with
  config 1 failed and diagnosed (scripts/check_lane_reclamation.py's
  contract), the healthy configs' losses and fault rows those of the
  clean run.
- Another fault process: `--process read_disturb` runs, pins the spec,
  and its group equals the reference runner under the same stack.
- Refusals by name: the multi-process flags, a conflicting manifest pin
  on `--resume`; `--device cuda` without a card.
"""
import contextlib
import importlib.util
import io
import json
import os
import signal

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_1000_sweep as tdriver
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep

from test_torch_group_prefetch import build_db, solver_text
from test_torch_self_healing import REL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_FIELDS = ("wall_time", "step_latency_s", "iters_per_s",
                 "wall_seconds", "setup_overlap_seconds",
                 "host_blocked_seconds", "checkpoint_write_seconds")
ITERS, CHUNK, POLL = 16, 2, 8


def point(solver, run_dir, group=4, *extra):
    return ["--solver", solver, "--configs", "6", "--group", str(group),
            "--block", "0", "--iters", str(ITERS), "--chunk", str(CHUNK),
            "--mean", "300", "--std", "60", "--pipeline-depth", "2",
            "--run-dir", str(run_dir), *extra]


def run_main(main, argv):
    """(exit code, final record, stdout) of a driver's main(argv), with
    the working directory and the SIGTERM/SIGINT handlers restored."""
    cwd = os.getcwd()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    out = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    except SystemExit as e:
        code = e.code
    finally:
        os.chdir(cwd)
        for s, h in handlers.items():
            signal.signal(s, h)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return code, (json.loads(lines[-1]) if lines else None), out.getvalue()


def run_port(argv):
    return run_main(tdriver.main, ["--device", "cpu", *argv])


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def strip(recs):
    return [{k: v for k, v in r.items() if k not in TIMING_FIELDS}
            for r in recs]


def durable(run_dir):
    """Every durable file of a run directory, timing fields aside: the
    journal, each metrics stream, sweep_report.json and the fault npz
    arrays' bytes."""
    out = {"journal": json.dumps(strip(read_jsonl(
        os.path.join(run_dir, "journal.jsonl"))))}
    for name in sorted(os.listdir(run_dir)):
        path = os.path.join(run_dir, name)
        if name.startswith("metrics_g"):
            out[name] = json.dumps(strip(read_jsonl(path)))
        elif name.endswith("_faults.npz"):
            with np.load(path) as z:
                out[name] = {k: z[k].tobytes() for k in z.files}
        elif name == "sweep_report.json":
            with open(path) as f:
                out[name] = json.load(f)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    db = build_db(root / "db")
    text = solver_text(db, root, fault=False)
    path = root / "solver.prototxt"
    path.write_text(text)
    return {"root": root, "solver": str(path), "text": text}


@pytest.fixture(scope="module")
def clean(inputs):
    """The port's uninterrupted overlapped runs, groups [4, 2] and
    [2, 2, 2]."""
    runs = {}
    for group in (4, 2):
        d = inputs["root"] / f"clean_{group}"
        code, rec, _ = run_port(point(inputs["solver"], d, group))
        runs[group] = {"dir": str(d), "code": code, "rec": rec}
    return runs


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's own driver on the same point (bfloat16, engine
    "jax", x64 off), run in this process once."""
    spec = importlib.util.spec_from_file_location(
        "reference_run_1000_sweep",
        os.path.join(REPO, "examples", "gaussian_failure",
                     "run_1000_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = inputs["root"] / "reference"
    with jax.enable_x64(False):
        code, rec, _ = run_main(mod.main, point(inputs["solver"], d))
    return {"dir": str(d), "code": code, "rec": rec}


def ref_group(text, gi, n_cfg, path, process=None):
    """Group gi as the reference driver's build_runner builds it, at
    float32, under the fault-process spec `process`; its report after
    the driver's step loop, its fault states saved to `path`."""
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean = 300.0
    sp.failure_pattern.std = 60.0
    sp.random_seed = 7 + gi
    sp.display = 0
    sp.ClearField("test_interval")
    r = JSweep(JSolver(sp, fault_process=process), n_configs=n_cfg,
               config_block=0,
               precompile_chunk=CHUNK, pipeline_depth=2, engine="jax")
    r.enable_self_healing(budget=ITERS, max_retries=1, backoff_iters=0)
    while not r.healing_complete():
        r.step(POLL, chunk=CHUNK)
    rep = r.config_report()
    r.save_fault_states(str(path), background=False)
    r.close()
    return rep


@pytest.mark.parametrize("group,sizes", [(4, [4, 2]), (2, [2, 2, 2])])
def test_groups_equal_the_reference_runner(inputs, clean, tmp_path, group,
                                           sizes):
    run = clean[group]
    assert run["code"] == 0 and run["rec"]["groups"] == sizes
    recs = [r for r in read_jsonl(os.path.join(run["dir"], "journal.jsonl"))
            if r["event"] == "group"]
    assert [r["group"] for r in recs] == list(range(len(sizes)))
    with jax.enable_x64(False):
        for gi, n_cfg in enumerate(sizes):
            path = tmp_path / f"ref_{gi}.npz"
            rep = ref_group(inputs["text"], gi, n_cfg, path)
            want = [rep["completed"][c]["loss"] for c in range(n_cfg)]
            np.testing.assert_allclose(recs[gi]["loss"], want, rtol=REL)
            broken = np.mean([np.float32(rep["completed"][c]["broken"])
                              for c in range(n_cfg)])
            np.testing.assert_allclose(recs[gi]["broken_mean"], broken,
                                       rtol=1e-6)
            with np.load(path) as zr, np.load(os.path.join(
                    run["dir"], f"group_{gi}_faults.npz")) as zp:
                assert sorted(zr.files) == sorted(zp.files)
                for k in zr.files:
                    assert zp[k].tobytes() == zr[k].tobytes(), (gi, k)


def test_files_follow_the_reference_contract(clean, reference):
    port, ref = clean[4], reference
    assert port["code"] == ref["code"] == 0
    pj = read_jsonl(os.path.join(port["dir"], "journal.jsonl"))
    rj = read_jsonl(os.path.join(ref["dir"], "journal.jsonl"))
    assert [r["event"] for r in pj] == [r["event"] for r in rj] \
        == ["group", "group", "done"]
    for a, b in zip(pj, rj):
        assert sorted(a) == sorted(b)
        if a["event"] == "group":
            assert sorted(a["report"]["completed"]) \
                == sorted(b["report"]["completed"])
            for c, v in a["report"]["completed"].items():
                assert sorted(v) == sorted(b["report"]["completed"][c])
    reports = []
    for d in (port["dir"], ref["dir"]):
        with open(os.path.join(d, "sweep_report.json")) as f:
            reports.append(json.load(f))
    pr, rr = reports
    assert sorted(pr) == sorted(rr)
    assert {c: v["status"] for c, v in pr["configs"].items()} \
        == {c: v["status"] for c, v in rr["configs"].items()}
    assert sorted(port["rec"]) == sorted(
        set(ref["rec"]) - {"v4_8_projection_minutes"})
    assert port["rec"]["compute_dtype"] == "float32"
    assert (port["rec"]["processes"], port["rec"]["chips"]) == (1, 1)
    assert sorted(os.listdir(port["dir"])) == sorted(os.listdir(ref["dir"]))


def test_overlap_equals_no_overlap(inputs, clean, tmp_path):
    d = tmp_path / "serial"
    code, rec, _ = run_port(point(inputs["solver"], d, 4, "--no-overlap"))
    assert code == 0 and rec["overlapped_groups"] is False
    assert clean[4]["rec"]["overlapped_groups"] is True
    assert durable(str(d)) == durable(clean[4]["dir"])


@pytest.mark.parametrize("kill_at", [
    pytest.param(3, id="mid-group-1"),
    pytest.param(2, id="end-of-group-0")])
def test_preempt_and_resume_equal_the_uninterrupted_run(
        inputs, clean, tmp_path, monkeypatch, kill_at):
    real, calls = TSweep.step, []

    def step(self, *a, **kw):
        calls.append(self.iter)
        if len(calls) == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a, **kw)

    monkeypatch.setattr(TSweep, "step", step)
    d = tmp_path / "preempted"
    code, _, out = run_port(point(inputs["solver"], d))
    assert code == tdriver.PREEMPTED_EXIT, out
    journal = read_jsonl(os.path.join(d, "journal.jsonl"))
    pre = journal[-1]
    assert pre["event"] == "preempt" and pre["signal"] == "SIGTERM"
    assert pre["checkpoint"] == f"group_{pre['group']}.ckpt.npz"
    assert pre["iter"] == POLL * (2 - kill_at % 2)
    assert os.path.exists(os.path.join(d, pre["checkpoint"]))
    with open(os.path.join(d, "sweep_report.json")) as f:
        assert json.load(f)["status"] == "preempted"
    monkeypatch.setattr(TSweep, "step", real)
    code, rec, out = run_port(["--resume", str(d)])
    assert code == 0, out
    assert "restored in-flight checkpoint" in out
    assert rec["groups_resumed"] == pre["group"]
    assert not os.path.exists(os.path.join(d, pre["checkpoint"]))
    got = durable(str(d))
    want = durable(clean[4]["dir"])
    got["journal"] = json.dumps([r for r in json.loads(got["journal"])
                                 if r["event"] != "preempt"])
    assert got == want


def test_injected_nan_is_retried(inputs, clean, tmp_path):
    d = tmp_path / "inject"
    code, rec, out = run_port(point(inputs["solver"], d, 4,
                                    "--inject-nan", "1@2"))
    assert code == 0, out
    assert "Injected NaN into config 1" in out
    assert rec["retried_configs"] == [1] and rec["status"] == "clean"
    with open(os.path.join(d, "sweep_report.json")) as f:
        rep = json.load(f)
    assert rep["status"] == "clean" and rep["completed"] == 6
    assert rep["configs"]["1"]["attempts"] == 2
    retries = [r["event"] for r in read_jsonl(os.path.join(
        d, "metrics_g0.jsonl")) if r.get("type") == "retry"]
    assert retries[:2] == ["requeue", "reseed"]
    healthy_rows_equal(clean[4]["dir"], str(d), [0, 2, 3])


def test_injected_nan_always_fails_with_a_diagnosis(inputs, clean,
                                                    tmp_path):
    d = tmp_path / "always"
    code, rec, out = run_port(point(inputs["solver"], d, 4,
                                    "--inject-nan", "1@2:always"))
    assert code == tdriver.PARTIAL_EXIT, out
    assert rec["status"] == "partial" and rec["failed_configs"] == [1]
    with open(os.path.join(d, "sweep_report.json")) as f:
        rep = json.load(f)
    assert rep["status"] == "partial" and rep["exit_code"] == 65
    assert rep["failed"] == [1] and rep["completed"] == 5
    entry = rep["configs"]["1"]
    assert entry["status"] == "failed" and entry["diagnosis"]
    assert sorted(int(c) for c in rep["configs"]) == list(range(6))
    healthy_rows_equal(clean[4]["dir"], str(d), [0, 2, 3])


def healthy_rows_equal(clean_dir, run_dir, healthy):
    ga, gb = ([r for r in read_jsonl(os.path.join(d, "journal.jsonl"))
               if r["event"] == "group"] for d in (clean_dir, run_dir))
    for c in healthy:
        assert ga[0]["loss"][c] == gb[0]["loss"][c], c
    with np.load(os.path.join(clean_dir, "group_0_faults.npz")) as za, \
            np.load(os.path.join(run_dir, "group_0_faults.npz")) as zb:
        for k in za.files:
            for c in healthy:
                assert za[k][c].tobytes() == zb[k][c].tobytes(), (k, c)


def test_trace_writes_the_merged_timeline(inputs, tmp_path):
    d = tmp_path / "traced"
    code, _, _ = run_port(point(inputs["solver"], d, 4, "--trace"))
    assert code == 0
    with open(os.path.join(d, "trace", "merged.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dispatch", "group_build"} <= names
    assert any(r.get("type") == "span" for r in read_jsonl(
        os.path.join(d, "metrics_g0.jsonl")))


@pytest.mark.parametrize("flag", [
    ["--multihost"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"]],
    ids=["multihost", "coordinator", "num-processes", "process-id"])
def test_multiprocess_flags_raise_by_name(inputs, tmp_path, flag):
    with pytest.raises(NotImplementedError, match=flag[0] + ".*A14"):
        run_port(point(inputs["solver"], tmp_path / "r", 4, *flag))


def test_other_process_raises_by_name(inputs, tmp_path):
    """Refused by name before the fault-process registry was ported; now
    `--process read_disturb` runs: exit 0, the spec pinned in the
    manifest and the record, group 0's journal loss and fault npz those
    of the reference runner under the same stack."""
    d = tmp_path / "r"
    code, rec, _ = run_port(point(inputs["solver"], d, 4,
                                  "--process", "read_disturb"))
    assert code == 0 and rec["process"] == "read_disturb"
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["process"] == "read_disturb"
    recs = [r for r in read_jsonl(os.path.join(d, "journal.jsonl"))
            if r["event"] == "group"]
    path = tmp_path / "ref_0.npz"
    with jax.enable_x64(False):
        rep = ref_group(inputs["text"], 0, 4, path, process="read_disturb")
    np.testing.assert_allclose(
        recs[0]["loss"], [rep["completed"][c]["loss"] for c in range(4)],
        rtol=REL)
    with np.load(path) as zr, np.load(os.path.join(
            d, "group_0_faults.npz")) as zp:
        assert sorted(zr.files) == sorted(zp.files)
        for k in zr.files:
            assert zp[k].tobytes() == zr[k].tobytes(), k
    # cells broke under the read stress
    assert recs[0]["broken_mean"] > 0


def test_resume_refuses_another_process_pin(inputs, clean, capsys):
    code, _, _ = run_port(["--resume", clean[4]["dir"], "--process",
                           "read_disturb"])
    assert code == 2
    assert "manifest pin" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_cuda_device_raises_without_a_card(inputs, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        run_main(tdriver.main, point(inputs["solver"], tmp_path / "r"))
