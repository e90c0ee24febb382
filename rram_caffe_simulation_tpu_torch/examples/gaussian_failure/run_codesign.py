"""Hardware co-design explorer (the reference's
examples/gaussian_failure/run_codesign.py, ported whole): sweep the
fault-process mix x sigma x adc_bits x tile mapping x lifetime
distribution x mitigation strategy jointly and report the Pareto front.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_codesign \\
        --processes endurance_stuck_at,read_disturb \\
        --adc-bits 2,4 --sigmas 0.0 --iters 300 --out codesign0

The joint grid is bucketed by its static axes
(`fault.codesign.group_static`): one `SweepRunner` per bucket, the
bucket's (mean, std) entries riding its lanes.

Outputs (under --out):

- `results.jsonl`: one record per config, every axis value plus `loss`
  (the config's final loss), `broken` (its final broken-cell fraction),
  `adc_cost_bits` (adc_bits, 0 = full precision counted as 32: the
  hardware-cost proxy a cheaper ADC improves) and `wall_seconds` of its
  bucket.
- `pareto_report.json`: the non-dominated front over (--metric-x,
  --metric-y), default (loss, adc_cost_bits).

Exit code 0: the report written with a non-degenerate front; 65: the
front collapsed to one point (the axes exposed no tradeoff: widen
them); 2: a usage error. `main(argv)` returns the report on exit 0.

Where the port differs from the reference's driver: `--device` (default
cuda, which raises without a card; cpu by name) and `--engine` (the
port's engines: auto, cuda, torch; the reference's runner defaults to
its "jax" engine); each bucket's line names the engine that ran. Both
compute in float32. Relative paths (the solver, its net and Data
sources) resolve from the working directory when they exist there,
else from the checkout's root; `--out` from the working directory.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

DEGENERATE_EXIT = 65


def _floats(text):
    return [float(x) for x in str(text).split(",") if x.strip()]


def _ints(text):
    return [int(x) for x in str(text).split(",") if x.strip()]


def _strs(text):
    return [x.strip() for x in str(text).split(",") if x.strip()]


def main(argv=None):
    from ...parallel.sweep import SWEEP_ENGINES
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--solver", default=(
        "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt"),
        help="solver prototxt each bucket's Solver is built from "
             "(failure pattern / rram_forward / strategy / seed are "
             "overridden per bucket here)")
    p.add_argument("--processes", default="endurance_stuck_at",
                   help="comma-separated fault-process specs "
                        "(fault/processes/ syntax; ':' params and '+' "
                        "stacks allowed — commas inside a spec are "
                        "not, use one-param processes or defaults)")
    p.add_argument("--sigmas", default="0.0",
                   help="comma-separated crossbar read-noise sigmas")
    p.add_argument("--adc-bits", default="0,4",
                   help="comma-separated ADC resolutions (0 = full "
                        "precision; 1 is invalid — symmetric quantizer"
                        ")")
    p.add_argument("--strategies", default="none",
                   help="comma-separated mitigation strategies: none "
                        "or threshold:T (e.g. threshold:0.001)")
    p.add_argument("--tiles", default="1x1",
                   help="comma-separated tiled-crossbar-mapping specs "
                        "(fault/mapping.py TileSpec syntax: '1x1' = "
                        "untiled, 'GRxGC' grids, 'cells=RxC' physical "
                        "arrays), swept jointly with the rest")
    p.add_argument("--means", default="400,800",
                   help="comma-separated lifetime means (the per-lane "
                        "Monte-Carlo axis)")
    p.add_argument("--stds", default="100",
                   help="comma-separated lifetime stds (crossed with "
                        "--means)")
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--chunk", type=int, default=25)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--metric-x", default="loss",
                   help="quality metric (minimized unless "
                        "--maximize-x)")
    p.add_argument("--metric-y", default="adc_cost_bits",
                   help="hardware-cost metric (minimized unless "
                        "--maximize-y)")
    p.add_argument("--maximize-x", action="store_true")
    p.add_argument("--maximize-y", action="store_true")
    p.add_argument("--out", required=True,
                   help="output directory (results.jsonl + "
                        "pareto_report.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises "
                        "without a card; cpu by name)")
    p.add_argument("--engine", default="auto", choices=SWEEP_ENGINES,
                   help="crossbar engine: cuda (the kernels), torch (their "
                        "plain versions), auto (cuda on the card)")
    args = p.parse_args(argv)

    from ...device import resolve_device
    from ...fault import codesign
    from ...fault.mapping import TileSpec
    from ...fault.processes import FaultSpec
    from ...parallel import SweepRunner
    from ...proto import Message
    from ...solver import Solver
    from .run_1000_sweep import _solver_param

    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)

    axes = {
        "process": [FaultSpec.parse(s).canonical()
                    for s in _strs(args.processes)],
        "sigma": _floats(args.sigmas),
        "adc_bits": _ints(args.adc_bits),
        "strategy": _strs(args.strategies),
        # canonical up front, so the records and the report carry the
        # canonical tile spec and equal spellings share a bucket
        "tiles": [TileSpec.parse(s).canonical()
                  for s in _strs(args.tiles)],
        "mean": _floats(args.means),
        "std": _floats(args.stds),
    }
    if any(b == 1 for b in axes["adc_bits"]):
        p.error("--adc-bits 1 is invalid (a symmetric quantizer with "
                "2^(bits-1)-1 == 0 levels); use 0 or >= 2")
    grid = codesign.expand_grid(axes)
    groups = codesign.group_static(grid)
    print(f"Co-design grid: {len(grid)} configs in {len(groups)} "
          f"buckets "
          f"({' x '.join(f'{k}={len(v)}' for k, v in axes.items())})",
          flush=True)

    def build_solver(process, sigma, adc_bits, strategy, tiles):
        param = _solver_param(args.solver)
        param.failure_pattern.type = "gaussian"
        param.random_seed = args.seed
        param.display = 0
        param.ClearField("test_interval")
        if sigma or adc_bits:
            param.rram_forward.sigma = float(sigma)
            param.rram_forward.adc_bits = int(adc_bits)
        if strategy != "none":
            kind, _, val = strategy.partition(":")
            if kind != "threshold":
                p.error(f"unknown strategy {strategy!r} (none or "
                        "threshold:T)")
            sp = Message("FailureStrategyParameter")
            sp.type = "threshold"
            sp.threshold = float(val or 0.0)
            param.failure_strategy.append(sp)
        return Solver(param, device=device, fault_process=process,
                      tile_spec=tiles)

    results = []
    results_path = os.path.join(out_dir, "results.jsonl")
    with open(results_path, "w") as rf:
        for key, cfgs in sorted(groups.items()):
            process, sigma, adc_bits, strategy, tiles = key
            means = [c["mean"] for c in cfgs]
            stds = [c["std"] for c in cfgs]
            t0 = time.perf_counter()
            solver = build_solver(process, sigma, adc_bits, strategy,
                                  tiles)
            with SweepRunner(solver, n_configs=len(cfgs), means=means,
                             stds=stds, pipeline_depth=0,
                             engine=args.engine, device=device) as runner:
                losses, _ = runner.step(args.iters, chunk=args.chunk)
                broken = runner.broken_fractions()
                ran = runner.engine_resolved or "no crossbar read"
            dt = time.perf_counter() - t0
            losses = np.ravel(np.asarray(losses, np.float64))
            for i, cfg in enumerate(cfgs):
                rec = dict(cfg)
                rec["loss"] = float(losses[i])
                rec["broken"] = float(broken[i])
                # hardware-cost proxy: a full-precision read (adc_bits 0)
                # costs a 32-bit converter, not a free one
                rec["adc_cost_bits"] = int(adc_bits) if adc_bits else 32
                rec["wall_seconds"] = round(dt, 3)
                results.append(rec)
                rf.write(json.dumps(rec) + "\n")
            print(f"  bucket process={process} sigma={sigma:g} "
                  f"adc_bits={adc_bits} strategy={strategy} "
                  f"tiles={tiles}: "
                  f"{len(cfgs)} lanes x {args.iters} iters in "
                  f"{dt:.1f} s on {device} (engine: {ran}; mean loss "
                  f"{float(np.nanmean(losses)):.4f})", flush=True)

    report = codesign.make_report(
        results, args.metric_x, args.metric_y,
        maximize_x=args.maximize_x, maximize_y=args.maximize_y,
        axes=axes)
    report_path = os.path.join(out_dir, "pareto_report.json")
    tmp = f"{report_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, report_path)
    print(f"Pareto front ({args.metric_x} vs {args.metric_y}): "
          f"{report['front_size']} of {report['evaluated']} configs "
          f"non-dominated ({report['dominated']} dominated); report "
          f"at {report_path}", flush=True)
    for rec in report["front"]:
        print("  front: "
              + ", ".join(f"{k}={rec[k]}" for k in
                          ("process", "sigma", "adc_bits", "strategy",
                           "tiles", "mean", "std"))
              + f" -> {args.metric_x}={rec.get(args.metric_x)}, "
                f"{args.metric_y}={rec.get(args.metric_y)}",
              flush=True)
    if report["degenerate"]:
        culprits = report.get("collapsed_axes") or []
        named = (f" collapsed axis(es): {', '.join(culprits)} — widen "
                 "those" if culprits else
                 " — widen --adc-bits / --processes / --sigmas / "
                 "--tiles")
        print("Front is DEGENERATE (a single point): the axes exposed "
              f"no tradeoff;{named}", flush=True)
        sys.exit(DEGENERATE_EXIT)
    return report


if __name__ == "__main__":
    main()
