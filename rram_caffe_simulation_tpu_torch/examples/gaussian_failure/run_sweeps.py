#!/usr/bin/env python
"""Grid sweeps over RRAM experiment knobs (the reference's
examples/gaussian_failure/run_sweeps.py, ported whole): one runner in
place of the fork's per-grid shell scripts (run_different_mean.sh,
run_different_mean_var.sh, run_different_prob.sh, run_threshold.sh,
run_different_th.sh: each spread configs over GPUs as processes).

- mean / std grids train every config at once on the sweep's config
  axis (through run_gaussian_exp --sweep-*).
- prob / threshold grids change the stuck-value draw or add a strategy
  a config, structure the config axis does not cover, so they run
  through `parallel.sweep.sequential_sweep` (one Solver a config, the
  fork's process a config without the process boundary) and print a
  table.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_sweeps \\
        mean 1e8 3e7 --values 5e7,1e8,2e8
    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_sweeps \\
        prob 1e8 3e7 --values 2,5,10 --max-iter 2000
    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_sweeps \\
        threshold 1e8 3e7 --values 0.01,0.05,0.1

The prob / threshold grids run from the checkout's root, as the
reference's do (the template's relative paths resolve there). Where the
port differs, loudly: `--cpu` trains on the CPU (default the card,
raising without one).
"""
import argparse
import os

from .run_gaussian_exp import ROOT
from .run_gaussian_exp import main as run


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["mean", "std", "prob", "threshold"])
    p.add_argument("mean", type=float)
    p.add_argument("std", type=float)
    p.add_argument("--values", required=True,
                   help="comma-separated grid values")
    p.add_argument("--max-iter", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="run the test net after each sequential config")
    p.add_argument("--template",
                   default=os.path.join(
                       ROOT, "models/cifar10_vgg11/"
                       "cifar10_vgg11_template.prototxt"))
    p.add_argument("--tag", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    values = [float(v) for v in args.values.split(",")]

    if args.kind in ("mean", "std"):
        run_args = [str(args.mean), str(args.std), "0", "-y",
                    "--template", args.template,
                    "--tag", args.tag or f"_{args.kind}sweep"]
        if args.kind == "mean":
            run_args += ["--sweep-means",
                         ",".join(str(v) for v in values)]
        else:
            run_args += ["--sweep-means",
                         ",".join(str(args.mean) for _ in values),
                         "--sweep-stds", ",".join(str(v) for v in values)]
        if args.max_iter:
            run_args += ["--max-iter", str(args.max_iter)]
        if args.cpu:
            run_args.append("--cpu")
        return run(run_args)

    # prob / threshold: per-config structure -> sequential driver
    from ...device import resolve_device
    from ...parallel.sweep import sequential_sweep
    from ...utils.io import read_solver_param

    device = resolve_device("cpu" if args.cpu else None)
    sp = read_solver_param(args.template)
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean = args.mean
    sp.failure_pattern.std = args.std
    sp.snapshot = 0
    sp.display = 0
    sp.ClearField("test_interval")
    if args.max_iter:
        sp.max_iter = args.max_iter
    iters = sp.max_iter
    key = args.kind
    configs = [{key: (int(v) if key == "prob" else v)} for v in values]
    os.chdir(ROOT)
    results = sequential_sweep(sp, configs, iters,
                               eval_iters=1 if args.eval else 0,
                               device=device)
    print(f"{key:>10s}  {'loss':>10s}  {'broken':>8s}  scores")
    for rec in results:
        scores = " ".join(f"{k}={v:.4f}"
                          for k, v in rec.get("scores", {}).items())
        print(f"{rec['config'][key]:>10}  {rec['loss']:>10.4f}  "
              f"{rec.get('broken', 0.0):>8.4f}  {scores}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
