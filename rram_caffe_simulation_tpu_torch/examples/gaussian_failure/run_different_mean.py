#!/usr/bin/env python
"""Mean-lifetime grid sweep (the reference's
examples/gaussian_failure/run_different_mean.py, ported whole), which
replaces the fork's run_different_mean.sh (one process a config, spread
over GPUs): one invocation trains every config at once on the sweep's
config axis, through `run_gaussian_exp --sweep-means`.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_different_mean \\
        1e8 2e8 4e8 [--std 3e7] [--max-iter N] [--cpu]

Where the port differs, each loudly: `--cpu` trains on the CPU (default
the card, raising without one); `--compute-dtype` takes "" or float32
only, as run_gaussian_exp's does.
"""
import argparse
import sys

from .run_gaussian_exp import main as run


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("means", nargs="+", type=float)
    p.add_argument("--std", type=float, default=3e7)
    p.add_argument("--max-iter", type=int, default=0)
    p.add_argument("--tag", default="")
    p.add_argument("--compute-dtype", default="",
                   help="'' or float32 (a sub-f32 dtype raises)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    run_args = [str(args.means[0]), str(args.std), "0", "-y",
                "--tag", args.tag or "_meansweep",
                "--sweep-means", ",".join(str(m) for m in args.means)]
    if args.max_iter:
        run_args += ["--max-iter", str(args.max_iter)]
    if args.compute_dtype:
        run_args += ["--compute-dtype", args.compute_dtype]
    if args.cpu:
        run_args.append("--cpu")
    return run(run_args)


if __name__ == "__main__":
    sys.exit(main())
