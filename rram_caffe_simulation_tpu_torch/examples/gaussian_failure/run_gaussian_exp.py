#!/usr/bin/env python
"""RRAM fault experiment runner (the reference's
examples/gaussian_failure/run_gaussian_exp.py, ported whole): the fork's
CLI (positional mean, std and device id; -t/-r/-g/--prob/--tag), its
patching of the VGG11-BN solver template for one failure pattern and one
set of strategies, its `snapshot_<mean>_<std><suffix><tag>/` directory
with the tee'd `log`, the patched solver written to
`solvers/solver_<mean>_<std><suffix><tag>.prototxt` beside this file,
and `--sweep-means` (with `--sweep-stds`), which trains every config at
once on the sweep's config axis and prints one line a config each
display interval.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_gaussian_exp \\
        1e8 3e7 0 [-t 0.01] [-r order.txt,100,0] [-g net,model,100] \\
        [--prob 10] [--hw-sigma 0.05] [--max-iter N] [-y] [--cpu]
    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.run_gaussian_exp \\
        1e8 3e7 0 -y --sweep-means 5e7,1e8,2e8 [--sweep-stds ...]

The template's `net:` and its Data sources are read from the working
directory, as the reference reads them: run from the checkout's root, or
pass `--template` a solver with absolute paths.

Where the port differs from the reference's runner, each loudly:
`--cpu` trains on the CPU (`device="cpu"`); without it the runner trains
on the card and raises without one, before it writes anything.
`--compute-dtype` takes "" or float32 only, and raises for any other
dtype (a sub-f32 compute dtype is ROADMAP §A 5; the reference's default
"" trains in float32 too). `device_id` is recorded in the message as the
reference records it; the port trains on the current CUDA device. The
template's `snapshot_format: HDF5` needs `h5py`: where it cannot be
imported the Solver refuses by name before training.
"""
import argparse
import contextlib
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

#: the compute dtypes the port trains in
COMPUTE_DTYPES = ("", "float32")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mean", type=float)
    p.add_argument("std", type=float)
    p.add_argument("device_id", type=int,
                   help="kept for CLI parity and recorded in the solver; "
                        "the port trains on the current CUDA device")
    p.add_argument("-t", "--threshold", default=-1, type=float)
    p.add_argument("-r", "--remapping", default="",
                   help="<prune_order_file>[,<period>[,<start>]]")
    p.add_argument("-g", "--genetic", default="",
                   help="<prune_prototxt>,<prune_model>[,<switch_time>"
                        "[,<period>[,<start>]]]")
    p.add_argument("--tag", default="", help="suffix tag")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the card; raises "
                        "without one)")
    p.add_argument("--prob", type=int, default=-1,
                   help="probability percentage for +-1 (0~100)")
    p.add_argument("-y", "--yes", action="store_true")
    p.add_argument("--template",
                   default=os.path.join(
                       ROOT, "models/cifar10_vgg11/"
                       "cifar10_vgg11_template.prototxt"))
    p.add_argument("--max-iter", type=int, default=0,
                   help="override template max_iter (testing)")
    p.add_argument("--sweep-means", default="",
                   help="comma list of lifetime means: train ALL configs "
                        "simultaneously on the sweep's config axis")
    p.add_argument("--sweep-stds", default="")
    p.add_argument("--hw-sigma", type=float, default=0.0,
                   help="hardware-aware forward: relative conductance "
                        "noise on fault-target weights each read "
                        "(framework extension, RRAMForwardParameter)")
    p.add_argument("--conv-also", action="store_true",
                   help="fault Convolution params too (framework "
                        "extension; the reference faults only "
                        "InnerProduct, net.cpp:485-493)")
    p.add_argument("--compute-dtype", default="",
                   help="forward/backward dtype: '' or float32 (a sub-f32 "
                        "dtype is not ported and raises)")
    return p.parse_args(argv)


def build_solver_param(args):
    """Patch the template exactly like the reference runner
    (run_gaussian_exp.py:45-103): a SolverParameter message."""
    from ...proto import Message
    from ...utils.io import read_solver_param

    message = read_solver_param(args.template)
    message.failure_pattern.type = "gaussian"
    message.failure_pattern.mean = args.mean
    message.failure_pattern.std = args.std
    message.device_id = args.device_id
    if args.max_iter:
        message.max_iter = args.max_iter
    if args.hw_sigma:
        message.rram_forward.sigma = args.hw_sigma
    if args.conv_also:
        message.failure_pattern.conv_also = True

    def strategy(**fields):
        sp = Message("FailureStrategyParameter")
        for name, value in fields.items():
            setattr(sp, name, value)
        message.failure_strategy.append(sp)
        return sp

    if args.threshold > 0:
        strategy(type="threshold", threshold=args.threshold)
    if args.remapping:
        stra = args.remapping.split(",")
        sp = strategy(type="remapping", prune_order_file=stra[0])
        if len(stra) > 1:
            sp.period = int(stra[1])
        if len(stra) > 2:
            sp.start = int(stra[2])
    if args.genetic:
        stra = args.genetic.split(",")
        sp = strategy(type="genetic", prune_net_file=stra[0],
                      prune_model_file=stra[1])
        if len(stra) > 2:
            sp.switch_time = int(stra[2])
        if len(stra) > 3:
            sp.period = int(stra[3])
        if len(stra) > 4:
            sp.start = int(stra[4])
    if args.prob >= 0:
        assert args.prob < 50
        fp = message.failure_pattern.failure_prob
        fp.neg = fp.pos = args.prob
        fp.zero = 100 - 2 * args.prob
    return message


class Tee:
    def __init__(self, path):
        self.f = open(path, "w")

    def write(self, s):
        sys.__stdout__.write(s)
        self.f.write(s)

    def flush(self):
        sys.__stdout__.flush()
        self.f.flush()


def main(argv=None):
    args = parse_args(argv)
    if args.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"--compute-dtype {args.compute_dtype}: the port trains in "
            "float32 only (a sub-f32 compute dtype is ROADMAP §A 5); pass "
            "'' or float32")
    from ...device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)

    strategy_suffix = ""
    if args.threshold > 0:
        strategy_suffix += f"_threshold_{args.threshold}"
    if args.remapping:
        strategy_suffix += ("_remapping_" + os.path.basename(
            args.remapping.split(",")[0]))
    if args.genetic:
        # the fork embedded the raw -g string (its files were local
        # names); basename the paths so the snapshot dir stays valid
        strategy_suffix += "_genetic_" + ",".join(
            os.path.basename(p) for p in args.genetic.split(","))
    message = build_solver_param(args)

    snapshot_prefix = (f"snapshot_{args.mean}_{args.std}"
                       f"{strategy_suffix}{args.tag}")
    if os.path.exists(snapshot_prefix):
        if not args.yes:
            yes = input(f"{snapshot_prefix} already exists, remove? (y/n): ")
            if yes.lower() not in {"y", "yes"}:
                sys.exit()
        shutil.rmtree(snapshot_prefix)
    os.makedirs(snapshot_prefix)
    message.snapshot_prefix = snapshot_prefix + "/"

    from ...proto import to_text
    solver_dir = os.path.join(HERE, "solvers")
    os.makedirs(solver_dir, exist_ok=True)
    solver_fname = os.path.join(
        solver_dir,
        f"solver_{args.mean}_{args.std}{strategy_suffix}{args.tag}"
        ".prototxt")
    with open(solver_fname, "w") as f:
        f.write(to_text(message))
    print(f"New solver prototxt write to {solver_fname}.")

    from ...solver import Solver

    tee = Tee(os.path.join(snapshot_prefix, "log"))
    try:
        with contextlib.redirect_stdout(tee):
            # log the solver config so plot_pic-style scrapers find
            # test_interval (plot_pic.py:16)
            print(to_text(message))
            if args.sweep_means:
                from ...parallel import SweepRunner
                means = [float(x) for x in args.sweep_means.split(",")]
                stds = ([float(x) for x in args.sweep_stds.split(",")]
                        if args.sweep_stds else None)
                solver = Solver(message, device=device)
                runner = SweepRunner(solver, n_configs=len(means),
                                     means=np.asarray(means, np.float32),
                                     stds=(np.asarray(stds, np.float32)
                                           if stds else None),
                                     device=device)
                interval = message.display or 100
                for start in range(0, message.max_iter, interval):
                    loss, _ = runner.step(min(interval,
                                              message.max_iter - start))
                    fracs = runner.broken_fractions()
                    for ci, m in enumerate(means):
                        print(f"config {ci} (mean={m:g}): Iteration "
                              f"{runner.iter}, loss = {loss[ci]:.5g}, "
                              f"broken = {fracs[ci]:.4f}")
            else:
                solver = Solver(message, device=device)
                solver.solve()
    finally:
        tee.f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
