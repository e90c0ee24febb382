#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --steps 10 # a shorter slice phase

Phases (each raises on failure; the script then exits non-zero and
prints no "ok" line):

1. the card's name and power limit; build both kernels from csrc/ with
   nvcc (one process per source, started together), timed;
2. kernel B1 (fused ApplyUpdate+Fail) against its plain version,
   bit for bit (`torch.equal` on the int32 view of data', and life_q'),
   at the ip1/ip2 weight and bias shapes, every mode, int16 and int32
   banks, C = 1 and C = 4, counters within a few writes of zero;
3. kernel B2 (crossbar GEMM) against its plain version at the ip1/ip2
   shapes, C = 1 and C = 4 (x shared and per lane), q_bits 0/2/8,
   sigma 0 and host noise, within the f32 summation-order bound
   K * 2^-24 * (|x| @ |w_eff|) (no TF32 anywhere); then the in-kernel
   Philox draw: moments, reproducibility, independence across seeds
   and lanes, and agreement with its tensor-op twin;
4. the slice: CIFAR-10-quick from its solver prototxt, lifetimes
   N(1e8, 3e7), ternary crossbar read, packed banks, fused epilogue,
   batch 100 from the in-repo LMDB, on the "cuda" engine; losses, the
   step time (median and quartiles), a breakdown into host feed and
   device busy time, and each kernel's launch count against the path's
   (B2 twice a step, B1 once per fault leaf: four a step); then a short
   run with rram_forward.sigma = 0.05 (in-kernel noise on the path);
5. fault transitions: mean 300, std 50, the "cuda" and the "torch"
   engine from one seed, both on the card: in lockstep (same state and
   batch each step) losses within 1e-5 relative and life_q identical;
   an independent "torch" run's life_q identical at every step too;
   cells broken, every broken cell at its stuck value.

Then a JSON line of the step's numbers, one JSON line of per-kernel
numbers (per training step, summed over the step's launches), the
card's name and power limit, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "rram_caffe_simulation_tpu_torch"
SOLVER = "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores
U32 = 2.0 ** -24                 # f32 unit roundoff


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


class Check(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise Check(msg)


# ---------------------------------------------------------------------------
# timing

def event_ms(fn, iters=100, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_ms(fn, iters=50):
    """Kernel time on the card per call (CUPTI through torch.profiler);
    None if the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def timed(fn):
    """(device ms, host-inclusive ms): the first, when the profiler
    works, is the kernel's own time; the second is the stream time per
    call with the Python launch path in it."""
    ev = event_ms(fn)
    dev = device_ms(fn)
    return (dev if dev is not None else ev), ev


# ---------------------------------------------------------------------------
# phase 2: B1

SLICE_LEAVES = {"ip1/0": (64, 1024), "ip1/1": (64,), "ip2/0": (10, 64),
                "ip2/1": (10,)}


def b1_inputs(shape, life_dtype, C, seed, device):
    import torch
    from rram_caffe_simulation_tpu_torch.fault import packed
    rng = np.random.RandomState(seed)
    full = ((C,) if C > 1 else ()) + tuple(shape)
    data = rng.randn(*full).astype(np.float32)
    upd = (rng.randn(*full) * 1e-3).astype(np.float32)
    sel = rng.rand(*full)
    upd[sel < 0.2] = 0.0
    upd[(sel >= 0.2) & (sel < 0.25)] = 1e-20
    upd[(sel >= 0.25) & (sel < 0.3)] = -9.99e-21
    lq = rng.randint(-3, 4, size=full).astype(life_dtype)
    bank = packed.pack_stuck(rng.choice([-1.0, 0.0, 1.0], size=full))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(data), t(upd), t(lq), t(bank)


def phase_b1(device):
    import torch
    from rram_caffe_simulation_tpu_torch.fault import fused
    n = 0
    for shape in SLICE_LEAVES.values():
        for life_dtype in ("int16", "int32"):
            for C in (1, 4):
                args = b1_inputs(shape, life_dtype, C, n, device)
                for mode in fused.FUSED_MODES:
                    kd, kq = fused.fused_update_fail(*args, mode=mode)
                    pd, pq = fused.fused_update_fail_plain(*args, mode=mode)
                    torch.cuda.synchronize()
                    check(torch.equal(kd.view(torch.int32),
                                      pd.view(torch.int32))
                          and torch.equal(kq, pq),
                          f"B1 differs from its plain version: shape "
                          f"{shape} {life_dtype} C={C} mode={mode}")
                    n += 1
    print(f"phase 2: B1 bit-identical to its plain version in {n} cases",
          flush=True)
    return 0.0


def b1_step_numbers(device, life_dtype="int32"):
    """Per-step B1 numbers at the slice's four leaves."""
    from rram_caffe_simulation_tpu_torch.fault import fused
    ms = plain = bound = 0.0
    lb = 4 if life_dtype == "int32" else 2
    for i, shape in enumerate(SLICE_LEAVES.values()):
        args = b1_inputs(shape, life_dtype, 1, 100 + i, device)
        k, k_call = timed(lambda: fused.fused_update_fail(*args))
        p, _ = timed(lambda: fused.fused_update_fail_plain(*args))
        cells = math.prod(shape)
        bank = args[3].numel()
        nbytes = cells * (4 + 4 + lb) + bank + cells * (4 + lb)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  B1 {tuple(shape)} {life_dtype}: kernel {k:.5f} ms "
              f"({k_call:.5f} ms per wrapper call), plain {p:.5f} ms, "
              f"bound {b:.6f} ms (bytes {nbytes})", flush=True)
        ms, plain, bound = ms + k, plain + p, bound + b
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: B2

B2_SHAPES = {"ip1": (100, 1024, 64), "ip2": (100, 64, 10)}


def b2_inputs(M, K, N, C, x_batched, seed, device):
    import torch
    rng = np.random.RandomState(seed)
    xs = (C, M, K) if x_batched else (M, K)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(C, K, N) * 0.1).astype(np.float32)
    broken = (rng.rand(C, K, N) < 0.1).astype(np.float32)
    stuck = rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32)
    eps = rng.randn(C, K, N).astype(np.float32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=C).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(x), t(w), t(broken), t(stuck), t(seeds), t(eps)


def b2_bound(x, w):
    """|y| error bound of an f32 dot of length K summed in any order."""
    import torch
    K = w.shape[1]
    return K * U32 * torch.matmul(x.abs(), w.abs()) + 1e-30


def phase_b2(device):
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    worst = 0.0
    n = 0
    for (M, K, N) in B2_SHAPES.values():
        for C, xb in ((1, False), (4, False), (4, True)):
            x, w, br, st, seeds, eps = b2_inputs(M, K, N, C, xb, n, device)
            for q_bits in (0, 2, 8):
                for sigma, e in ((0.0, None), (0.05, eps)):
                    yk = hw.crossbar_forward(x, w, br, st, seeds, sigma,
                                             q_bits, eps=e)
                    yp = hw.crossbar_forward_plain(x, w, br, st, seeds,
                                                   sigma, q_bits, eps=e)
                    w_eff = hw.effective_weight_plain(
                        w, br, st, sigma, e, hw.q_levels(q_bits),
                        w.abs().amax(dim=(1, 2)))
                    err = (yk - yp).abs()
                    ok = bool((err <= b2_bound(x, w_eff)).all())
                    worst = max(worst, float(err.max()))
                    check(ok, f"B2 out of bound: M,K,N={M},{K},{N} C={C} "
                              f"x_batched={xb} q_bits={q_bits} "
                              f"sigma={sigma}: max err {float(err.max())}")
                    n += 1
    print(f"phase 3: B2 within the f32 summation bound in {n} cases, "
          f"max abs err {worst:.3e}", flush=True)
    phase_noise(device)
    return worst


def phase_noise(device):
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    K = N = 256
    C, sigma = 4, 0.05
    x = torch.eye(K, device=device)
    w = torch.ones((C, K, N), device=device)
    zero = torch.zeros_like(w)
    seeds = torch.tensor([11, 12, 977, 2 ** 31 - 2], dtype=torch.int32,
                         device=device)

    def draw(s):
        y = hw.crossbar_forward(x, w, zero, zero, s, sigma, 0)
        return (y - 1.0) / sigma

    e1, e2 = draw(seeds), draw(seeds)
    check(torch.equal(e1, e2), "in-kernel noise not reproducible from seed")
    flat = e1.reshape(C, -1).double()
    mean, std = flat.mean(dim=1), flat.std(dim=1)
    check(bool((mean.abs() < 0.02).all()) and
          bool(((std - 1).abs() < 0.02).all()),
          f"noise moments off: mean {mean.tolist()} std {std.tolist()}")
    r = torch.corrcoef(flat)
    off = (r - torch.eye(C, device=device, dtype=r.dtype)).abs().max()
    check(float(off) < 0.02, f"lanes correlated: max |r| {float(off)}")
    twin = hw.philox_normal(seeds, K, N, device)
    check(float((e1 - twin).abs().max()) < 1e-3,
          "in-kernel noise disagrees with its tensor-op twin")
    print(f"phase 3: in-kernel noise over {K * N} cells/lane: mean "
          f"{[round(v, 4) for v in mean.tolist()]}, std "
          f"{[round(v, 4) for v in std.tolist()]}, max |r| between "
          f"lanes/seeds {float(off):.4f}, max |eps - twin| "
          f"{float((e1 - twin).abs().max()):.2e}", flush=True)


def b2_step_numbers(device):
    """Per-step B2 numbers at the slice's two InnerProduct reads
    (ternary grid, sigma 0, as on the path)."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    ms = plain = bound = lib = 0.0
    bound_by = "bytes"
    for i, (M, K, N) in enumerate(B2_SHAPES.values()):
        x, w, br, st, seeds, _ = b2_inputs(M, K, N, 1, False, 200 + i,
                                           device)
        w_eff = hw.effective_weight_plain(w, br, st, 0.0, None, 1.0,
                                          w.abs().amax(dim=(1, 2)))[0]
        k, k_call = timed(lambda: hw.crossbar_forward(x, w, br, st, seeds,
                                                      0.0, 2))
        p, _ = timed(lambda: hw.crossbar_forward_plain(x, w, br, st, seeds,
                                                       0.0, 2))
        lb, _ = timed(lambda: torch.matmul(x, w_eff))
        nbytes = 4 * (M * K + 3 * K * N + M * N)
        flops = 2 * M * K * N
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        print(f"  B2 M,K,N={M},{K},{N}: kernel {k:.5f} ms ({k_call:.5f} ms "
              f"per wrapper call), plain {p:.5f} ms, "
              f"torch.matmul {lb:.5f} ms, bound {max(tb, tf):.6f} ms "
              f"(bytes {nbytes}: {tb:.6f}; flop {flops}: {tf:.6f})",
              flush=True)
        if tf > tb and i == 0:
            bound_by = "operations"
        ms, plain, bound, lib = ms + k, plain + p, bound + max(tb, tf), \
            lib + lb
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib}


# ---------------------------------------------------------------------------
# phases 4 and 5: the solver

def slice_solver(mean, std, sigma=0.0, hw_engine="cuda", seed=1):
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    sp = read_solver_param(SOLVER)
    sp.display = 0
    sp.random_seed = seed
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean = mean
    sp.failure_pattern.std = std
    if sigma:
        sp.rram_forward.sigma = sigma
    return Solver(sp, device="cuda", hw_engine=hw_engine,
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True)


def phase_slice(steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    s = slice_solver(1e8, 3e7)
    check(s.pack_spec["life_dtype"] == "int32", "1e8 banks must be int32")
    warm = min(2, steps - 1)
    kernels.reset_launches()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.step(1)               # ends in a host read of the loss: synced
        times.append(time.perf_counter() - t0)
        losses.append(s.last_loss)
    b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
    losses = [float(v) for v in losses]
    q1, dt, q3 = (float(v) for v in np.percentile(times[warm:],
                                                  [25, 50, 75]))
    print(f"phase 4: CIFAR-10-quick batch 100, ternary, packed int32 banks, "
          f"fused epilogue, cuda engine: {steps} steps, losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"phase 4: step time median {dt * 1e3:.3f} ms (quartiles "
          f"{q1 * 1e3:.3f} / {q3 * 1e3:.3f} ms, n = {steps - warm} after "
          f"{warm} warm-up steps; {gpu}); launches B2 {b2}, B1 {b1}",
          flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(abs(losses[0] - math.log(10)) < 0.05,
          f"first loss {losses[0]} far from ln(10) at a near-zero init")
    check(b2 == 2 * steps, f"B2 launched {b2} times, expected {2 * steps}")
    check(b1 == 4 * steps, f"B1 launched {b1} times, expected {4 * steps}")
    launches = {"B2": b2, "B1": b1}
    breakdown = step_breakdown(s)
    print(f"phase 4: where a step's {dt * 1e3:.3f} ms go: host feed (LMDB "
          f"read + Datum decode + mean, numpy) {breakdown['feed_ms']:.3f} "
          f"ms; kernels on the card {breakdown['device_busy_ms']:.3f} ms "
          f"({breakdown['device_busy_ms'] / (dt * 1e3):.1%} busy); top "
          f"device kernels: {breakdown['top']}", flush=True)

    s2 = slice_solver(1e8, 3e7, sigma=0.05, seed=2)
    kernels.reset_launches()
    s2.step(3)
    torch.cuda.synchronize()
    check(hw_aware.CROSSBAR_LIB.launches == 6 and
          fused.FUSED_LIB.launches == 12 and
          math.isfinite(s2.smoothed_loss),
          "sigma = 0.05 run did not go through the kernels")
    print(f"phase 4: sigma 0.05 run, 3 steps, loss {s2.smoothed_loss:.5f}, "
          "launches B2 6, B1 12", flush=True)
    return launches, dt, breakdown


def step_breakdown(s, steps=5):
    """Host feed time per batch, and the device's kernel time per step
    (torch.profiler/CUPTI) with the five largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(10):
        s.train_feed()
    feed_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.step(steps)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"feed_ms": feed_ms, "device_busy_ms": sum(by_name.values()),
            "top": "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top)}


def phase_transitions(steps):
    """Kernel path against plain path through the fault transitions.

    Lockstep: every step, the "cuda" and the "torch" step run from the
    same state on the same batch; their losses must agree within 1e-5
    relative (only B2's summation order differs within one step) and
    their life_q banks exactly. Independent: a second solver trains on
    the "torch" engine alone from the same seed; its banks must equal
    the kernel path's at every step. Its losses are only reported: the
    run is not bit-reproducible on the card (CUDA's max-pool backward
    adds overlapping windows' gradients with atomics), and once cells
    stick at +-1 the training dynamics amplify that last-bit noise."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware, packed
    a = slice_solver(300.0, 50.0, hw_engine="cuda", seed=5)
    b = slice_solver(300.0, 50.0, hw_engine="torch", seed=5)
    check(a.pack_spec["life_dtype"] == "int16", "mean 300 banks are int16")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=a.pack_spec, fused_epilogue=True)
    kstep = a.make_train_step(hw_engine="cuda", **opts)
    pstep = a.make_train_step(hw_engine="torch", **opts)
    state = (a.params, a.history, a.fault_state)
    worst_lock = worst_indep = 0.0
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(a.device)
                 for k, v in a.train_feed().items()}
        gen = torch.Generator()
        gen.set_state(a.gen.get_state())
        kernels.reset_launches()
        _, _, pf, pl, _ = pstep(*state, batch, i, gen)
        check(hw_aware.CROSSBAR_LIB.launches == 0
              and fused.FUSED_LIB.launches == 0,
              "the torch engine launched a kernel")
        kp, kh, kf, kl, _ = kstep(*state, batch, i, a.gen)
        check(hw_aware.CROSSBAR_LIB.launches == 2
              and fused.FUSED_LIB.launches == 4,
              "the cuda engine did not run B2 twice and B1 four times")
        b.step(1)
        kl, pl = float(kl), float(pl)
        rel = abs(kl - pl) / max(1.0, abs(pl))
        worst_lock = max(worst_lock, rel)
        check(rel <= 1e-5, f"step {i}: lockstep losses {kl} vs {pl}")
        worst_indep = max(worst_indep, abs(kl - float(b.last_loss))
                          / max(1.0, abs(float(b.last_loss))))
        for k in kf["life_q"]:
            check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                  f"step {i}: lockstep life_q banks differ on {k}")
            check(torch.equal(kf["life_q"][k], b.fault_state["life_q"][k]),
                  f"step {i}: life_q banks of the independent run differ "
                  f"on {k}")
        state = (kp, kh, kf)
    a.params, a.history, a.fault_state = state
    frac = a.broken_fraction()
    check(frac > 0, "no cell broke")
    flat = a._flat(a.params)
    for k, lq in a.fault_state["life_q"].items():
        stuck = packed.unpack_stuck(a.fault_state["stuck_bits"][k],
                                    a.pack_spec["last_dim"][k])
        br = lq <= 0
        check(torch.equal(flat[k][br], stuck[br]),
              f"a broken cell of {k} is not at its stuck value")
    print(f"phase 5: {steps} steps at N(300, 50), int16 banks: life_q "
          f"identical (cuda vs torch engine, lockstep and independent) at "
          f"every step; lockstep max loss rel diff {worst_lock:.2e} "
          f"(limit 1e-5); independent runs max loss rel diff "
          f"{worst_indep:.2e} (reported only); broken fraction {frac:.4f}, "
          "broken cells at their stuck values", flush=True)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50,
                   help="training steps of the slice phase (default 50)")
    p.add_argument("--transition-steps", type=int, default=6)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    gpu = gpu_line()
    print(f"phase 1: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t = kernels.build_all(kernels.all_libraries())
    for lib in kernels.all_libraries():
        regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
                if "registers" in ln or "spill" in ln]
        took = (f"in {lib.build_seconds:.1f} s" if lib.build_seconds
                is not None else "earlier (library found in the build dir)")
        print(f"phase 1: built {lib.source.name} {took}: "
              f"{' | '.join(regs)}", flush=True)
    print(f"phase 1: kernels built in {t:.1f} s (parallel nvcc)", flush=True)

    err_b1 = phase_b1(device)
    err_b2 = phase_b2(device)
    launches, step_s, breakdown = phase_slice(args.steps, gpu)
    phase_transitions(args.transition_steps)

    print("per-step kernel numbers (ms on the card, summed over the "
          "step's launches):", flush=True)
    b2 = b2_step_numbers(device)
    b1 = b1_step_numbers(device)
    rows = [
        {"name": "crossbar_forward (B2)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": launches["B2"], "max_abs_err": err_b2, **b2},
        {"name": "fused_update_fail (B1)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": launches["B1"], "max_abs_err": err_b1, **b1},
    ]
    print(json.dumps({"step": {"median_ms": step_s * 1e3,
                               "feed_ms": breakdown["feed_ms"],
                               "device_busy_ms":
                                   breakdown["device_busy_ms"]}}))
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
