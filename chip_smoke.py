#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --steps 10      # a shorter slice phase
    python3 chip_smoke.py --phases 6,8    # some phases (no "ok" line)

Phases (each raises on failure; the script then exits non-zero and
prints no "ok" line):

1. the card's name and power limit; build the three kernels from csrc/
   with nvcc (one process per source, started together), timed;
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
4. the single-config slice: CIFAR-10-quick from its solver prototxt,
   lifetimes N(1e8, 3e7), ternary crossbar read, packed banks, fused
   epilogue, batch 100 from the in-repo LMDB, on the "cuda" engine;
   losses, the step time (median and quartiles), a breakdown into host
   feed and device busy time, and each kernel's launch count against
   the path's (B2 twice a step, B1 once per fault leaf: four a step);
   then a short run with rram_forward.sigma = 0.05 (in-kernel noise);
5. fault transitions: mean 300, std 50, the "cuda" and the "torch"
   engine from one seed, both on the card: in lockstep (same state and
   batch each step) losses within 1e-5 relative and life_q identical;
   an independent "torch" run's life_q identical at every step too;
   cells broken, every broken cell at its stuck value. Then the
   run-to-run drift: two independent "cuda" runs from one seed, three
   ways (cuDNN's nondeterministic algorithms allowed, the same with
   RRAM_POOL_BWD=cuda, and torch.backends.cudnn.deterministic as
   device.py sets it); the port's own setting must give bit-identical
   runs;
6. kernel B4 (max-pool backward) against its plain version, bit for bit
   (`torch.equal` on the int32 view), at pool1's shapes for C = 1 and
   C = 4, at an odd geometry (7x7, k3 s2, pad 1) and on a constant
   plane where every window ties; against autograd's max-pool backward
   within the reordering of at most 4 f32 addends (reported);
7. the sweep at full width: SweepRunner over CIFAR-10-quick at C = 512
   config lanes (halved until it fits the card), N(1e8, 3e7), ternary,
   packed banks, fused epilogue, the device-resident dataset,
   RRAM_POOL_BWD=cuda, chunk 5: one warm chunk, then 20 timed steps:
   configs x steps per second, step time (median and quartiles, CUDA
   events between steps), peak device memory, bytes_per_step_est, the
   profiler's device busy time, and the launches per step whatever C
   is: B2 2, B1 4, B4 1; then one chunk with cudnn.deterministic flipped,
   timed beside it;
8. the sweep held against the plain path and against Solver at C = 8,
   N(300, 50) so cells break: in lockstep, engine "cuda" (and
   RRAM_POOL_BWD=cuda) against engine "torch" (RRAM_POOL_BWD=torch)
   from the same state and batch at every step, life_q identical and
   losses within 1e-5 relative; lane i against a single-config Solver
   started from lane i's state each step, the same; one lane poisoned
   with a NaN parameter is quarantined while the others stay finite.

Then a JSON line of the step's numbers, a JSON line of the sweep's, one
JSON line of per-kernel numbers (per training step, summed over the
step's launches; B1b, B2b and B4 at the sweep's shapes), the card's name
and power limit, and last {"ok": true, "device": {...}}.
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


def timed(fn, iters=100):
    """(device ms, host-inclusive ms): the first, when the profiler
    works, is the kernel's own time; the second is the stream time per
    call with the Python launch path in it."""
    ev = event_ms(fn, iters=iters, warmup=max(1, iters // 10))
    dev = device_ms(fn, iters=max(2, iters // 2))
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


def b1_inputs_dev(shape, C, seed, device):
    """B1 operands with a leading C axis, drawn on the card (the sweep's
    leaves are too large to draw on the host quickly); int32 banks."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    full = (C,) + tuple(shape)
    data = torch.randn(full, generator=g, device=device)
    upd = torch.randn(full, generator=g, device=device) * 1e-3
    lq = torch.randint(-3, 4, full, generator=g, device=device,
                       dtype=torch.int32)
    L = full[-1]
    bank = torch.randint(0, 256, full[:-1] + (-(-L // 4),), generator=g,
                         device=device, dtype=torch.uint8)
    return data, upd, lq, bank & 0x55          # codes 0/1 only: valid


def b1_step_numbers(device, C=1, life_dtype="int32"):
    """Per-step B1 numbers at the slice's four leaves (C = 1) or the
    sweep's (C lanes each, one launch per leaf whatever C is); also the
    largest |kernel - plain| over the four leaves (must be 0)."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import fused
    ms = plain = bound = 0.0
    err = 0.0
    lb = 4 if life_dtype == "int32" else 2
    iters = 100 if C == 1 else 20
    for i, shape in enumerate(SLICE_LEAVES.values()):
        args = (b1_inputs(shape, life_dtype, 1, 100 + i, device) if C == 1
                else b1_inputs_dev(shape, C, 100 + i, device))
        kd, kq = fused.fused_update_fail(*args)
        pd, pq = fused.fused_update_fail_plain(*args)
        check(torch.equal(kd.view(torch.int32), pd.view(torch.int32))
              and torch.equal(kq, pq), f"B1 differs from its plain version "
              f"at C={C} {shape}")
        err = max(err, float((kd - pd).abs().max()))
        del kd, kq, pd, pq
        k, k_call = timed(lambda: fused.fused_update_fail(*args), iters)
        p, _ = timed(lambda: fused.fused_update_fail_plain(*args), iters)
        cells = math.prod(shape) * C
        bank = args[3].numel()
        nbytes = cells * (4 + 4 + lb) + bank + cells * (4 + lb)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  B1 C={C} {tuple(shape)} {life_dtype}: kernel {k:.5f} ms "
              f"({k_call:.5f} ms per wrapper call), plain {p:.5f} ms, "
              f"bound {b:.6f} ms (bytes {nbytes})", flush=True)
        ms, plain, bound = ms + k, plain + p, bound + b
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}, err


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


def b2_inputs_dev(M, K, N, C, seed, device):
    """B2 operands of the sweep (x per lane), drawn on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((C, M, K), generator=g, device=device)
    w = torch.randn((C, K, N), generator=g, device=device) * 0.1
    broken = (torch.rand((C, K, N), generator=g, device=device)
              < 0.1).float()
    stuck = torch.randint(-1, 2, (C, K, N), generator=g,
                          device=device).float()
    seeds = torch.randint(0, 2 ** 31 - 1, (C,), generator=g, device=device,
                          dtype=torch.int32)
    return x, w, broken, stuck, seeds


def b2_step_numbers(device, C=1):
    """Per-step B2 numbers at the two InnerProduct reads (ternary grid,
    sigma 0, as on the path): one config with x shared (C = 1), or the
    sweep's C lanes with x per lane, one launch per layer. The library
    call is torch.matmul (torch.bmm over the lanes) of x and w_eff.
    Also the largest |kernel - plain|, each case within its bound."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    ms = plain = bound = lib = 0.0
    err = 0.0
    bound_by = "bytes"
    iters = 100 if C == 1 else 20
    for i, (M, K, N) in enumerate(B2_SHAPES.values()):
        if C == 1:
            x, w, br, st, seeds, _ = b2_inputs(M, K, N, 1, False, 200 + i,
                                               device)
        else:
            x, w, br, st, seeds = b2_inputs_dev(M, K, N, C, 200 + i, device)
        w_eff = hw.effective_weight_plain(w, br, st, 0.0, None, 1.0,
                                          w.abs().amax(dim=(1, 2)))
        yk = hw.crossbar_forward(x, w, br, st, seeds, 0.0, 2)
        yp = hw.crossbar_forward_plain(x, w, br, st, seeds, 0.0, 2)
        e = (yk - yp).abs()
        check(bool((e <= b2_bound(x, w_eff)).all()),
              f"B2 out of bound at C={C} M,K,N={M},{K},{N}")
        err = max(err, float(e.max()))
        del yk, yp, e
        if C == 1:
            w_eff = w_eff[0]
            lib_fn = lambda: torch.matmul(x, w_eff)
        else:
            lib_fn = lambda: torch.bmm(x, w_eff)
        k, k_call = timed(lambda: hw.crossbar_forward(x, w, br, st, seeds,
                                                      0.0, 2), iters)
        p, _ = timed(lambda: hw.crossbar_forward_plain(x, w, br, st, seeds,
                                                       0.0, 2), iters)
        lb, _ = timed(lib_fn, iters)
        nbytes = 4 * (x.numel() + 3 * C * K * N + C * M * N)
        flops = 2 * C * M * K * N
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        print(f"  B2 C={C} M,K,N={M},{K},{N}: kernel {k:.5f} ms ({k_call:.5f}"
              f" ms per wrapper call), plain {p:.5f} ms, "
              f"{'torch.matmul' if C == 1 else 'torch.bmm'} {lb:.5f} ms, "
              f"bound {max(tb, tf):.6f} ms (bytes {nbytes}: {tb:.6f}; flop "
              f"{flops}: {tf:.6f})", flush=True)
        if tf > tb and i == 0:
            bound_by = "operations"
        ms, plain, bound, lib = ms + k, plain + p, bound + max(tb, tf), \
            lib + lb
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib}, err


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


def device_kernels(prof, steps):
    """(busy ms per step, {kernel name: ms per step}) of a profile: the
    device's activity records, each counted once, busy time as the union
    of their intervals (so nothing overlapping counts twice)."""
    from torch.autograd import DeviceType
    seen, spans, by_name = set(), [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = (ev.name, ev.time_range.start, ev.time_range.end)
        if key in seen:
            continue
        seen.add(key)
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us() / 1e3 / steps
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3 / steps, by_name


def step_breakdown(s, steps=5):
    """Host feed time per batch, and the device's kernel time per step
    (torch.profiler/CUPTI) with the five largest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(10):
        s.train_feed()
    feed_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.step(steps)
        torch.cuda.synchronize()
    busy, by_name = device_kernels(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"feed_ms": feed_ms, "device_busy_ms": busy,
            "top": "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top)}


def phase_transitions(steps):
    """Kernel path against plain path through the fault transitions.

    Lockstep: every step, the "cuda" and the "torch" step run from the
    same state on the same batch; their losses must agree within 1e-5
    relative (only B2's summation order differs within one step) and
    their life_q banks exactly. Independent: a second solver trains on
    the "torch" engine alone from the same seed; its banks must equal
    the kernel path's at every step. Its losses are only reported: B2
    and torch.matmul sum in other orders, and once cells stick at +-1
    the training dynamics amplify that last-bit difference. Run-to-run
    drift of one engine is `phase_drift`'s subject."""
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


def _bits_equal(a, b):
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def drift_pair(steps, deterministic, pool_bwd=None):
    """Two independent "cuda"-engine runs from one seed at N(300, 50),
    stepped side by side: whether their losses and params stay equal bit
    for bit, the first step where they part, the largest loss gap, and
    the median step time of the first run."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             os.environ.get("RRAM_POOL_BWD"))
    if pool_bwd is not None:
        os.environ["RRAM_POOL_BWD"] = pool_bwd
    try:
        a = slice_solver(300.0, 50.0, seed=5)
        b = slice_solver(300.0, 50.0, seed=5)
        # set after the solvers are built: resolve_device sets the port's
        # own choice on every build
        torch.backends.cudnn.deterministic = deterministic
        first, gap, times = None, 0.0, []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.step(1)
            times.append(time.perf_counter() - t0)
            b.step(1)
            la, lb = float(a.last_loss), float(b.last_loss)
            fa, fb = a._flat(a.params), b._flat(b.params)
            same = la == lb and all(_bits_equal(fa[k], fb[k]) for k in fa)
            if not same and first is None:
                first = i
            gap = max(gap, abs(la - lb) / max(1.0, abs(lb)))
        return {"identical": first is None, "first_diff_step": first,
                "max_loss_rel_gap": gap,
                "median_step_ms": float(np.median(times)) * 1e3}
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        if saved[1] is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved[1]


def phase_drift(steps):
    """Settle what makes two runs from one seed part on the card: the
    same pair three ways. The port's own setting (device.py) must give
    runs that are bit-identical."""
    import torch
    from rram_caffe_simulation_tpu_torch.device import CUDNN_DETERMINISTIC
    ways = {
        "cudnn.deterministic=False": drift_pair(steps, False),
        "cudnn.deterministic=False, RRAM_POOL_BWD=cuda":
            drift_pair(steps, False, pool_bwd="cuda"),
        "cudnn.deterministic=True": drift_pair(steps, True),
    }
    for name, r in ways.items():
        print(f"phase 5: drift, two independent cuda-engine runs, {steps} "
              f"steps at N(300, 50), {name}: "
              f"{'bit-identical' if r['identical'] else 'part at step %d' % r['first_diff_step']}"
              f", max loss rel gap {r['max_loss_rel_gap']:.3e}, median "
              f"step {r['median_step_ms']:.3f} ms", flush=True)
    own = ways[f"cudnn.deterministic={CUDNN_DETERMINISTIC}"]
    check(own["identical"], "two runs from one seed part under the port's "
          f"own setting (cudnn.deterministic={CUDNN_DETERMINISTIC})")
    check(torch.backends.cudnn.deterministic == CUDNN_DETERMINISTIC,
          "the port's cuDNN setting was not restored")
    return ways


# ---------------------------------------------------------------------------
# phase 6: B4

POOL1 = ((3, 3), (2, 2), (0, 1, 0, 1))   # kernel, stride, fpad (CEIL hi 1)


def pooled(hw, kernel, stride, fpad):
    return ((hw[0] + fpad[2] + fpad[3] - kernel[0]) // stride[0] + 1,
            (hw[1] + fpad[0] + fpad[1] - kernel[1]) // stride[1] + 1)


def b4_inputs(lead, hw, geometry, seed, device, const=None):
    """x (lead..., H, W) and g (lead..., Ho, Wo), drawn on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    ohw = pooled(hw, *geometry)
    x = (torch.full(tuple(lead) + tuple(hw), const, device=device)
         if const is not None else
         torch.randn(tuple(lead) + tuple(hw), generator=g, device=device))
    return x, torch.randn(tuple(lead) + ohw, generator=g, device=device)


def autograd_pool_dx(x, g, kernel, stride, fpad):
    """dx through F.pad(-inf) + F.max_pool2d and autograd's own CUDA
    max-pool backward."""
    import torch
    import torch.nn.functional as F
    xr = x.detach().requires_grad_()
    y = F.max_pool2d(F.pad(xr, fpad, value=float("-inf")), kernel, stride)
    (dx,) = torch.autograd.grad(y, xr, g)
    return dx


def phase_b4(device):
    import torch
    from rram_caffe_simulation_tpu_torch.ops import pool_backward as pb
    cases = [("pool1 C=1", (100, 32), (32, 32), POOL1, None),
             ("pool1 C=4", (100, 128), (32, 32), POOL1, None),
             ("7x7 k3 s2 pad 1", (8, 5), (7, 7),
              ((3, 3), (2, 2), (1, 1, 1, 1)), None),
             ("constant plane", (4, 6), (32, 32), POOL1, 0.25)]
    worst_auto = 0.0
    for n, (name, lead, hw, geometry, const) in enumerate(cases):
        x, g = b4_inputs(lead, hw, geometry, 300 + n, device, const)
        dk = pb.max_pool_backward(x, g, *geometry)
        dp = pb.max_pool_backward_plain(x, g, *geometry)
        torch.cuda.synchronize()
        check(torch.equal(dk.view(torch.int32), dp.view(torch.int32)),
              f"B4 differs from its plain version: {name}")
        if const is not None:
            kernel, stride, fpad = geometry
            ohw = g.shape[-2:]
            anchors = dk[..., fpad[2]::stride[0], fpad[0]::stride[1]]
            check(torch.equal(anchors[..., :ohw[0], :ohw[1]], g),
                  "B4: a tied window's cotangent is not at its first "
                  "element")
        da = autograd_pool_dx(x, g, *geometry)
        bound = 4 * U32 * pb.max_pool_backward_plain(x, g.abs(), *geometry)
        err = (dk - da).abs()
        check(bool((err <= bound + 1e-30).all()),
              f"B4 and autograd's backward differ beyond reordering: {name}")
        worst_auto = max(worst_auto, float(err.max()))
    print(f"phase 6: B4 bit-identical to its plain version in {len(cases)} "
          f"cases (pool1 C=1 and C=4, 7x7 k3 s2 pad 1, a constant plane); "
          f"against autograd's max-pool backward max abs err "
          f"{worst_auto:.3e} (within 4 f32 roundings of the summed "
          "cotangents)", flush=True)
    return 0.0, worst_auto


def b4_step_numbers(device, C):
    """B4 at the sweep's pool1 (x (100, C*32, 32, 32)): kernel, plain
    version, and autograd's CUDA max-pool backward given the forward's
    indices (torch.ops.aten.max_pool2d_with_indices_backward on the
    padded input); bound = bytes of x + g + dx over the HBM rate."""
    import torch
    import torch.nn.functional as F
    from rram_caffe_simulation_tpu_torch.ops import pool_backward as pb
    kernel, stride, fpad = POOL1
    x, g = b4_inputs((100, 32 * C), (32, 32), POOL1, 400, device)
    iters = 100 if C <= 4 else 10
    k, k_call = timed(lambda: pb.max_pool_backward(x, g, *POOL1), iters)
    p, _ = timed(lambda: pb.max_pool_backward_plain(x, g, *POOL1),
                 max(2, iters // 5))
    xp = F.pad(x, fpad, value=float("-inf"))
    _, idx = F.max_pool2d(xp, kernel, stride, return_indices=True)
    lib, _ = timed(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        g, xp, list(kernel), list(stride), [0, 0], [1, 1], False, idx),
        iters)
    del xp, idx
    nbytes = 4 * (2 * x.numel() + g.numel())
    b = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  B4 C={C} x {tuple(x.shape)}: kernel {k:.5f} ms ({k_call:.5f} "
          f"ms per wrapper call), plain {p:.5f} ms, autograd's backward "
          f"{lib:.5f} ms, bound {b:.6f} ms (bytes {nbytes})", flush=True)
    return {"ms": k, "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": lib}


# ---------------------------------------------------------------------------
# phases 7 and 8: the sweep

def sweep_runner(C, mean, std, engine="cuda", seed=1):
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = slice_solver(mean, std, hw_engine=engine, seed=seed)
    return SweepRunner(s, n_configs=C, engine=engine, packed_state=True,
                       dtype_policy="ternary")


SWEEP_CONFIGS = 512              # the reference bench's sweep width
SWEEP_CHUNK = 5
SWEEP_STEPS = 20                 # timed steps of phase 7


def _launches():
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    from rram_caffe_simulation_tpu_torch.ops import pool_backward
    return {"B2": hw_aware.CROSSBAR_LIB.launches,
            "B1": fused.FUSED_LIB.launches,
            "B4": pool_backward.POOL_BWD_LIB.launches}


def _event_stepper(runner, events):
    """Wrap the runner's step function so a CUDA event is recorded on the
    stream after each step's work: the gaps between events are the step
    times on the device's timeline, with no host synchronization."""
    import torch
    inner = runner._step

    def stepper(*args):
        out = inner(*args)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out
    return inner, stepper


def sweep_breakdown(r, steps=SWEEP_CHUNK):
    """Device kernel time per sweep step (torch.profiler/CUPTI) over one
    chunk, with the five largest kernels by name, and the chunk's own
    step time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.step(steps, chunk=steps)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    busy, by_name = device_kernels(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_step_ms": wall, "device_busy_ms": busy,
            "top": "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top)}


def run_sweep(C, timed_steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = sweep_runner(C, 1e8, 3e7)
    setup_s = time.perf_counter() - t0
    check(r.engine_resolved == "cuda" and r.fused_epilogue_resolved,
          "the sweep did not resolve to the cuda engine with the fused "
          "epilogue")
    check(r._dataset is not None, "the dataset is not on the device")
    check(r._pack_spec["life_dtype"] == "int32", "1e8 banks must be int32")
    warm = r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
    check(bool(np.isfinite(warm).all()), "non-finite loss in the warm chunk")
    check(bool((np.abs(warm - math.log(10)) < 0.05).all()),
          "warm-chunk losses far from ln(10) at a near-zero init")
    events = []
    inner, stepper = _event_stepper(r, events)
    r._step = stepper
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    start.record()
    t0 = time.perf_counter()
    losses = r.step(timed_steps, chunk=SWEEP_CHUNK)   # ends in a host read
    wall = time.perf_counter() - t0
    launches = _launches()
    r._step = inner
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
          "non-finite or misshapen sweep losses")
    check(launches == {"B2": 2 * timed_steps, "B1": 4 * timed_steps,
                       "B4": timed_steps},
          f"launches {launches} in {timed_steps} steps, expected B2 2, B1 "
          "4, B4 1 per step")
    # N(1e8, 3e7) draws a few cells dead (z < -3.3); none dies in a run
    check(float(r.broken_fractions().max()) < 1e-3,
          "cells broke at N(1e8, 3e7)")
    q1, med, q3 = (float(v) for v in np.percentile(step_ms, [25, 50, 75]))
    rate = C * timed_steps / wall
    bd = sweep_breakdown(r)
    # the same chunk with cuDNN's determinism flipped, timed beside it
    flip = not torch.backends.cudnn.deterministic
    saved = torch.backends.cudnn.deterministic
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = flip
    try:
        r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
        torch.cuda.synchronize()
        flip_ms = (time.perf_counter() - t0) / SWEEP_CHUNK * 1e3
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = saved
        r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t0) / SWEEP_CHUNK * 1e3
    finally:
        torch.backends.cudnn.deterministic = saved
    out = {"configs": C, "chunk": SWEEP_CHUNK, "timed_steps": timed_steps,
           "configs_steps_per_s": rate, "wall_s": wall,
           "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "bytes_per_step_est": r.bytes_per_step_est(),
           "setup_s": setup_s, "launches": launches, **bd,
           # busy time from the profiled chunk against the unprofiled
           # step: the profiler slows the host, not the kernels
           "device_idle_share": max(0.0, 1 - bd["device_busy_ms"] / med),
           f"chunk_step_ms_cudnn_deterministic_{flip}": flip_ms,
           f"chunk_step_ms_cudnn_deterministic_{saved}": again_ms,
           "gpu": gpu}
    del r
    return out


def phase_sweep(C, timed_steps, gpu):
    """Phase 7 at C lanes, halved while the card runs out of memory."""
    import torch
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        while True:
            try:
                out = run_sweep(C, timed_steps, gpu)
                break
            except torch.cuda.OutOfMemoryError:
                check(C > 8, "the sweep does not fit the card at C = 8")
                print(f"phase 7: C = {C} does not fit the card "
                      f"(out of memory); halving", flush=True)
                C //= 2
                torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    print(f"phase 7: sweep, CIFAR-10-quick batch 100, C = {C} config lanes, "
          f"N(1e8, 3e7), ternary, packed int32 banks, fused epilogue, device "
          f"dataset, RRAM_POOL_BWD=cuda, chunk {SWEEP_CHUNK}: "
          f"{out['configs_steps_per_s']:.1f} configs*steps/s over "
          f"{timed_steps} steps ({out['wall_s']:.3f} s); step median "
          f"{out['step_ms_median']:.3f} ms (quartiles {out['step_ms_q1']:.3f}"
          f" / {out['step_ms_q3']:.3f}); peak memory "
          f"{out['peak_mem_bytes'] / 1e9:.2f} GB; bytes_per_step_est "
          f"{out['bytes_per_step_est']}; launches {out['launches']}; "
          f"{gpu}", flush=True)
    print(f"phase 7: kernels on the card {out['device_busy_ms']:.3f} ms/step"
          f" ({out['device_idle_share']:.1%} of the unprofiled step idle; "
          f"the profiled chunk took {out['profiled_step_ms']:.3f} ms/step); "
          f"top device kernels: {out['top']}", flush=True)
    print("phase 7: one chunk each way, ms/step: " + ", ".join(
        f"{k[len('chunk_step_ms_'):]} {v:.3f}" for k, v in out.items()
        if k.startswith("chunk_step_ms_")), flush=True)
    return out


def phase_sweep_checks(steps, C=8):
    """Phase 8: the sweep against its plain path and against Solver, in
    lockstep at N(300, 50); then the per-lane quarantine."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    r = sweep_runner(C, 300.0, 50.0, seed=7)
    check(r._pack_spec["life_dtype"] == "int16", "mean 300 banks are int16")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=r._pack_spec, fused_epilogue=True)
    pstep = r.solver.make_train_step(hw_engine="torch", lanes=C, **opts)
    single = slice_solver(300.0, 50.0, seed=7)
    check(single.pack_spec == r._pack_spec, "pack specs differ")
    saved = os.environ.get("RRAM_POOL_BWD")
    worst_lock = worst_lane = 0.0
    try:
        for it in range(steps):
            batch = r._batch(r.iter)
            state = (r.params, r.history, r.fault_states)
            lanes_before = [r.lane_state(i) for i in range(C)]
            gen = torch.Generator()
            gen.set_state(r.solver.gen.get_state())
            os.environ["RRAM_POOL_BWD"] = "torch"
            kernels.reset_launches()
            _, _, pf, pl, _ = pstep(*state, batch, r.iter, gen)
            check(_launches() == {"B2": 0, "B1": 0, "B4": 0},
                  "the torch engine launched a kernel")
            os.environ["RRAM_POOL_BWD"] = "cuda"
            kp, kh, kf, kl, _ = r._step(*state, batch, r.iter, r.solver.gen)
            got = _launches()
            check(got == {"B2": 2, "B1": 4, "B4": 1},
                  f"sweep step launches {got}, expected B2 2, B1 4, B4 1")
            rel = ((kl - pl).abs() / pl.abs().clamp_min(1.0)).max()
            worst_lock = max(worst_lock, float(rel))
            check(float(rel) <= 1e-5, f"step {it}: lockstep losses "
                  f"{kl.tolist()} vs {pl.tolist()}")
            for k in kf["life_q"]:
                check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                      f"step {it}: lockstep life_q banks differ on {k}")
            for i in range(C):
                _, _, sf, sl, _ = single._step_fn(*lanes_before[i], batch,
                                                  r.iter, single.gen)
                rel = abs(float(sl) - float(kl[i])) / max(1.0, abs(float(sl)))
                worst_lane = max(worst_lane, rel)
                check(rel <= 1e-5, f"step {it} lane {i}: sweep loss "
                      f"{float(kl[i])} vs Solver {float(sl)}")
                for k in sf["life_q"]:
                    check(torch.equal(sf["life_q"][k], kf["life_q"][k][i]),
                          f"step {it} lane {i}: banks differ from Solver's "
                          f"on {k}")
            r._commit(kp, kh, kf, kl)
            r.iter += 1
        frac = r.broken_fractions()
        check(bool((frac > 0).all()), "a lane had no broken cell")
        # one lane poisoned: frozen, the others train on
        bad = 3
        r.params["conv2"][0][bad, 0, 0, 0, 0] = float("nan")
        before = r.lane_state(bad)[2]["life_q"]
        losses = r.step(2, chunk=2)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    check(list(r.quarantined()) == [bad], f"quarantined {r.quarantined()}")
    check(not math.isfinite(float(losses[bad])), "the poisoned lane's loss")
    check(all(math.isfinite(float(v)) for i, v in enumerate(losses)
              if i != bad), "a healthy lane went non-finite")
    after = r.lane_state(bad)[2]["life_q"]
    check(all(torch.equal(before[k], after[k]) for k in before),
          "the quarantined lane's banks moved")
    print(f"phase 8: sweep C = {C}, {steps} steps at N(300, 50), int16 banks:"
          f" cuda vs torch engine in lockstep, life_q identical, max loss "
          f"rel diff {worst_lock:.2e} (limit 1e-5); each lane vs Solver from "
          f"its state, life_q identical, max loss rel diff {worst_lane:.2e} "
          f"(limit 1e-5); broken fractions {[round(float(v), 4) for v in frac]}"
          f"; lane {bad} poisoned with a NaN: quarantined, banks frozen, the "
          f"other {C - 1} lanes finite", flush=True)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50,
                   help="training steps of the slice phase (default 50)")
    p.add_argument("--transition-steps", type=int, default=6)
    p.add_argument("--phases", default="all",
                   help="comma-separated phases 2-8 to run after the "
                        "build (default all; only a full run prints the "
                        "per-kernel line and the ok line)")
    args = p.parse_args(argv)
    every = set(range(2, 9))
    want = every if args.phases == "all" else {
        int(v) for v in args.phases.split(",")}

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

    if 2 in want:
        err_b1 = phase_b1(device)
    if 3 in want:
        err_b2 = phase_b2(device)
    if 4 in want:
        launches, step_s, breakdown = phase_slice(args.steps, gpu)
    if 5 in want:
        phase_transitions(args.transition_steps)
        drift = phase_drift(args.transition_steps)
    if 6 in want:
        err_b4, err_b4_auto = phase_b4(device)
    if 7 in want:
        sweep = phase_sweep(SWEEP_CONFIGS, SWEEP_STEPS, gpu)
    if 8 in want:
        phase_sweep_checks(args.transition_steps)
    if want != every:
        print(f"phases {sorted(want)} passed; no ok line for a partial run",
              flush=True)
        return 0

    C = sweep["configs"]
    print("per-step kernel numbers (ms on the card, summed over the "
          "step's launches):", flush=True)
    b2, _ = b2_step_numbers(device)
    b1, _ = b1_step_numbers(device)
    b2b, err_b2b = b2_step_numbers(device, C)
    b1b, err_b1b = b1_step_numbers(device, C)
    b4 = b4_step_numbers(device, C)
    sl = sweep["launches"]
    rows = [
        {"name": "crossbar_forward (B2a)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": launches["B2"], "max_abs_err": err_b2, **b2},
        {"name": "fused_update_fail (B1a)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": launches["B1"], "max_abs_err": err_b1, **b1},
        {"name": "crossbar_forward over C lanes (B2b)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": sl["B2"], "max_abs_err": max(err_b2, err_b2b), **b2b},
        {"name": "fused_update_fail over C lanes (B1b)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": sl["B1"], "max_abs_err": max(err_b1, err_b1b), **b1b},
        {"name": "max_pool_backward (B4)", "route": "cuda",
         "source": f"{PKG}/csrc/pool_backward.cu",
         "replaces": "rram_caffe_simulation_tpu/ops/pool_backward.py:141",
         "launches": sl["B4"], "max_abs_err": err_b4, **b4},
    ]
    print(json.dumps({"step": {"median_ms": step_s * 1e3,
                               "feed_ms": breakdown["feed_ms"],
                               "device_busy_ms":
                                   breakdown["device_busy_ms"]},
                      "drift": drift,
                      "b4_vs_autograd_max_abs_err": err_b4_auto}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
