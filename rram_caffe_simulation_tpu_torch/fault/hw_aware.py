"""Hardware-aware crossbar read (counterpart of the reference package's
fault/hw_aware.py): conductance noise, ADC-grid weight quantization and
the stuck-cell clamp on the forward read of fault-target weights, with
straight-through gradients.

Two spellings with one contract:

- `perturb_weight` / `quantize_ste`: plain tensor ops, used for biases
  and by the "torch" engine's reference path.
- `crossbar_matmul_lanes`: y_c = x_c @ where(broken, stuck, quantize(w)
  * (1 + sigma*eps)) for C config lanes (the sweep's config axis; x
  shared or per lane) as a `torch.autograd.Function` whose forward is
  one launch of kernel B2 (csrc/crossbar.cu) on the card and its plain
  version (`crossbar_forward_plain`) on the CPU or when asked for by
  name. The backward follows the reference's `_cm_bwd` per lane: dx
  against the clean masked weights (on the lane's quantization grid
  when q_bits is set), dw zeroed on broken cells, batched
  `torch.matmul` (the reference has no backward kernel either).
  `crossbar_matmul` is its one-lane case, the single-config read.

In-kernel noise is Philox4x32-10 keyed by the lane seed with the flat
weight index k*N+n as counter; `philox_normal` is the same draw in
tensor ops (equal bits, Box-Muller equal up to libm's last ulp).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_TWO_POW_M32 = 2.0 ** -32

_VP = ctypes.c_void_p
CROSSBAR_LIB = kernels.CudaLibrary(
    "crossbar.cu",
    {"rram_crossbar_forward": [
        _VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP, _VP,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP, _VP]})


def q_levels(q_bits: int) -> float:
    """Symmetric level count 2^(bits-1)-1 of a bit width (0 = off)."""
    if not q_bits:
        return 0.0
    if q_bits < 2:
        raise ValueError(f"crossbar q_bits needs bits >= 2, got {q_bits}")
    return float(2 ** (q_bits - 1) - 1)


_LEVELS = {}     # (levels, dtype, device) -> the divisor on the device


def _grid_step(max_abs: torch.Tensor, levels: float) -> torch.Tensor:
    # the divisor is a device tensor, not a Python scalar: CUDA's div by
    # a host scalar multiplies by its reciprocal, which can differ from
    # IEEE division in the last bit. It is made once per device: a fresh
    # host-to-card copy would wait for the stream at every step
    key = (levels, max_abs.dtype, max_abs.device)
    if key not in _LEVELS:
        _LEVELS[key] = torch.tensor(levels, dtype=max_abs.dtype,
                                    device=max_abs.device)
    return max_abs.clamp_min(1e-12) / _LEVELS[key]


def quantize_tile(w: torch.Tensor, max_abs: torch.Tensor, levels: float):
    """The grid values clip(round(w / s), -l, l) * s, s = max_abs / l."""
    s = _grid_step(max_abs, levels)
    return torch.round(w / s).clamp(-levels, levels) * s


def lane_max_abs(x: torch.Tensor, lanes: int = 0) -> torch.Tensor:
    """max |x| over the whole tensor, or per config lane (the leading
    axis, kept for broadcasting) when `lanes` is set."""
    if not lanes:
        return x.detach().abs().max()
    return x.detach().abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)


def quantize_ste(x: torch.Tensor, bits: int, max_abs=None, lanes: int = 0):
    """Symmetric uniform quantization (ADC model), straight-through:
    the forward value is x + (q - x), the gradient is 1. With `lanes`,
    x carries a leading config axis and each lane has its own grid."""
    if not bits:
        return x
    if bits < 2:
        raise ValueError(f"quantize_ste needs bits >= 2, got {bits}")
    if max_abs is None:
        max_abs = lane_max_abs(x, lanes)
    q = quantize_tile(x.detach(), max_abs, q_levels(bits))
    return x + (q - x.detach())


def perturb_weight(w: torch.Tensor, broken: torch.Tensor,
                   stuck: torch.Tensor, gen, sigma: float):
    """Forward read of a crossbar weight array: multiplicative Gaussian
    conductance noise on live cells, stuck value on broken ones;
    gradients pass to `w` unchanged. `gen` is a CPU torch.Generator
    (used only when sigma != 0)."""
    wd = w.detach()
    noisy = wd
    if sigma:
        eps = torch.randn(w.shape, generator=gen).to(w.device)
        noisy = wd * (1.0 + sigma * eps)
    w_eff = torch.where(broken, stuck.to(w.dtype), noisy)
    return w + (w_eff - wd)


# ---------------------------------------------------------------------------
# kernel B2 and its plain version

def _mulhilo(a: torch.Tensor, b: int):
    """(hi, lo) 32-bit words of a * b for uint32 values held in int64,
    by 16-bit limbs so no intermediate leaves int64's range."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p0, p1, p2, p3 = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi & _MASK32, lo


def philox_normal(seeds, K: int, N: int, device) -> torch.Tensor:
    """(C, K, N) N(0,1) draws, the in-kernel noise of kernel B2:
    Philox4x32-10, key (seed, 0), counter (k*N+n, 0, 0, 0), Box-Muller
    on the first two output words."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    cell = torch.arange(K * N, dtype=torch.int64, device=device)
    c0 = (cell & _MASK32).expand(len(seeds), -1)
    c1 = (cell >> 32).expand(len(seeds), -1)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = (seeds & _MASK32).view(-1, 1)
    k1 = torch.zeros_like(k0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32

    def unit(bits):
        u = bits.to(torch.float32) * _TWO_POW_M32
        return u - torch.floor(u)

    u1 = unit(c0).clamp_min(1e-12)
    u2 = unit(c1)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)
    return eps.view(len(seeds), K, N)


def effective_weight_plain(w, broken, stuck, sigma: float, eps,
                           levels: float, scale):
    """The reference's `_w_eff` on (C, K, N) lanes: grid quantization
    with the lane's max-abs `scale` (C,), noise when sigma != 0, stuck
    clamp, each in its straight-through spelling w + (f(w) - w)."""
    if levels:
        s = _grid_step(scale, levels).view(-1, 1, 1)
        q = torch.round(w / s).clamp(-levels, levels) * s
        w = w + (q - w)
    noisy = w * (1.0 + sigma * eps) if sigma else w
    return w + (torch.where(broken > 0, stuck, noisy) - w)


def _lane_scale(w, levels):
    return w.abs().amax(dim=(1, 2)) if levels else None


def crossbar_forward_plain(x, w, broken, stuck, seeds, sigma: float,
                           q_bits: int = 0, eps=None):
    """The plain PyTorch version of kernel B2: an explicit quantize,
    noise and clamp, then x @ w_eff. x is (M, K) shared by every lane or
    (C, M, K); w, broken, stuck (C, K, N); seeds (C,); eps (C, K, N)
    host noise, or None to draw the kernel's own Philox noise."""
    levels = q_levels(q_bits)
    if sigma and eps is None:
        eps = philox_normal(seeds, w.shape[1], w.shape[2], w.device)
    w_eff = effective_weight_plain(w, broken, stuck, sigma, eps, levels,
                                   _lane_scale(w, levels))
    return torch.matmul(x, w_eff)


def _check_crossbar(x, w, broken, stuck, seeds, eps):
    if w.dim() != 3:
        raise ValueError(f"crossbar: w must be (C, K, N), got "
                         f"{tuple(w.shape)}")
    C, K, N = w.shape
    for name, t in (("broken", broken), ("stuck", stuck)):
        if tuple(t.shape) != (C, K, N):
            raise ValueError(f"crossbar: {name} shape {tuple(t.shape)} "
                             f"!= w shape {(C, K, N)}")
    if x.dim() not in (2, 3) or x.shape[-1] != K or (
            x.dim() == 3 and x.shape[0] != C):
        raise ValueError(f"crossbar: x shape {tuple(x.shape)} does not "
                         f"fit w {(C, K, N)}")
    if eps is not None and tuple(eps.shape) != (C, K, N):
        raise ValueError(f"crossbar: eps shape {tuple(eps.shape)}")
    if tuple(seeds.shape) != (C,):
        raise ValueError(f"crossbar: seeds shape {tuple(seeds.shape)}, "
                         f"expected ({C},)")
    for name, t in (("x", x), ("w", w), ("broken", broken),
                    ("stuck", stuck)) + ((("eps", eps),) if eps is not None
                                         else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"crossbar: {name} must be float32, got "
                            f"{t.dtype}")


def crossbar_forward(x, w, broken, stuck, seeds, sigma: float,
                     q_bits: int = 0, eps=None) -> torch.Tensor:
    """(C, M, N) crossbar reads of C config lanes. On CUDA tensors this
    launches kernel B2; on CPU tensors it runs the plain version."""
    seeds = torch.as_tensor(seeds, device=w.device)
    _check_crossbar(x, w, broken, stuck, seeds, eps)
    if not w.is_cuda:
        return crossbar_forward_plain(x, w, broken, stuck, seeds, sigma,
                                      q_bits, eps)
    tensors = [x, w, broken, stuck] + ([eps] if eps is not None else [])
    if any(t.device != w.device for t in tensors):
        raise ValueError("crossbar: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("crossbar: operands must be contiguous")
    C, K, N = w.shape
    M = x.shape[-2]
    levels = q_levels(q_bits)
    seeds = seeds.to(torch.int32).contiguous()
    scale = _lane_scale(w, levels)
    out = torch.empty((C, M, N), dtype=torch.float32, device=w.device)
    null = ctypes.c_void_p(None)
    CROSSBAR_LIB.call(
        "rram_crossbar_forward", kernels.ptr(x),
        M * K if x.dim() == 3 else 0, kernels.ptr(w), kernels.ptr(broken),
        kernels.ptr(stuck), kernels.ptr(eps) if eps is not None else null,
        kernels.ptr(scale) if scale is not None else null,
        kernels.ptr(seeds), float(sigma), levels, C, M, K, N,
        kernels.ptr(out), kernels.stream_ptr(w.device))
    return out


class CrossbarMatmul(torch.autograd.Function):
    """C config lanes' crossbar reads in one launch of kernel B2, with
    the reference's straight-through backward (`_cm_bwd`) per lane as
    batched products: dx against the clean masked weights (on the
    lane's quantization grid when q_bits is set), dw zeroed on broken
    cells (the reference has no backward kernel either)."""

    @staticmethod
    def forward(ctx, x, w, broken, stuck, seeds, sigma, q_bits, use_kernel):
        fwd = crossbar_forward if use_kernel else crossbar_forward_plain
        y = fwd(x.contiguous(), w.contiguous(),
                broken.to(torch.float32).contiguous(),
                stuck.to(torch.float32).contiguous(), seeds, sigma, q_bits)
        ctx.save_for_backward(x, w, broken, stuck)
        ctx.q_bits = q_bits
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, broken, stuck = ctx.saved_tensors
        wv = w
        if ctx.q_bits:
            # dx flows through the values the forward used: each lane's
            # grid weights; dw stays straight-through to the masters
            wv = quantize_tile(w, lane_max_abs(w, lanes=1),
                               q_levels(ctx.q_bits))
        brk = broken.to(torch.bool)
        w_masked = torch.where(brk, stuck.to(w.dtype), wv)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w_masked.transpose(1, 2))
            if x.dim() == 2:            # x shared by every lane
                dx = dx.sum(0)
        if ctx.needs_input_grad[1]:
            dw = torch.where(brk, torch.zeros((), dtype=g.dtype,
                                               device=g.device),
                             torch.matmul(x.transpose(-2, -1), g))
        return dx, dw, None, None, None, None, None, None


def crossbar_matmul_lanes(x, w, broken, stuck, seeds, sigma: float,
                          q_bits: int = 0, use_kernel: bool = True):
    """y_c = x_c @ where(broken_c, stuck_c, quantize_c(w_c) * (1 +
    sigma*eps_c)) for C config lanes, one kernel launch whatever C is.

    x (M, K) shared by every lane or (C, M, K); w, stuck (C, K, N) f32;
    broken (C, K, N) bool or 0/1; seeds (C,) int32 (on w's device, so
    the launch waits for no host copy). Returns (C, M, N)."""
    return CrossbarMatmul.apply(x, w, broken, stuck, seeds, float(sigma),
                                int(q_bits), bool(use_kernel))


def crossbar_matmul(x, w, broken, stuck, seed: int, sigma: float,
                    q_bits: int = 0, use_kernel: bool = True):
    """y = x @ where(broken, stuck, quantize(w) * (1 + sigma*eps)): one
    config's read, the one-lane case of `crossbar_matmul_lanes`.

    x (M, K) f32; w (K, N) f32; broken (K, N) bool or 0/1; stuck (K, N);
    seed an int; sigma, q_bits as in the reference. `use_kernel` routes
    the forward through the kernel wrapper (kernel B2 on CUDA tensors)
    or straight to the plain version."""
    seeds = torch.tensor([int(seed)], dtype=torch.int32, device=w.device)
    return crossbar_matmul_lanes(x, w[None], broken[None], stuck[None],
                                 seeds, sigma, q_bits, use_kernel)[0]
