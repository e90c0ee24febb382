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
  name. B2 reads its operands as they are stored, by their strides:
  dense (C, K, N), Caffe's stored (C, num_output, K) turned by view,
  x as the (M, C, K) view of a laned activation, `broken` as bool or
  uint8 (f32 0/1 is cast once); the wrapper makes no copy of them and
  the lanes' quantization scale is reduced inside the same call. The
  backward follows the reference's `_cm_bwd` per lane: dx
  against the clean masked weights (on the lane's quantization grid
  when q_bits is set), dw zeroed on broken cells, batched
  `torch.matmul` (the reference has no backward kernel either).
  `crossbar_matmul` is its one-lane case, the single-config read.
- `tiles=(bk, bn, adc_bits)` on those functions is the tiled crossbar
  read (fault/mapping.py): each (bk x bn) cell block of the (K, N) view
  is one physical tile whose partial product passes its own ADC before
  the digital sum over K-tiles. Kernel B2t (csrc/crossbar.cu, B2's GEMM
  core with a tile-ADC epilogue; its tile rows from `b2t_plan`) on the card,
  reading the operands as B2 does, `tiled_crossbar_matmul` in the plain
  version. The kernels' plain versions (`crossbar_forward_plain`,
  `crossbar_conv_forward_plain`) sum each tile's partial product in the
  kernels' k order on CUDA tensors (`ordered_tile_partials`: the two
  fmaf chains of each K-tile's 32-deep stages, emulated exactly in
  float64), so kernel and plain reads agree bit for bit, ADC levels
  included. On CPU tensors, and in the tiled read of a layer with no
  crossbar read armed (`tiled_crossbar_matmul` as ops/ call it), the
  partials are `torch.matmul` products: the order the CPU tests hold
  against the reference, and cuBLAS's speed on the card.
- `crossbar_conv_matmul_lanes`: the same tiled read for a convolution
  whose operand is gathered from the raw NCHW activation through the
  address plan of `mapping.im2col_index_plan`: kernel B3 on the card
  (csrc/crossbar.cu, B2t's core with the gather as the x tile's load,
  its tiles from `b3_plan`), reading w, broken and stuck as stored and
  the activation as the padded copy `pad_activation_flat` makes; its
  backward replays the reference's `_ccm_bwd` (the patch rows are
  materialized there, the reference's first-version trade).

In-kernel noise is Philox4x32-10 keyed by the lane seed with the flat
weight index k*N+n as counter; `philox_normal` is the same draw in
tensor ops (equal bits, Box-Muller equal up to libm's last ulp).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core import prng
from .mapping import conv_patch_rows, im2col_index_plan, pad_activation_flat

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_TWO_POW_M32 = 2.0 ** -32

_VP = ctypes.c_void_p
_STRIDES = ctypes.c_longlong * 3       # (lane, row, column), in elements
# (x, w, broken, stuck, eps) each with its strides, then seeds, sigma,
# levels; B2: C, M, K, N, bm, splits; B2t: adc_levels, C, M, K, N, bk, bn,
# bm; B3: adc_levels, row_base, col_off, C, M, K, N, bk, bn, bm, tile_n;
# then scratch, (B3: weff,) part, out, stream
_OPERANDS = [_VP, _STRIDES] * 5 + [_VP, ctypes.c_float, ctypes.c_float]
CROSSBAR_LIB = kernels.CudaLibrary(
    "crossbar.cu",
    {"rram_crossbar_forward":
        _OPERANDS + [ctypes.c_int] * 6 + [_VP] * 4,
     "rram_crossbar_tiled_forward":
        _OPERANDS + [ctypes.c_float] + [ctypes.c_int] * 7 + [_VP] * 4,
     "rram_crossbar_implicit_forward":
        _OPERANDS + [ctypes.c_float, _VP, _VP] + [ctypes.c_int] * 7
        + [_VP] * 5,
     # (bm, has_eps) -> resident GEMM blocks per SM; launches nothing
     "rram_crossbar_blocks_per_sm": [ctypes.c_int, ctypes.c_int]})


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
                   stuck: torch.Tensor, key, sigma: float):
    """Forward read of a crossbar weight array: multiplicative Gaussian
    conductance noise on live cells, w * (1 + sigma * normal(key)),
    stuck value on broken ones; gradients pass to `w` unchanged. `key`
    is a threefry key (core/prng.py), used only when sigma != 0; a batch
    of keys (C, 2) draws lane c of a laned `w` (C, ...) from key c. The
    factor rounds as in the reference's jitted step (`prng.normal_fma`).
    """
    wd = w.detach()
    noisy = wd
    if sigma:
        lead = np.asarray(key).ndim - 1
        noisy = wd * prng.normal_fma(key, w.shape[lead:], sigma, 1.0,
                                     w.device)
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


def _lane_w_eff(w, broken, stuck, seeds, sigma, q_bits, eps):
    levels = q_levels(q_bits)
    if sigma and eps is None:
        eps = philox_normal(seeds, w.shape[1], w.shape[2], w.device)
    return effective_weight_plain(w, broken, stuck, sigma, eps, levels,
                                  _lane_scale(w, levels))


def crossbar_forward_plain(x, w, broken, stuck, seeds, sigma: float,
                           q_bits: int = 0, eps=None, tiles=None):
    """The plain PyTorch version of kernels B2 and B2t: an explicit
    quantize, noise and clamp, then x @ w_eff, or with `tiles` = (bk,
    bn, adc_bits) the tiled read `tiled_crossbar_matmul`. x is (M, K)
    shared by every lane or (C, M, K); w, stuck (C, K, N) f32 and broken
    (C, K, N) bool, uint8 or f32 0/1, in any strides; seeds (C,); eps
    (C, K, N) host noise, or None to draw the kernel's own Philox
    noise. On CUDA tensors the tiled read sums in B2t's k order."""
    # the product runs on dense copies, so its summation order does not
    # depend on how the caller's views are laid out
    w_eff = _lane_w_eff(w, broken, stuck, seeds, sigma, q_bits,
                        eps).contiguous()
    x = x.contiguous()
    if tiles is not None:
        return tiled_crossbar_matmul(x, w_eff, *tiles,
                                     kernel_order=w_eff.is_cuda)
    return torch.matmul(x, w_eff)


def _check_crossbar(x, w, broken, stuck, seeds, eps, conv: bool = False):
    """Shapes and types of a crossbar read's operands; x is (M, K) or
    (C, M, K), or for a conv read (N, ch, H, W) or (C, N, ch, H, W)."""
    if w.dim() != 3:
        raise ValueError(f"crossbar: w must be (C, K, N), got "
                         f"{tuple(w.shape)}")
    C, K, N = w.shape
    for name, t in (("broken", broken), ("stuck", stuck)):
        if tuple(t.shape) != (C, K, N):
            raise ValueError(f"crossbar: {name} shape {tuple(t.shape)} "
                             f"!= w shape {(C, K, N)}")
    lane_dim = 5 if conv else 3
    if x.dim() not in (lane_dim - 1, lane_dim) or (
            x.dim() == lane_dim and x.shape[0] != C) or (
            not conv and x.shape[-1] != K):
        raise ValueError(f"crossbar: x shape {tuple(x.shape)} does not "
                         f"fit w {(C, K, N)}")
    if eps is not None and tuple(eps.shape) != (C, K, N):
        raise ValueError(f"crossbar: eps shape {tuple(eps.shape)}")
    if tuple(seeds.shape) != (C,):
        raise ValueError(f"crossbar: seeds shape {tuple(seeds.shape)}, "
                         f"expected ({C},)")
    for name, t in (("x", x), ("w", w), ("stuck", stuck)) + (
            (("eps", eps),) if eps is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"crossbar: {name} must be float32, got "
                            f"{t.dtype}")
    if broken.dtype not in (torch.float32, torch.bool, torch.uint8):
        raise TypeError("crossbar: broken must be bool, uint8 or float32 "
                        f"0/1, got {broken.dtype}")


def _check_tiles(tiles):
    bk, bn, adc_bits = (int(v) for v in tiles)
    if bk < 1 or bn < 1:
        raise ValueError(f"crossbar: tiles {tuple(tiles)} need bk, bn >= 1")
    q_levels(adc_bits)
    return bk, bn, adc_bits


def _one_device(tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("crossbar: operands on different devices")


B2_BK, B2_BN = 32, 64       # kernel B2's K stage and output tile columns
B2_FILL = 132               # blocks that fill the card (an H100's SMs)


def b2_plan(C: int, M: int, K: int, N: int):
    """(bm, splits) of kernel B2 for a shape: the output tile's rows and
    the split of the K stages. 128-row tiles with no split once they
    fill the card by themselves (the sweep: a lane's whole output is one
    tile, so W_eff is formed once a lane; 112 rows where they cover M in
    as many tiles, with less padding); else 32-row tiles and split-K
    until about B2_FILL blocks run. It depends on the shape alone, so a
    call's summation order is fixed."""
    cols = -(-N // B2_BN)
    stages = -(-K // B2_BK)
    if C * -(-M // 128) * cols >= B2_FILL:
        # 112 rows where that takes no more tiles (M = 100: one tile)
        return (112 if -(-M // 112) == -(-M // 128) else 128), 1
    blocks = C * -(-M // 32) * cols
    splits = max(1, min(stages, -(-B2_FILL // blocks)))
    if splits > 1:
        splits = -(-stages // -(-stages // splits))     # no empty split
    return 32, splits


_PLAN = threading.local()


@contextlib.contextmanager
def planned_lanes(lanes: int):
    """Plan every kernel B2 call made inside (on this thread) as if it
    ran at least `lanes` lanes: the sweep's config_block runs its blocks
    inside the plan of the whole sweep, so a block's lanes take the
    unblocked run's split-K and sum in its order (the tile rows do not
    move bits; the split does)."""
    prev = getattr(_PLAN, "lanes", 0)
    _PLAN.lanes = int(lanes)
    try:
        yield
    finally:
        _PLAN.lanes = prev


def b2t_plan(C: int, M: int, K: int, N: int, bk: int) -> int:
    """Tile rows of kernel B2t's GEMM pass for a shape and its K-tile
    depth bk: a block per lane, K-tile, row block and column block writes
    its raw partial; a second pass does the tile ADC and the ascending
    sum. 112 rows where that covers M in as many tiles as 128; 32 where
    the larger tiles leave the card short of B2_FILL blocks (more blocks
    in flight: ip1 at C = 1). It depends on the shape alone, and every
    tile height gives the same bits."""
    rows = 112 if -(-M // 112) == -(-M // 128) else 128
    if C * -(-K // bk) * -(-M // rows) * -(-N // B2_BN) < B2_FILL:
        rows = 32
    return rows


# kernel B3's GEMM tile rows by column tile: a thread owns 8 columns
# either way, so a 32-column tile takes twice the rows
B3_ROWS = {32: 256, 64: 128}


def b3_plan(N: int) -> int:
    """The column tile of kernel B3's GEMM pass for N output columns: the
    one that pads N less (32 or 64, 64 on a tie: conv2's N = 32 takes 32);
    its rows are B3_ROWS's. Either tile gives the bits of B2t over the
    patch rows."""
    return 32 if -(-N // 32) * 32 < -(-N // 64) * 64 else 64


def _strides(t: torch.Tensor):
    """Element strides (lane, row, column); a tensor without the lane
    axis is shared by every lane (stride 0)."""
    st = t.stride()
    return _STRIDES(*((0,) + st if t.dim() < 3 else st))


def _operand_args(x, w, broken, stuck, eps, x_strides=None):
    """Kernel B2/B2t/B3's operand arguments: each pointer with its strides
    (`x_strides` where x is not a (C, M, K) view; broken as one byte a
    cell: bool or uint8, an f32 0/1 mask cast once), and the byte mask,
    which the caller keeps alive through the call."""
    if broken.dtype == torch.float32:
        broken = broken > 0
    args = [kernels.ptr(x), _strides(x) if x_strides is None else x_strides]
    for t in (w, broken, stuck):
        args += [kernels.ptr(t), _strides(t)]
    if eps is None:
        return args + [ctypes.c_void_p(None), _STRIDES(0, 0, 1)], broken
    return args + [kernels.ptr(eps), _strides(eps)], broken


def _launch_b2(x, w, broken, stuck, seeds, sigma, q_bits, eps):
    """One call of kernel B2 on operands as they are stored; returns
    (out, the lanes' max |w| the call reduced, or None at q_bits 0).
    Scratch from here: the scales and the split-K tile counters, and the
    split-K partials (C, splits, M, N)."""
    C, K, N = w.shape
    M = x.shape[-2]
    levels = q_levels(q_bits)
    bm, splits = b2_plan(max(C, getattr(_PLAN, "lanes", 0)), M, K, N)
    if C * splits >= 2 ** 31 or -(-M // bm) > 65535 or -(-N // B2_BN) > 65535:
        raise ValueError(f"crossbar: shape C,M,K,N = {(C, M, K, N)} exceeds "
                         "the kernel grid")
    operands, broken = _operand_args(x, w, broken, stuck, eps)
    seeds = seeds.to(torch.int32).contiguous()
    dev = w.device
    tiles = C * -(-M // bm) * -(-N // B2_BN)
    scratch = torch.empty(C + tiles, dtype=torch.float32, device=dev)
    part = (torch.empty((C, splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    out = torch.empty((C, M, N), dtype=torch.float32, device=dev)
    CROSSBAR_LIB.call(
        "rram_crossbar_forward", *operands, kernels.ptr(seeds), float(sigma),
        levels, C, M, K, N, bm, splits, kernels.ptr(scratch),
        kernels.ptr(part) if part is not None else ctypes.c_void_p(None),
        kernels.ptr(out), kernels.stream_ptr(dev))
    return out, (scratch[:C] if levels else None)


def _launch_b2t(x, w, broken, stuck, seeds, sigma, q_bits, eps, tiles,
                bm=None):
    """One call of kernel B2t on operands as they are stored, its tile
    rows from `b2t_plan` (`bm`: others, for timing them against each
    other). Scratch from here: the scales, the tiles' maxima and the
    K-tile partials (C, gk, M, N)."""
    C, K, N = w.shape
    M = x.shape[-2]
    bk, bn, adc_bits = _check_tiles(tiles)
    bm = bm or b2t_plan(C, M, K, N, bk)
    gk, gn, cols = -(-K // bk), -(-N // bn), -(-N // B2_BN)
    if C * gk >= 2 ** 31 or -(-M // bm) > 65535 or cols > 65535:
        raise ValueError(f"crossbar: shape C,M,K,N = {(C, M, K, N)} with "
                         f"tiles {tuple(tiles)} exceeds the kernel grid")
    operands, broken = _operand_args(x, w, broken, stuck, eps)
    seeds = seeds.to(torch.int32).contiguous()
    dev = w.device
    scratch = torch.empty(C + C * gk * gn, dtype=torch.float32, device=dev)
    part = torch.empty((C, gk, M, N), dtype=torch.float32, device=dev)
    out = torch.empty((C, M, N), dtype=torch.float32, device=dev)
    CROSSBAR_LIB.call(
        "rram_crossbar_tiled_forward", *operands, kernels.ptr(seeds),
        float(sigma), q_levels(q_bits), q_levels(adc_bits), C, M, K, N, bk,
        bn, bm, kernels.ptr(scratch), kernels.ptr(part), kernels.ptr(out),
        kernels.stream_ptr(dev))
    return out


def _launch_b3(x, w, broken, stuck, seeds, sigma, q_bits, eps, tiles, geom):
    """One call of kernel B3 on w, broken, stuck as stored and x padded
    by `pad_activation_flat` (its one copy), its GEMM tile from `b3_plan`.
    Scratch from here: the scales and the tiles' maxima, W_eff (C, K, N),
    the K-tile partials (C, gk, M, N)."""
    C, K, N = w.shape
    rb, co, M, Kp = implicit_plan(x.shape[-4:], geom, w.device)
    if Kp != K:
        raise ValueError(f"crossbar conv: the plan's K {Kp} != w's {K}")
    bk, bn, adc_bits = _check_tiles(tiles)
    tile_n = b3_plan(N)
    gk, gn = -(-K // bk), -(-N // bn)
    if (C * gk >= 2 ** 31 or -(-M // B3_ROWS[tile_n]) > 65535
            or -(-N // tile_n) > 65535):
        raise ValueError(f"crossbar conv: shape C,M,K,N = {(C, M, K, N)} "
                         f"with tiles {tuple(tiles)} exceeds the kernel grid")
    xflat = pad_activation_flat(x, geom)
    if xflat.stride(-1) != 1:
        xflat = xflat.contiguous()
    x_strides = _STRIDES(xflat.stride(0) if x.dim() == 5 else 0, 0, 1)
    operands, broken = _operand_args(xflat, w, broken, stuck, eps, x_strides)
    seeds = seeds.to(torch.int32).contiguous()
    dev = w.device
    scratch = torch.empty(C + C * gk * gn, dtype=torch.float32, device=dev)
    weff = torch.empty((C, K, N), dtype=torch.float32, device=dev)
    part = torch.empty((C, gk, M, N), dtype=torch.float32, device=dev)
    out = torch.empty((C, M, N), dtype=torch.float32, device=dev)
    CROSSBAR_LIB.call(
        "rram_crossbar_implicit_forward", *operands, kernels.ptr(seeds),
        float(sigma), q_levels(q_bits), q_levels(adc_bits), kernels.ptr(rb),
        kernels.ptr(co), C, M, K, N, bk, bn, tile_n,
        kernels.ptr(scratch), kernels.ptr(weff), kernels.ptr(part),
        kernels.ptr(out), kernels.stream_ptr(dev))
    return out


def crossbar_forward_scaled(x, w, broken, stuck, seeds, sigma: float,
                            q_bits: int = 0, eps=None):
    """`crossbar_forward` (untiled) and the lanes' quantization scales
    max |w_c| (C,) that the read used (None at q_bits 0): on CUDA tensors
    both come out of one call of kernel B2, on CPU tensors from the
    plain version."""
    seeds = torch.as_tensor(seeds, device=w.device)
    _check_crossbar(x, w, broken, stuck, seeds, eps)
    if not w.is_cuda:
        return (crossbar_forward_plain(x, w, broken, stuck, seeds, sigma,
                                       q_bits, eps),
                _lane_scale(w, q_levels(q_bits)))
    _one_device([x, w, broken, stuck] + ([eps] if eps is not None else []))
    return _launch_b2(x, w, broken, stuck, seeds, sigma, q_bits, eps)


def crossbar_forward(x, w, broken, stuck, seeds, sigma: float,
                     q_bits: int = 0, eps=None, tiles=None) -> torch.Tensor:
    """(C, M, N) crossbar reads of C config lanes. On CUDA tensors this
    launches kernel B2, or B2t with `tiles` = (bk, bn, adc_bits); on CPU
    tensors it runs the plain version.

    x (M, K) shared by every lane or (C, M, K); w, stuck (C, K, N) f32;
    broken (C, K, N) bool, uint8 or f32 0/1. B2 and B2t take them in any
    strides and copy nothing (fastest where the contiguous axis has
    stride 1 and rows start 16-byte aligned: dense (C, K, N), a
    transposed view of Caffe's (C, num_output, K), the (M, C, K) view of
    a laned activation); an f32 broken is cast to one byte a cell."""
    if tiles is None:
        return crossbar_forward_scaled(x, w, broken, stuck, seeds, sigma,
                                       q_bits, eps)[0]
    seeds = torch.as_tensor(seeds, device=w.device)
    _check_crossbar(x, w, broken, stuck, seeds, eps)
    tiles = _check_tiles(tiles)
    if not w.is_cuda:
        return crossbar_forward_plain(x, w, broken, stuck, seeds, sigma,
                                      q_bits, eps, tiles)
    _one_device([x, w, broken, stuck] + ([eps] if eps is not None else []))
    return _launch_b2t(x, w, broken, stuck, seeds, sigma, q_bits, eps, tiles)


class CrossbarMatmul(torch.autograd.Function):
    """C config lanes' crossbar reads in one launch of kernel B2 (B2t with
    `tiles`), with
    the reference's straight-through backward (`_cm_bwd`) per lane as
    batched products: dx against the clean masked weights (on the
    lane's quantization grid when q_bits is set), dw zeroed on broken
    cells (the reference has no backward kernel either)."""

    @staticmethod
    def forward(ctx, x, w, broken, stuck, seeds, sigma, q_bits, use_kernel,
                tiles):
        # no copy here: B2 and B2t read the views as they are stored
        fwd = crossbar_forward if use_kernel else crossbar_forward_plain
        y = fwd(x, w, broken, stuck, seeds, sigma, q_bits, tiles=tiles)
        ctx.save_for_backward(x, w, broken, stuck)
        ctx.q_bits = q_bits
        return y

    @staticmethod
    def backward(ctx, g):
        # the per-tile ADC is a forward-only read effect: the backward is
        # the untiled one (the reference's _cm_bwd)
        x, w, broken, stuck = ctx.saved_tensors
        dx, dw = _masked_backward(g, x, w, broken, stuck, ctx.q_bits,
                                  ctx.needs_input_grad[:2])
        return dx, dw, None, None, None, None, None, None, None


def _masked_backward(g, x, w, broken, stuck, q_bits, needs):
    """`_cm_bwd` per lane: dx = g @ w_masked^T against the clean masked
    weights (on the lane's grid when q_bits is set; summed over lanes
    when x is shared), dw = x^T @ g zeroed on broken cells."""
    wv = w
    if q_bits:
        # dx flows through the values the forward used: each lane's
        # grid weights; dw stays straight-through to the masters
        wv = quantize_tile(w, lane_max_abs(w, lanes=1), q_levels(q_bits))
    brk = broken.to(torch.bool)
    w_masked = torch.where(brk, stuck.to(w.dtype), wv)
    dx = dw = None
    if needs[0]:
        dx = torch.matmul(g, w_masked.transpose(1, 2))
        if x.dim() == 2:            # x shared by every lane
            dx = dx.sum(0)
    if needs[1]:
        dw = torch.where(brk, torch.zeros((), dtype=g.dtype,
                                           device=g.device),
                         torch.matmul(x.transpose(-2, -1), g))
    return dx, dw


def crossbar_matmul_lanes(x, w, broken, stuck, seeds, sigma: float,
                          q_bits: int = 0, use_kernel: bool = True,
                          tiles=None):
    """y_c = x_c @ where(broken_c, stuck_c, quantize_c(w_c) * (1 +
    sigma*eps_c)) for C config lanes, one kernel launch whatever C is;
    with `tiles` = (bk, bn, adc_bits) the tiled read (kernel B2t).

    x (M, K) shared by every lane or (C, M, K); w, stuck (C, K, N) f32;
    broken (C, K, N) bool or 0/1, all as views in any strides (see
    `crossbar_forward`); seeds (C,) int32 (on w's device, so the launch
    waits for no host copy). Returns (C, M, N)."""
    tiles = None if tiles is None else tuple(int(v) for v in tiles)
    return CrossbarMatmul.apply(x, w, broken, stuck, seeds, float(sigma),
                                int(q_bits), bool(use_kernel), tiles)


def crossbar_matmul(x, w, broken, stuck, seed: int, sigma: float,
                    q_bits: int = 0, use_kernel: bool = True, tiles=None):
    """y = x @ where(broken, stuck, quantize(w) * (1 + sigma*eps)): one
    config's read, the one-lane case of `crossbar_matmul_lanes`.

    x (M, K) f32; w (K, N) f32; broken (K, N) bool or 0/1; stuck (K, N);
    seed an int; sigma, q_bits as in the reference; tiles (bk, bn,
    adc_bits) or None. `use_kernel` routes the forward through the
    kernel wrapper (kernel B2/B2t on CUDA tensors) or straight to the
    plain version."""
    seeds = torch.tensor([int(seed)], dtype=torch.int32, device=w.device)
    return crossbar_matmul_lanes(x, w[None], broken[None], stuck[None],
                                 seeds, sigma, q_bits, use_kernel, tiles)[0]


# ---------------------------------------------------------------------------
# the tiled read's plain version, and the conv operand

def adc_read(part: torch.Tensor, adc_bits: int) -> torch.Tensor:
    """One tile's partial product through its own ADC (`_adc_read`):
    quantize_ste with the max |part| over its last two axes (all M rows,
    the tile's columns), per leading index (a config lane)."""
    if not adc_bits:
        return part
    amax = part.detach().abs().amax(dim=(-2, -1), keepdim=True)
    q = quantize_tile(part.detach(), amax, q_levels(adc_bits))
    return part + (q - part.detach())


# Kernel B2t's and B3's k order (csrc/crossbar.cu `crossbar_kernel`): a
# K-tile runs in stages of KSTAGE k from its first k, the last stage cut
# at the tile's edge; two groups of threads each carry one fmaf chain per
# output across the stages, group 0 over the first KGROUP k of every
# stage and group 1 over the last; the tile's partial is group 0's sum +
# group 1's.
KSTAGE, KGROUP = 32, 16
# elements of one chain step of the ordered twin (its temporaries are
# float64 and int64 of this size: the memory per M-chunk)
ORDERED_ELEMS = 1 << 25
_LOW29, _HALF29 = (1 << 29) - 1, 1 << 28     # f64 bits below f32's 24
_NO_SUBNORMAL = 2.0 ** -40


def fma_f32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """The correctly rounded float32 acc + a * b, CUDA's fmaf: acc float32,
    a and b float64 holding float32 values (their product is exact).
    The float64 sum is rounded once more to float32, which is the correct
    rounding unless the sum lies exactly on a float32 midpoint (its 29
    low mantissa bits 100...0); a step with such a sum is taken again
    through `prng.fma` (TwoSum's error, round to odd), which is exact
    everywhere. Sums in float32's subnormal range are not detected here:
    the caller takes `prng.fma` for every step where they can occur."""
    s = torch.addcmul(acc, a, b)
    if ((s.view(torch.int64) & _LOW29) == _HALF29).any():
        return prng.fma(a, b, acc)
    return s.float()


def _subnormal_free(*ts) -> bool:
    """Whether every nonzero value is at least 2^-40 in magnitude: then
    every product is a multiple of 2^-126, and so is every sum of them
    in any rounding, so no chain value is a float32 subnormal."""
    return not any(bool(((t.abs() < _NO_SUBNORMAL) & (t != 0)).any())
                   for t in ts)


def _k_tiles(t: torch.Tensor, axis: int, bk: int, gk: int, depth: int):
    """`t` with its K axis (`axis`, counted from the end) cut into gk
    tiles of bk, each zero-padded to `depth` k: (..., gk, depth, ...)."""
    K = t.shape[axis]
    pad = [0, 0] * (-axis - 1)
    t = F.pad(t, pad + [0, gk * bk - K]).unflatten(axis, (gk, bk))
    return F.pad(t, pad + [0, depth - bk])


def ordered_tile_partials(x: torch.Tensor, w: torch.Tensor,
                          bk: int) -> torch.Tensor:
    """(..., gk, M, N) raw partials x[..., kt] @ w[..., kt, :] of the
    K-tiles of bk, each output summed in kernel B2t's and B3's order
    (KSTAGE, KGROUP): per group a chain of correctly rounded float32
    fused multiply-adds (`fma_f32`), then group 0's + group 1's in
    float32. x (..., M, K), w (..., K, N) float32, leading axes
    broadcast. Vectorised over rows, columns, tiles, groups and lanes;
    only the k steps of a group (depth / 2 of them) run in sequence,
    over chunks of rows of ORDERED_ELEMS elements. Zero padding may turn
    a -0 into +0 (equal values)."""
    bk = int(bk)
    K, M, N = x.shape[-1], x.shape[-2], w.shape[-1]
    gk = -(-K // bk)
    depth = -(-bk // KSTAGE) * KSTAGE
    stages = depth // KSTAGE
    lead = torch.broadcast_shapes(x.shape[:-2], w.shape[:-2])
    exact_fma = not _subnormal_free(x, w)
    # w as (..., stage, k of the group, K-tile, group, 1, N)
    wt = _k_tiles(w, -2, bk, gk, depth).unflatten(-2, (stages, 2, KGROUP))
    wt = wt.movedim((-4, -2, -5, -3), (-5, -4, -3, -2)).double()
    wt = wt.unsqueeze(-2)
    out = torch.empty(lead + (gk, M, N), dtype=torch.float32,
                      device=x.device)
    rows = max(1, ORDERED_ELEMS // max(1, lead.numel() * gk * 2 * N))
    for m0 in range(0, M, rows):
        m1 = min(m0 + rows, M)
        # x's rows as (..., stage, k of the group, K-tile, group, rows, 1)
        xt = _k_tiles(x[..., m0:m1, :], -1, bk, gk, depth).unflatten(
            -1, (stages, 2, KGROUP))
        xt = xt.movedim((-3, -1, -4, -2, -5), (-5, -4, -3, -2, -1))
        xt = xt.double().unsqueeze(-1)
        acc = torch.zeros(lead + (gk, 2, m1 - m0, N), dtype=torch.float32,
                          device=x.device)
        for s in range(stages):
            for i in range(KGROUP):
                a, b = xt[..., s, i, :, :, :, :], wt[..., s, i, :, :, :, :]
                acc = (prng.fma(a, b, acc) if exact_fma
                       else fma_f32(acc, a, b))
        out[..., m0:m1, :] = acc[..., 0, :, :] + acc[..., 1, :, :]
    return out


def matmul_tile_partials(x: torch.Tensor, w: torch.Tensor,
                         bk: int) -> torch.Tensor:
    """The same (..., gk, M, N) partials as `torch.matmul` products."""
    K = x.shape[-1]
    return torch.stack([torch.matmul(x[..., k0:k0 + bk],
                                     w[..., k0:k0 + bk, :])
                        for k0 in range(0, K, int(bk))], dim=-3)


class OrderedPartials(torch.autograd.Function):
    """`ordered_tile_partials` forward; the backward is the gradient of
    `matmul_tile_partials` (autograd's own, through the products)."""

    @staticmethod
    def forward(ctx, x, w, bk):
        ctx.save_for_backward(x, w)
        ctx.bk = bk
        return ordered_tile_partials(x, w, bk)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xr = x.detach().requires_grad_(need[0])
            wr = w.detach().requires_grad_(need[1])
            parts = matmul_tile_partials(xr, wr, ctx.bk)
        grads = iter(torch.autograd.grad(
            parts, [t for t, n in zip((xr, wr), need) if n], g))
        return (next(grads) if need[0] else None,
                next(grads) if need[1] else None, None)


def _ordered_k_tiles(x_slab, w_eff, bk: int):
    """Each K-tile's (..., M, N) raw partial in the kernels' k order
    (`OrderedPartials`), in ascending K-tile order. The K-tiles are taken
    together in groups whose operand slab holds at most ORDERED_ELEMS
    elements, so the operand is never built whole beyond that."""
    K = w_eff.shape[-2]
    group = max(1, ORDERED_ELEMS // max(1, x_slab(0, min(bk, K)).numel()))
    for k0 in range(0, K, group * bk):
        k1 = min(k0 + group * bk, K)
        yield from OrderedPartials.apply(x_slab(k0, k1),
                                         w_eff[..., k0:k1, :], bk).unbind(-3)


def tiled_crossbar_matmul_slabs(x_slab, w_eff, bk: int, bn: int,
                                adc_bits: int, kernel_order: bool = False):
    """The tiled read with a lazy operand: `x_slab(k0, k1)` gives the
    (..., M, k1-k0) columns [k0, k1) of the conceptual (..., M, K)
    operand. y[..., jt] = sum over kt, ascending, of adc_read(slab_kt @
    w_eff[kt, jt]). w_eff (K, N) or (C, K, N); differentiable
    (adc_read's straight-through identity).

    Each tile's raw partial slab_kt @ w_eff[kt, jt] is a `torch.matmul`
    product, or with `kernel_order` summed in kernel B2t's and B3's k
    order (`ordered_tile_partials`), so that the read gives the kernels'
    bits, ADC levels included. Only the kernels' plain versions ask for
    that order, and only on the card: it runs one float64 pass per k
    step, where the matmul form is one library call per tile."""
    bk, bn = int(bk), int(bn)
    K, N = w_eff.shape[-2:]
    ordered = _ordered_k_tiles(x_slab, w_eff, bk) if kernel_order else None
    accs = [None] * len(range(0, N, bn))
    for k0 in range(0, K, bk):
        k1 = min(k0 + bk, K)
        if ordered is None:
            slab = x_slab(k0, k1)
        else:
            tile = next(ordered)
        for j, n0 in enumerate(range(0, N, bn)):
            raw = (torch.matmul(slab, w_eff[..., k0:k1, n0:n0 + bn])
                   if ordered is None else tile[..., n0:n0 + bn])
            part = adc_read(raw, adc_bits)
            accs[j] = part if accs[j] is None else accs[j] + part
    return accs[0] if len(accs) == 1 else torch.cat(accs, dim=-1)


def tiled_crossbar_matmul(x, w_eff, bk: int, bn: int, adc_bits: int,
                          kernel_order: bool = False):
    """The tiled crossbar read over an already effective weight
    (`tiled_crossbar_matmul` of the reference): each (bk x bn) block of
    w_eff is one crossbar tile whose partial product passes its own
    adc_bits ADC before the sum over K-tiles. x (..., M, K);
    `kernel_order` as in `tiled_crossbar_matmul_slabs`."""
    return tiled_crossbar_matmul_slabs(
        lambda k0, k1: x[..., k0:k1].contiguous(), w_eff, bk, bn, adc_bits,
        kernel_order)


def reference_crossbar_matmul(x, w, broken, stuck, key, sigma: float,
                              q_bits: int = 0, tiles=None):
    """The read in the reference's pure spelling (`quantize_ste`, then
    `perturb_weight` with the threefry `key`, then the plain or tiled
    product): equal to the kernels' at sigma = 0; at sigma > 0 its noise
    is the key's normal draw, where the kernels draw Philox from a seed."""
    wq = quantize_ste(w, q_bits) if q_bits else w
    w_eff = perturb_weight(wq, broken, stuck, key, sigma)
    if tiles is not None:
        return tiled_crossbar_matmul(x, w_eff, *tiles)
    return x @ w_eff


_PLANS = {}      # (x shape, geom, device) -> the plan on that device


def implicit_plan(x_shape, geom, device):
    """(row_base, col_off, M, K) of `mapping.im2col_index_plan`, the two
    int32 vectors on `device`, made once per shape and geometry."""
    key = (tuple(int(d) for d in x_shape), tuple(geom), str(device))
    if key not in _PLANS:
        rb, co, m, k, _ = im2col_index_plan(x_shape, geom)
        _PLANS[key] = (torch.from_numpy(rb).to(device),
                       torch.from_numpy(co).to(device), m, k)
    return _PLANS[key]


CONV_OPERANDS = ("premat", "tilewise", "implicit")


def conv_operand_slabs(x, geom, operand: str):
    """slab(k0, k1) -> the (..., M, k1-k0) columns of a conv's im2col
    operand, x (N, ch, H, W) or (C, N, ch, H, W). "premat" cuts them from
    the patch rows built once; "tilewise" extracts the channels covering
    [k0, k1) per call; "implicit" gathers them from the padded flat
    activation through the address plan. All three are exact gathers,
    so the slabs are equal byte for byte."""
    if operand == "premat":
        rows = conv_patch_rows(x, geom)
        return lambda k0, k1: rows[..., k0:k1].contiguous()
    if operand == "tilewise":
        khw = geom[0] * geom[1]

        def slab(k0, k1):
            ch0, ch1 = k0 // khw, -(-k1 // khw)
            rows = conv_patch_rows(x[..., ch0:ch1, :, :], geom)
            return rows[..., k0 - ch0 * khw:k1 - ch0 * khw].contiguous()
        return slab
    if operand == "implicit":
        rb, co, _, _ = implicit_plan(x.shape[-4:], geom, x.device)
        xflat = pad_activation_flat(x, geom)
        rb = rb.long()[:, None]
        co = co.long()
        return lambda k0, k1: xflat[..., rb + co[None, k0:k1]]
    raise ValueError(f"conv_im2col={operand!r}: expected one of "
                     f"{CONV_OPERANDS}")


def crossbar_conv_forward_plain(x, w, broken, stuck, seeds, sigma: float,
                                q_bits: int, tiles, geom, eps=None,
                                operand: str = "implicit"):
    """The plain PyTorch version of kernel B3: the lanes' w_eff, then the
    tiled read over the conv operand slabs (`conv_operand_slabs`). x
    (N, ch, H, W) shared or (C, N, ch, H, W); w, broken, stuck (C, K, N)
    im2col views. Returns (C, M, N). On CUDA tensors each tile sums in
    B3's k order."""
    # a dense w_eff, so the product's order does not depend on the layout
    w_eff = _lane_w_eff(w, broken, stuck, seeds, sigma, q_bits,
                        eps).contiguous()
    return tiled_crossbar_matmul_slabs(conv_operand_slabs(x, geom, operand),
                                       w_eff, *tiles,
                                       kernel_order=w_eff.is_cuda)


def crossbar_conv_forward(x, w, broken, stuck, seeds, sigma: float,
                          q_bits: int, tiles, geom, eps=None):
    """(C, M, N) tiled crossbar reads of a conv, its operand gathered
    from the raw activation x ((N, ch, H, W) shared or (C, N, ch, H, W)
    per lane) under the conv geometry `geom`. On CUDA tensors this
    launches kernel B3, which takes w, broken (bool, uint8 or f32 0/1),
    stuck and eps in any strides (the `to_im2col` view of Caffe's stored
    weight in place) and x as any view; on CPU tensors it runs the plain
    version."""
    seeds = torch.as_tensor(seeds, device=w.device)
    _check_crossbar(x, w, broken, stuck, seeds, eps, conv=True)
    tiles = _check_tiles(tiles)
    if not w.is_cuda:
        return crossbar_conv_forward_plain(x, w, broken, stuck, seeds, sigma,
                                           q_bits, tiles, geom, eps)
    _one_device([x, w, broken, stuck] + ([eps] if eps is not None else []))
    return _launch_b3(x, w, broken, stuck, seeds, sigma, q_bits, eps, tiles,
                      geom)


class CrossbarConvMatmul(torch.autograd.Function):
    """C config lanes' tiled crossbar reads of a convolution in one
    launch of kernel B3 (or the plain version over the "implicit" or
    "tilewise" operand), with the reference's `_ccm_bwd`: the patch rows
    are built here, dx flows back through their extraction (F.unfold's
    backward, exactly as the premat path's), dw = rows^T @ g with
    broken cells zeroed."""

    @staticmethod
    def forward(ctx, x, w, broken, stuck, seeds, sigma, q_bits, tiles, geom,
                use_kernel, operand):
        if use_kernel:          # no copy here: B3 reads them as stored
            y = crossbar_conv_forward(x, w, broken, stuck, seeds, sigma,
                                      q_bits, tiles, geom)
        else:
            y = crossbar_conv_forward_plain(
                x.contiguous(), w.contiguous(),
                broken.to(torch.float32).contiguous(),
                stuck.to(torch.float32).contiguous(), seeds, sigma, q_bits,
                tiles, geom, operand=operand)
        ctx.save_for_backward(x, w, broken, stuck)
        ctx.q_bits, ctx.geom = q_bits, geom
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, broken, stuck = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            rows = conv_patch_rows(xr, ctx.geom)
        # rows, not rows.detach(): torch.matmul picks its algorithm by
        # the operands' requires_grad, and the premat path's saved rows
        # require grad; so dw sums in the premat path's order
        dxm, dw = _masked_backward(g, rows, w, broken, stuck, ctx.q_bits,
                                   ctx.needs_input_grad[:2])
        dx = None
        if dxm is not None:
            (dx,) = torch.autograd.grad(rows, xr, dxm)
        return dx, dw, None, None, None, None, None, None, None, None, None


def crossbar_conv_matmul_lanes(x, w, broken, stuck, seeds, sigma: float,
                               q_bits: int, tiles, geom,
                               use_kernel: bool = True,
                               operand: str = "implicit"):
    """The tiled crossbar read of a convolution for C config lanes, its
    operand never materialized (kernel B3): x (N, ch, H, W) shared or
    (C, N, ch, H, W); w, stuck (C, K, N) im2col views, broken bool or
    0/1; seeds (C,) int32; tiles (bk, bn, adc_bits); geom
    `mapping.conv_geom`. Returns (C, N*OH*OW, N_out)."""
    if operand not in ("tilewise", "implicit"):
        raise ValueError(f"crossbar_conv_matmul: operand {operand!r} "
                         "(premat goes through crossbar_matmul)")
    if use_kernel and operand != "implicit":
        raise ValueError("crossbar_conv_matmul: kernel B3 gathers its "
                         f"operand implicitly; operand {operand!r} is a "
                         "plain-path mode (use_kernel=False)")
    return CrossbarConvMatmul.apply(
        x, w, broken, stuck, seeds, float(sigma), int(q_bits),
        tuple(int(v) for v in tiles), tuple(int(v) for v in geom),
        bool(use_kernel), operand)


def crossbar_conv_matmul(x, w, broken, stuck, seed: int, sigma: float,
                         q_bits: int, tiles, geom, use_kernel: bool = True,
                         operand: str = "implicit"):
    """One config's `crossbar_conv_matmul_lanes`: x (N, ch, H, W), w,
    broken, stuck (K, N_out). Returns (N*OH*OW, N_out)."""
    seeds = torch.tensor([int(seed)], dtype=torch.int32, device=w.device)
    return crossbar_conv_matmul_lanes(x, w[None], broken[None], stuck[None],
                                      seeds, sigma, q_bits, tiles, geom,
                                      use_kernel, operand)[0]
