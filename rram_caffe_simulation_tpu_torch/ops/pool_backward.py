"""Max pooling with a hand-written backward, kernel B4
(csrc/pool_backward.cu; counterpart of the reference package's
ops/pool_backward.py).

`max_pool(x, kernel, stride, fpad)` pools NCHW planes over the
explicitly padded input, Caffe's CEIL geometry folded into `fpad` =
(w_lo, w_hi, h_lo, h_hi) and the padding at -inf, so a padded position
never wins against a real value. The forward is
`F.max_pool2d` (the reference's forward is `lax.reduce_window`, not a
kernel). The backward is chosen by RRAM_POOL_BWD, as in the reference:

- "auto" (default): autograd's own max-pool backward, the counterpart
  of the reference's auto -> XLA;
- "cuda": kernel B4 through `max_pool_backward` (raises if it cannot
  launch on a CUDA tensor; on a CPU tensor the wrapper runs the plain
  version);
- "torch": the plain version, `max_pool_backward_plain`, by name.

Each window's cotangent goes to the first element (row-major window
order) attaining the window max; overlapping windows add into a shared
element in ascending window-offset order, the reference kernel's order,
so kernel and plain version agree bit for bit and the reference's
interpret-mode kernel is matched exactly on finite inputs.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from .. import kernels

POOL_BWD_ENGINES = ("auto", "cuda", "torch")

_VP = ctypes.c_void_p
POOL_BWD_LIB = kernels.CudaLibrary(
    "pool_backward.cu",
    {"rram_max_pool_backward": [_VP] * 3 + [ctypes.c_longlong]
     + [ctypes.c_int] * 19 + [_VP]})

# Shared memory a block of kernel B4 may take: its ring of two stages of
# x and g. Its 128 registers a thread let two blocks share an SM; at
# pool1, 64 KB tiles (6 planes) ran slower than 96 KB (8), and more
# planes a tile would pass B4_WINDOWS.
B4_SMEM = 96 * 1024
B4_WINDOWS = 256 * 8     # windows a tile: 8 for each of a block's threads

B4Plan = collections.namedtuple(
    "B4Plan", "planes rows cols x_rows x_pitch win_rows win_cols g_pitch "
    "smem")
B4Plan.__doc__ = """Kernel B4's tile: `planes` whole planes, or (planes 1)
a band of `rows` x `cols` input elements of one plane; the largest x
region a band reads (`x_rows`, stored at row pitch `x_pitch`) and the
most windows it holds (`win_rows` x `win_cols`, g stored at `g_pitch`);
`smem` the block's shared-memory bytes."""


def pool_bwd_engine() -> str:
    eng = os.environ.get("RRAM_POOL_BWD", "auto")
    if eng not in POOL_BWD_ENGINES:
        raise ValueError(f"RRAM_POOL_BWD={eng!r}: expected one of "
                         f"{POOL_BWD_ENGINES}")
    return eng


def _forward(x, kernel, stride, fpad):
    return F.max_pool2d(F.pad(x, fpad, value=float("-inf")), kernel, stride)


def _offsets(kernel, stride, out_hw):
    """(lin, row slice, col slice) of every window offset, ascending:
    the slices pick offset (ki, kj) of each of the Ho x Wo windows in
    the padded frame."""
    (kh, kw), (sh, sw), (ho, wo) = kernel, stride, out_hw
    for lin in range(kh * kw):
        ki, kj = divmod(lin, kw)
        yield lin, slice(ki, ki + (ho - 1) * sh + 1, sh), \
            slice(kj, kj + (wo - 1) * sw + 1, sw)


def max_pool_backward_plain(x, g, kernel, stride, fpad):
    """The plain PyTorch version of kernel B4: dx of max pooling.
    x (..., H, W), g (..., Ho, Wo) f32."""
    H, W = x.shape[-2:]
    ho, wo = g.shape[-2:]
    xp = F.pad(x, fpad, value=float("-inf"))
    offs = list(_offsets(kernel, stride, (ho, wo)))
    windows = torch.stack([xp[..., r, c] for _, r, c in offs], dim=-1)
    first = torch.argmax(windows, dim=-1)          # first occurrence
    del windows
    dxp = torch.zeros_like(xp)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for lin, r, c in offs:
        # every element sits at offset `lin` of at most one window, so
        # each pass adds at most once per element: ascending offsets
        dxp[..., r, c] += torch.where(first == lin, g, zero)
    w_lo, _, h_lo, _ = fpad
    return dxp[..., h_lo:h_lo + H, w_lo:w_lo + W].contiguous()


def _check(x, g, kernel, stride, fpad):
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("max_pool_backward: x and g must be float32")
    if x.dim() < 2 or g.dim() != x.dim() or g.shape[:-2] != x.shape[:-2]:
        raise ValueError(f"max_pool_backward: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not pair")
    (kh, kw), (sh, sw) = kernel, stride
    if kh * kw > 256:
        raise ValueError(f"max_pool_backward: a {kh}x{kw} window has more "
                         "than 256 offsets, the most whose windows kernel "
                         "B4's smallest band (a row of four) holds")
    w_lo, w_hi, h_lo, h_hi = fpad
    H, W = x.shape[-2:]
    want = ((H + h_lo + h_hi - kh) // sh + 1,
            (W + w_lo + w_hi - kw) // sw + 1)
    if tuple(g.shape[-2:]) != want:
        raise ValueError(f"max_pool_backward: g spatial "
                         f"{tuple(g.shape[-2:])}, the geometry gives {want}")


def b4_band(lo, hi, n, k, s, p, n_out):
    """The windows [o_lo, o_hi] along one axis that hold an element of
    input range [lo, hi), and the input range [x_lo, x_hi) they read,
    clipped to [0, n) (the halo the band needs; kernel B4's `band`)."""
    o_lo = max(0, -(-(lo + p - k + 1) // s))
    o_hi = min(n_out - 1, (hi - 1 + p) // s)
    return o_lo, o_hi, max(0, o_lo * s - p), min(n, o_hi * s - p + k)


def b4_bands(n, band, k, s, p, n_out):
    """Each band of one axis as (lo, hi, o_lo, o_hi, x_lo, x_hi); an
    axis taken whole holds every window and reads all of it."""
    if band >= n:
        return [(0, n, 0, n_out - 1, 0, n)]
    return [(lo, min(n, lo + band)) + b4_band(lo, min(n, lo + band), n, k, s,
                                              p, n_out)
            for lo in range(0, n, band)]


def _round4(n):
    return -(-n // 4) * 4


def b4_smem(W, planes, rows, cols, x_rows, x_pitch, win_rows, g_pitch):
    """A block's shared memory (csrc/pool_backward.cu's layout): two
    mbarriers and two stages, each of x (or, once read, the band's dx at
    a pitch on W's 16-byte phase) and g, each with room for its phase."""
    dp = W if cols >= W else cols + (W - cols) % 4
    xf = _round4(planes * max(x_rows * x_pitch, rows * dp) + 3)
    gf = _round4(planes * win_rows * g_pitch + 3)
    return 16 + 2 * 4 * (xf + gf)


def _axis_max(n, band, k, s, p, n_out):
    """(most windows, largest x extent) of a band of an axis."""
    bands = b4_bands(n, band, k, s, p, n_out)
    return (max(max(0, b[3] - b[2] + 1) for b in bands),
            max(max(0, b[5] - b[4]) for b in bands))


def _layout(pt, bh, bw, H, W, Ho, Wo, kernel, stride, fpad):
    (kh, kw), (sh, sw) = kernel, stride
    w_lo, _, h_lo, _ = fpad
    wh, xh = _axis_max(H, bh, kh, sh, h_lo, Ho)
    ww, xw = _axis_max(W, bw, kw, sw, w_lo, Wo)
    # a banded row keeps the 16-byte phase of its source row
    xp = W if bw >= W else xw + (W - xw) % 4
    gp = Wo if bw >= W else ww + (Wo - ww) % 4
    bh, bw = min(bh, H), min(bw, W)
    return B4Plan(pt, bh, bw, xh, xp, wh, ww, gp,
                  b4_smem(W, pt, bh, bw, xh, xp, wh, gp))


@functools.lru_cache(maxsize=64)
def b4_plan(H, W, Ho, Wo, kernel, stride, fpad, budget=B4_SMEM):
    """Kernel B4's tile for a geometry: as many whole planes as fit
    `budget` bytes of shared memory and B4_WINDOWS windows; else the
    tallest band of whole rows that fits; else square-ish bands of rows
    and columns (columns in fours), down to one row of four. Each band's
    x region takes the halo of every window holding an element of it.
    Depends on the geometry alone; every plan gives the same bits."""
    geo = (H, W, Ho, Wo, tuple(kernel), tuple(stride), tuple(fpad))
    ok = lambda p: p.smem <= budget and p.planes * p.win_rows * p.win_cols \
        <= B4_WINDOWS
    if ok(_layout(1, H, W, *geo)):
        pt = 1
        while ok(_layout(pt + 1, H, W, *geo)):
            pt += 1
        return _layout(pt, H, W, *geo)
    fits = lambda bh, bw: ok(_layout(1, bh, bw, *geo))
    for bh in range(H - 1, 0, -1):
        if fits(bh, W):
            return _layout(1, bh, W, *geo)
    for side in range((W - 1) // 4 * 4, 3, -4):
        if fits(min(H, side), side):
            return _layout(1, min(H, side), side, *geo)
    return _layout(1, 1, min(W, 4), *geo)


def _launch_b4(x, g, kernel, stride, fpad, plan):
    """Kernel B4 on contiguous CUDA x and g under `plan`: dx, one launch."""
    H, W = x.shape[-2:]
    ho, wo = g.shape[-2:]
    dx = torch.empty_like(x)
    w_lo, _, h_lo, _ = fpad
    POOL_BWD_LIB.call(
        "rram_max_pool_backward", kernels.ptr(x), kernels.ptr(g),
        kernels.ptr(dx), x.numel() // (H * W) if H * W else 0, H, W, ho, wo,
        kernel[0], kernel[1], stride[0], stride[1], h_lo, w_lo, *plan,
        kernels.stream_ptr(x.device))
    return dx


def max_pool_backward(x, g, kernel, stride, fpad):
    """dx of max pooling. On CUDA tensors this launches kernel B4 once
    over every plane (one pass: x and g read once, dx written once,
    tiles per `b4_plan`); on CPU tensors it runs the plain version."""
    _check(x, g, kernel, stride, fpad)
    if not x.is_cuda:
        return max_pool_backward_plain(x, g, kernel, stride, fpad)
    if g.device != x.device:
        raise ValueError("max_pool_backward: x and g on different devices")
    x, g = x.contiguous(), g.contiguous()
    plan = b4_plan(*x.shape[-2:], *g.shape[-2:], tuple(kernel),
                   tuple(stride), tuple(fpad))
    return _launch_b4(x, g, kernel, stride, fpad, plan)


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, fpad, engine):
        ctx.save_for_backward(x)
        ctx.geometry = (kernel, stride, fpad)
        ctx.engine = engine
        return _forward(x, kernel, stride, fpad)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        fn = (max_pool_backward if ctx.engine == "cuda"
              else max_pool_backward_plain)
        return fn(x, g.contiguous(), *ctx.geometry), None, None, None, None


def max_pool(x, kernel, stride, fpad):
    """Max pooling of NCHW planes over the -inf-padded input; the
    backward per RRAM_POOL_BWD (read at each call)."""
    kernel, stride, fpad = tuple(kernel), tuple(stride), tuple(fpad)
    engine = pool_bwd_engine()
    if engine == "auto":
        return _forward(x, kernel, stride, fpad)
    return _MaxPool.apply(x, kernel, stride, fpad, engine)
