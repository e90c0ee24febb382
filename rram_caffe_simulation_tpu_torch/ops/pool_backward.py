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

import ctypes
import os

import torch
import torch.nn.functional as F

from .. import kernels

POOL_BWD_ENGINES = ("auto", "cuda", "torch")

_VP = ctypes.c_void_p
POOL_BWD_LIB = kernels.CudaLibrary(
    "pool_backward.cu",
    {"rram_max_pool_backward": [_VP] * 4 + [ctypes.c_longlong]
     + [ctypes.c_int] * 10 + [_VP]})


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
                         "offsets than kernel B4's one-byte argmax holds")
    w_lo, w_hi, h_lo, h_hi = fpad
    H, W = x.shape[-2:]
    want = ((H + h_lo + h_hi - kh) // sh + 1,
            (W + w_lo + w_hi - kw) // sw + 1)
    if tuple(g.shape[-2:]) != want:
        raise ValueError(f"max_pool_backward: g spatial "
                         f"{tuple(g.shape[-2:])}, the geometry gives {want}")


def max_pool_backward(x, g, kernel, stride, fpad):
    """dx of max pooling. On CUDA tensors this launches kernel B4 once
    over every plane (its two passes, the window argmax into a byte of
    scratch per window, then the gather); on CPU tensors it runs the
    plain version."""
    _check(x, g, kernel, stride, fpad)
    if not x.is_cuda:
        return max_pool_backward_plain(x, g, kernel, stride, fpad)
    if g.device != x.device:
        raise ValueError("max_pool_backward: x and g on different devices")
    x, g = x.contiguous(), g.contiguous()
    H, W = x.shape[-2:]
    ho, wo = g.shape[-2:]
    planes = x.numel() // (H * W) if H * W else 0
    dx = torch.empty_like(x)
    arg = torch.empty(g.numel(), dtype=torch.uint8, device=x.device)
    w_lo, _, h_lo, _ = fpad
    POOL_BWD_LIB.call(
        "rram_max_pool_backward", kernels.ptr(x), kernels.ptr(g),
        kernels.ptr(dx), kernels.ptr(arg), planes, H, W, ho, wo, kernel[0],
        kernel[1], stride[0], stride[1], h_lo, w_lo,
        kernels.stream_ptr(x.device))
    return dx


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
