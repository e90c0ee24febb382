"""Shared shape/parameter helpers for layer implementations (a copy of
the reference package's ops/_util.py, which needs no JAX)."""
from __future__ import annotations

import math

import numpy as np


def conv_spatial_params(cp, num_spatial: int = 2):
    """Resolve kernel/stride/pad/dilation from a ConvolutionParameter.

    Mirrors BaseConvolutionLayer::LayerSetUp's handling of repeated fields vs
    the 2-D *_h/*_w overrides (reference base_conv_layer.cpp:17-110).
    """
    if cp.HasField("kernel_h") or cp.HasField("kernel_w"):
        kernel = (cp.kernel_h, cp.kernel_w)
    else:
        ks = list(cp.kernel_size)
        assert ks, "kernel_size required"
        kernel = tuple(ks[i] if len(ks) > 1 else ks[0] for i in range(num_spatial))
    if cp.HasField("stride_h") or cp.HasField("stride_w"):
        stride = (cp.stride_h, cp.stride_w)
    else:
        ss = list(cp.stride) or [1]
        stride = tuple(ss[i] if len(ss) > 1 else ss[0] for i in range(num_spatial))
    if cp.HasField("pad_h") or cp.HasField("pad_w"):
        pad = (cp.pad_h, cp.pad_w)
    else:
        ps = list(cp.pad) or [0]
        pad = tuple(ps[i] if len(ps) > 1 else ps[0] for i in range(num_spatial))
    ds = list(cp.dilation) or [1]
    dilation = tuple(ds[i] if len(ds) > 1 else ds[0] for i in range(num_spatial))
    return kernel, stride, pad, dilation


def pool_spatial_params(pp):
    """Resolve kernel/stride/pad for PoolingParameter (2-D only), honoring
    global_pooling (reference pooling_layer.cpp:38-90)."""
    if pp.HasField("kernel_h") or pp.HasField("kernel_w"):
        kernel = (pp.kernel_h, pp.kernel_w)
    elif pp.HasField("kernel_size"):
        kernel = (pp.kernel_size, pp.kernel_size)
    else:
        kernel = None  # global pooling fills this in from the bottom shape
    if pp.HasField("stride_h") or pp.HasField("stride_w"):
        stride = (pp.stride_h, pp.stride_w)
    else:
        stride = (pp.stride, pp.stride)
    if pp.HasField("pad_h") or pp.HasField("pad_w"):
        pad = (pp.pad_h, pp.pad_w)
    else:
        pad = (pp.pad, pp.pad)
    return kernel, stride, pad


def pooled_size(h: int, k: int, s: int, p: int) -> int:
    """Caffe pooled output size: CEIL division, clipped so the last window
    starts inside the image (reference pooling_layer.cpp:85-96)."""
    out = int(math.ceil((h + 2 * p - k) / float(s))) + 1
    if p > 0 and (out - 1) * s >= h + p:
        out -= 1
    return out


def ceil_pad_hi(h: int, k: int, s: int, p: int, out: int) -> int:
    """Right/bottom padding so floor-semantics windows produce `out` outputs
    with `p` low padding."""
    return max(0, (out - 1) * s + k - h - p)


def ave_pool_divisors(h: int, k: int, s: int, p: int, out: int) -> np.ndarray:
    """Per-output-position divisor for AVE pooling along one axis.

    Caffe divides by the window's intersection with the padded extent
    [−p, h+p): hstart = o*s − p is NOT clipped low, hend is clipped to h+p
    (reference pooling_layer.cpp:172-180).
    """
    o = np.arange(out)
    hstart = o * s - p
    hend = np.minimum(hstart + k, h + p)
    return (hend - hstart).astype(np.float64)


def flat_shape_from(shape, axis: int) -> tuple[int, int]:
    """Collapse shape into (outer, inner) at `axis` (Caffe count(0,axis) x
    count(axis))."""
    axis = axis % len(shape) if axis < 0 else axis
    outer = int(np.prod(shape[:axis])) if axis > 0 else 1
    inner = int(np.prod(shape[axis:])) if axis < len(shape) else 1
    return outer, inner
