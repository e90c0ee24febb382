"""Weight initializers ("fillers") with Caffe's semantics, drawn from a
`torch.Generator` (counterpart of the reference package's
core/fillers.py; reference filler.hpp:31-290). For a blob of shape
(d0, d1, ...), fan_in = count / d0 and fan_out = count / d1.

The draws are the port's own: the same seed gives other numbers than
the reference's threefry keys, so parity tests carry one init across
(convert.py) instead of drawing twice.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import proto


def _fans(shape) -> tuple:
    count = int(np.prod(shape))
    fan_in = count / shape[0] if len(shape) >= 1 else count
    fan_out = count / shape[1] if len(shape) >= 2 else count
    return fan_in, fan_out


def _scale_n(filler, fan_in: float, fan_out: float) -> float:
    if filler.variance_norm == proto.AVERAGE:
        return (fan_in + fan_out) / 2.0
    if filler.variance_norm == proto.FAN_OUT:
        return fan_out
    return fan_in


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def make_filler(f):
    """fill(gen, shape) -> float32 CPU tensor for a FillerParameter."""
    ftype = f.type
    if ftype == "constant":
        def fill(gen, shape):
            return torch.full(shape, f.value, dtype=torch.float32)
    elif ftype == "uniform":
        def fill(gen, shape):
            return _uniform(gen, shape, f.min, f.max)
    elif ftype == "gaussian":
        def fill(gen, shape):
            x = f.mean + f.std * torch.randn(shape, generator=gen)
            if f.sparse >= 0:
                # Bernoulli mask with p = sparse / fan_in keeps about
                # `sparse` nonzeros per output (filler.hpp:92-117)
                fan_in, _ = _fans(shape)
                p = min(1.0, f.sparse / max(fan_in, 1.0))
                x = torch.where(torch.rand(shape, generator=gen) < p, x,
                                torch.zeros(()))
            return x
    elif ftype == "xavier":
        def fill(gen, shape):
            scale = math.sqrt(3.0 / _scale_n(f, *_fans(shape)))
            return _uniform(gen, shape, -scale, scale)
    elif ftype == "msra":
        def fill(gen, shape):
            std = math.sqrt(2.0 / _scale_n(f, *_fans(shape)))
            return std * torch.randn(shape, generator=gen)
    else:
        raise ValueError(f"filler {ftype!r} is not ported (constant, "
                         "uniform, gaussian, xavier, msra are)")
    return fill
