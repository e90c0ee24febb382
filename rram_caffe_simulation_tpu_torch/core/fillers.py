"""Weight initializers ("fillers") with Caffe's semantics (counterpart
of the reference package's core/fillers.py; reference filler.hpp:31-290).
For a blob of shape (d0, d1, ...), fan_in = count / d0 and fan_out =
count / d1.

`fill(key, shape, device)` draws from a threefry key (core/prng.py) with
the reference's key use, so a seed gives the reference's values. A batch
of keys (..., 2) draws key.shape[:-1] + shape, one block per key, as
jax.vmap over the keys does (a filler that draws nothing returns shape).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import proto
from . import prng


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


def make_filler(f):
    """fill(key, shape, device="cpu") -> float32 tensor for a
    FillerParameter, drawn as the reference draws it: gaussian splits
    (kg, ks) and masks with bernoulli(ks) when sparse; uniform, xavier
    and positive_unitball are one uniform draw; msra is std * normal;
    constant and bilinear draw nothing."""
    ftype = f.type
    if ftype == "constant":
        def fill(key, shape, device="cpu"):
            return torch.full(shape, f.value, dtype=torch.float32,
                              device=device)
    elif ftype == "uniform":
        def fill(key, shape, device="cpu"):
            return prng.uniform(key, shape, f.min, f.max, device)
    elif ftype == "gaussian":
        def fill(key, shape, device="cpu"):
            ks = prng.split(key)
            kg, ks = ks[..., 0, :], ks[..., 1, :]
            x = prng.normal(kg, shape, device) * _f32(f.std) + _f32(f.mean)
            if f.sparse >= 0:
                # Bernoulli mask with p = sparse / fan_in keeps about
                # `sparse` nonzeros per output (filler.hpp:92-117)
                fan_in, _ = _fans(shape)
                p = min(1.0, f.sparse / max(fan_in, 1.0))
                x = torch.where(prng.bernoulli(ks, p, shape, device), x, 0.0)
            return x
    elif ftype == "positive_unitball":
        def fill(key, shape, device="cpu"):
            # one uniform draw, each row (the fan-in of an output)
            # divided by its sum (filler.hpp:160-180)
            x = prng.uniform(key, shape, 0.0, 1.0, device)
            flat = x.reshape(x.shape[:x.dim() - len(shape)]
                             + (shape[0], -1))
            return (flat / flat.sum(-1, keepdim=True)).reshape(x.shape)
    elif ftype == "xavier":
        def fill(key, shape, device="cpu"):
            scale = math.sqrt(3.0 / _scale_n(f, *_fans(shape)))
            return prng.uniform(key, shape, -scale, scale, device)
    elif ftype == "msra":
        def fill(key, shape, device="cpu"):
            std = math.sqrt(2.0 / _scale_n(f, *_fans(shape)))
            return prng.normal(key, shape, device) * _f32(std)
    elif ftype == "bilinear":
        def fill(key, shape, device="cpu"):
            # the deterministic upsampling kernel (filler.hpp:213-246) in
            # float64, rounded once; a 4-D blob with square planes
            if len(shape) != 4 or shape[2] != shape[3]:
                raise ValueError("the bilinear filler needs a 4-D blob "
                                 f"with square planes, got {tuple(shape)}")
            k = shape[3]
            fac = (k + 1) // 2
            center = fac - 1.0 if k % 2 == 1 else fac - 0.5
            w1d = 1.0 - np.abs(np.arange(k, dtype=np.float64) - center) / fac
            w2d = torch.from_numpy(np.outer(w1d, w1d).astype(np.float32))
            return w2d.to(device).expand(tuple(shape)).contiguous()
    else:
        raise ValueError(f"Unknown filler type: {ftype!r}")
    return fill


def _f32(x) -> float:
    return float(np.float32(x))
