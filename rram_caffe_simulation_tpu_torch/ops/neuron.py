"""Elementwise neuron layers (counterpart of the reference package's
ops/neuron.py): ReLU, with Caffe's optional negative slope; Sigmoid and
TanH.

Sigmoid and TanH compute the reference's float32 expressions as XLA's
CPU backend evaluates them, from IEEE basic operations (core/prng.py's
`exp` and `fma`), so they give the same bits on the CPU and the card:
Sigmoid is 1 / (1 + exp(-x)) (`lax.logistic`), TanH XLA's rational
approximation (Eigen's fast tanh: x clamped to +-7.99881172, a degree-13
odd numerator over a degree-6 even denominator in x^2, Horner with fused
steps; x itself where |x| < 0.0004). Their backward passes are JAX's
rules as its transpose evaluates them eagerly: g * (y * (1 - y)), and
t + t * y with t = g * (1 - y) (the reference's jitted step may contract
the second into a fused multiply-add). A subnormal result flushes to a
signed zero, as XLA's CPU code runs with denormals off."""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from ..core.registry import Layer, register_layer

_TINY = float(np.finfo(np.float32).tiny)
_TANH_CLAMP = float(np.float32(7.99881172180175781))
_TANH_SMALL = 0.0004
_TANH_NUM = tuple(float(np.float32(c)) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(float(np.float32(c)) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))


def flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormal values to zero of their sign."""
    return torch.where(v.abs() < _TINY, v * 0.0, v)


def sigmoid_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 logistic: 1 / (1 + exp(-x))."""
    return flush(1.0 / (prng.exp(-x) + 1.0))


def tanh_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 tanh (its fast rational approximation)."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = prng.fma(x2, num, c)
    den = torch.full_like(x, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = prng.fma(x2, den, c)
    return torch.where(x.abs() < _TANH_SMALL, x, (xc * num) / den)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = sigmoid_xla(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return flush(g * (y * (1.0 - y)))


class _TanH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = tanh_xla(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        t = g * (1.0 - y)
        return flush(t + t * y)


class _Elementwise(Layer):
    lane_rule = "any"

    def setup(self, bottom_shapes):
        self.top_shapes = [tuple(bottom_shapes[0])]
        return self.top_shapes


@register_layer("ReLU")
class ReLULayer(_Elementwise):
    def setup(self, bottom_shapes):
        self.negative_slope = self.lp.relu_param.negative_slope
        return super().setup(bottom_shapes)

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        if self.negative_slope:
            return [torch.where(x > 0, x, self.negative_slope * x)]
        return [torch.relu(x)]


@register_layer("Sigmoid")
class SigmoidLayer(_Elementwise):
    def apply(self, params, bottoms, ctx):
        return [_Sigmoid.apply(bottoms[0].float()).to(bottoms[0].dtype)]


@register_layer("TanH")
class TanHLayer(_Elementwise):
    def apply(self, params, bottoms, ctx):
        return [_TanH.apply(bottoms[0].float()).to(bottoms[0].dtype)]
