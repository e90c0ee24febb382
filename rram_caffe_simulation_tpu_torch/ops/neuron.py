"""Elementwise neuron layers (counterpart of the reference package's
ops/neuron.py): ReLU, with Caffe's optional negative slope; Sigmoid and
TanH; Dropout.

ReLU without a slope is the reference's jnp.maximum(x, 0), whose
gradient at x == 0 is half the cotangent (JAX's rule for a tie; Caffe's
is 0). A pre-activation is exactly 0 where a crossbar row reads as zeros
beside a bias stuck at 0, and the bias's write then rests on it.

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
signed zero, as XLA's CPU code runs with denormals off.

Dropout (the reference's inverted dropout, dropout_layer.cpp:30-60): in
TRAIN the kept mask is bernoulli(fold_in(rng, crc32(name) & 0x7FFFFFFF),
1 - ratio) over the blob (core/prng.py, the reference's draw bit for
bit, on the blob's device) and a kept value is divided by 1 - ratio in
float32; in TEST, or at ratio 0, the identity. Under config lanes lane c
draws its mask from its own key rng[c] (all lanes in one batched draw),
also over a bottom every lane shares."""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import proto
from ..core import prng
from ..core.registry import Layer, register_layer
from .common import lanes_major

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


class _ReLU(torch.autograd.Function):
    """max(x, 0) with the gradient of the reference's jnp.maximum(x, 0):
    g * 1 where x > 0, g * 0.5 where x == 0 (JAX splits a tie evenly),
    g * 0 below and at NaN. The factor is one heaviside pass, the product
    a second (torch.maximum's own backward takes five and passes g at
    NaN)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.heaviside(x, x.new_full((), 0.5))


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
        return [_ReLU.apply(x)]


@register_layer("Sigmoid")
class SigmoidLayer(_Elementwise):
    def apply(self, params, bottoms, ctx):
        return [_Sigmoid.apply(bottoms[0].float()).to(bottoms[0].dtype)]


@register_layer("TanH")
class TanHLayer(_Elementwise):
    def apply(self, params, bottoms, ctx):
        return [_TanH.apply(bottoms[0].float()).to(bottoms[0].dtype)]


@register_layer("Dropout")
class DropoutLayer(_Elementwise):
    lane_rule = "own"

    def setup(self, bottom_shapes):
        self.ratio = self.lp.dropout_param.dropout_ratio
        return super().setup(bottom_shapes)

    def _draws(self) -> bool:
        return self.phase == proto.TRAIN and self.ratio != 0.0

    def draws_tops(self):
        return (self._draws(),)

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        if not self._draws():
            return [x]
        if ctx.rng is None:
            raise ValueError(f"Dropout {self.name!r} in TRAIN needs a "
                             "forward key (Net.apply's rng)")
        key = prng.fold_in(ctx.rng,
                           zlib.crc32(self.name.encode()) & 0x7FFFFFFF)
        shape = tuple(self.top_shapes[0])
        keep = prng.bernoulli(key, 1.0 - self.ratio, shape, x.device)
        if ctx.lanes:
            # lane c's mask from rng[c], lane-major in the folded axis;
            # a bottom every lane shares is repeated for each lane first
            keep = lanes_major(keep, shape)
            if not ctx.laned[0]:
                x = lanes_major(x.expand((ctx.lanes,) + shape), shape)
        # a division by a device tensor (CUDA turns a host scalar divisor
        # into a product with its reciprocal); its backward is
        # where(keep, g, 0) / s, as the reference's
        s = torch.full((), float(np.float32(1.0 - self.ratio)),
                       dtype=x.dtype, device=x.device)
        return [torch.where(keep, x / s, 0.0)]
