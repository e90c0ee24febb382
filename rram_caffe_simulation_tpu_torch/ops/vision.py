"""Convolution and Pooling (counterpart of the reference package's
ops/vision.py; reference conv_layer.cpp, base_conv_layer.cpp,
pooling_layer.cpp). NCHW throughout, as Caffe stores blobs.

Pooling keeps Caffe's CEIL output size: the input is padded explicitly
(`pad` low, `ceil_pad_hi` high) and pooled without implicit padding, so
the ragged last window is the one Caffe computes; AVE divides each
window by its intersection with the padded extent [-pad, h + pad)
(`ave_pool_divisors`), not by what `avg_pool2d(ceil_mode=True)` uses.
MAX backward is autograd's (the reference leaves its Pallas backward
kernel off by default).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import proto
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ._util import (ave_pool_divisors, ceil_pad_hi, conv_spatial_params,
                    pool_spatial_params, pooled_size)


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    def setup(self, bottom_shapes):
        cp = self.lp.convolution_param
        if cp.axis != 1:
            raise ValueError("only channel axis 1 is supported")
        self.kernel, self.stride, self.pad, self.dilation = \
            conv_spatial_params(cp)
        self.num_output = cp.num_output
        self.group = cp.group
        self.bias_term = cp.bias_term
        n, c = bottom_shapes[0][:2]
        if c % self.group or self.num_output % self.group:
            raise ValueError(f"{self.name}: channels not divisible by group")
        spatial = bottom_shapes[0][2:]
        self.weight_shape = (self.num_output, c // self.group) + self.kernel
        out = tuple((spatial[i] + 2 * self.pad[i]
                     - (self.dilation[i] * (self.kernel[i] - 1) + 1))
                    // self.stride[i] + 1 for i in range(len(spatial)))
        self.top_shapes = [(n, self.num_output) + out] * max(1, len(
            self.lp.top))
        return self.top_shapes

    def num_params(self):
        return 2 if self.bias_term else 1

    def init_params(self, gen):
        cp = self.lp.convolution_param
        params = [make_filler(cp.weight_filler)(gen, self.weight_shape)]
        if self.bias_term:
            params.append(make_filler(cp.bias_filler)(gen,
                                                      (self.num_output,)))
        return params

    def apply(self, params, bottoms, ctx):
        tops = []
        for x in bottoms:
            y = F.conv2d(x, params[0], None, self.stride, self.pad,
                         self.dilation, self.group)
            if self.bias_term:
                y = y + params[1].reshape(1, -1, 1, 1)
            tops.append(y)
        return tops


@register_layer("Pooling")
class PoolingLayer(Layer):
    def setup(self, bottom_shapes):
        pp = self.lp.pooling_param
        self.method = pp.pool
        if self.method not in (proto.POOL_MAX, proto.POOL_AVE):
            raise NotImplementedError(
                f"{self.name}: only MAX and AVE pooling are ported")
        if len(self.lp.top) > 1:
            raise NotImplementedError(
                f"{self.name}: the pooling mask top is not ported")
        kernel, self.stride, self.pad = pool_spatial_params(pp)
        n, c, h, w = bottom_shapes[0]
        if pp.global_pooling:
            kernel, self.pad, self.stride = (h, w), (0, 0), (1, 1)
        self.kernel = kernel
        ph = pooled_size(h, kernel[0], self.stride[0], self.pad[0])
        pw = pooled_size(w, kernel[1], self.stride[1], self.pad[1])
        # F.pad order: (w_lo, w_hi, h_lo, h_hi)
        self.fpad = (
            self.pad[1], ceil_pad_hi(w, kernel[1], self.stride[1],
                                     self.pad[1], pw),
            self.pad[0], ceil_pad_hi(h, kernel[0], self.stride[0],
                                     self.pad[0], ph))
        self.divisors = np.outer(
            ave_pool_divisors(h, kernel[0], self.stride[0], self.pad[0], ph),
            ave_pool_divisors(w, kernel[1], self.stride[1], self.pad[1], pw))
        self._div = {}                  # the divisors on each device used
        self.top_shapes = [(n, c, ph, pw)]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        if self.method == proto.POOL_MAX:
            xp = F.pad(x, self.fpad, value=float("-inf"))
            return [F.max_pool2d(xp, self.kernel, self.stride)]
        xp = F.pad(x, self.fpad, value=0.0)
        s = F.avg_pool2d(xp, self.kernel, self.stride, divisor_override=1)
        key = (x.device, x.dtype)
        if key not in self._div:
            self._div[key] = torch.as_tensor(self.divisors, dtype=x.dtype,
                                             device=x.device)
        return [s / self._div[key]]
