"""Convolution and Pooling (counterpart of the reference package's
ops/vision.py; reference conv_layer.cpp, base_conv_layer.cpp,
pooling_layer.cpp). NCHW throughout, as Caffe stores blobs.

Pooling keeps Caffe's CEIL output size: the input is padded explicitly
(`pad` low, `ceil_pad_hi` high) and pooled without implicit padding, so
the ragged last window is the one Caffe computes; AVE divides each
window by its intersection with the padded extent [-pad, h + pad)
(`ave_pool_divisors`), not by what `avg_pool2d(ceil_mode=True)` uses.
MAX goes through `ops/pool_backward.max_pool`, whose backward
RRAM_POOL_BWD picks (autograd's by default, as the reference's
default is XLA's; "cuda" is kernel B4).

Config lanes (the sweep): a laned blob folds the lanes into channels,
(N, C*ch, H, W), lane-major, so a convolution runs every lane in one
grouped call (groups = C * group; a shared bottom feeds a group-1
convolution directly) and pooling needs no change.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import proto
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from .pool_backward import max_pool
from ._util import (ave_pool_divisors, ceil_pad_hi, conv_spatial_params,
                    pool_spatial_params, pooled_size)


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    lane_rule = "own"

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
        w, C = params[0], ctx.lanes
        if C:
            # lane c's filters become output channels c*num_output + o
            w = w.reshape((-1,) + tuple(w.shape[2:]))
        tops = []
        for i, x in enumerate(bottoms):
            groups = self.group
            if C and (ctx.laned[i] or self.group > 1):
                if not ctx.laned[i]:
                    x = x.repeat(1, C, 1, 1)
                groups = C * self.group
            y = F.conv2d(x, w, None, self.stride, self.pad, self.dilation,
                         groups)
            if self.bias_term:
                y = y + params[1].reshape(1, -1, 1, 1)
            tops.append(y)
        return tops


@register_layer("Pooling")
class PoolingLayer(Layer):
    lane_rule = "any"

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
            return [max_pool(x, self.kernel, self.stride, self.fpad)]
        xp = F.pad(x, self.fpad, value=0.0)
        s = F.avg_pool2d(xp, self.kernel, self.stride, divisor_override=1)
        key = (x.device, x.dtype)
        if key not in self._div:
            self._div[key] = torch.as_tensor(self.divisors, dtype=x.dtype,
                                             device=x.device)
        return [s / self._div[key]]
