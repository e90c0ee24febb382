"""InnerProduct, the RRAM fault target (counterpart of the reference
package's ops/common.py; reference inner_product_layer.cpp:84-139 and
net.cpp:482-493, which makes InnerProduct params the failure-prone
set). The weight keeps Caffe's stored shape (num_output, K).

Under config lanes the weight is (C, num_output, K): a laned bottom
(N, C*ch, ...) is read as (C, N, K) (each lane in Caffe's flatten
order), the product is one batched matmul, or one launch of kernel B2
through `crossbar_matmul_lanes`, and the top is laned (N, C*num_output).
"""
from __future__ import annotations

import torch

from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ..fault.hw_aware import (crossbar_matmul, crossbar_matmul_lanes,
                              quantize_ste)
from ._util import flat_shape_from


@register_layer("InnerProduct")
class InnerProductLayer(Layer):
    fault_target = True
    lane_rule = "own"

    def setup(self, bottom_shapes):
        ip = self.lp.inner_product_param
        self.num_output = ip.num_output
        self.bias_term = ip.bias_term
        self.transpose = ip.transpose
        self.axis = ip.axis % len(bottom_shapes[0])
        _, self.K = flat_shape_from(bottom_shapes[0], self.axis)
        self.weight_shape = ((self.K, self.num_output) if self.transpose
                             else (self.num_output, self.K))
        self.out_shape = tuple(bottom_shapes[0][:self.axis]) + (
            self.num_output,)
        self.top_shapes = [self.out_shape]
        return self.top_shapes

    def num_params(self):
        return 2 if self.bias_term else 1

    def init_params(self, gen):
        ip = self.lp.inner_product_param
        params = [make_filler(ip.weight_filler)(gen, self.weight_shape)]
        if self.bias_term:
            params.append(make_filler(ip.bias_filler)(gen,
                                                      (self.num_output,)))
        return params

    def apply(self, params, bottoms, ctx):
        if ctx.lanes:
            return self._apply_lanes(params, bottoms, ctx)
        x = bottoms[0].reshape(-1, self.K)
        w = params[0]
        cb = ctx.crossbar.get(self.name) if ctx.crossbar else None
        if cb is not None:
            # the crossbar read runs on the (K, N) view; broken and stuck
            # are shaped like the stored weight and turn the same way
            broken, stuck, seed, sigma, q_bits, use_kernel = cb
            if self.transpose:
                wv, bv, sv = w, broken, stuck
            else:
                wv, bv, sv = w.t(), broken.t(), stuck.t()
            y = crossbar_matmul(x.float(), wv.float(), bv, sv.float(), seed,
                                sigma, q_bits, use_kernel).to(x.dtype)
        else:
            y = x @ (w if self.transpose else w.t())
        if ctx.adc_bits:
            # the bitline currents (pre-bias; the bias is digital) read
            # through an adc_bits-wide converter
            y = quantize_ste(y, ctx.adc_bits)
        if self.bias_term:
            y = y + params[1]
        return [y.reshape(self.out_shape)]

    def _apply_lanes(self, params, bottoms, ctx):
        C = ctx.lanes
        if self.axis != 1:
            raise NotImplementedError(
                f"{self.name}: config lanes need InnerProduct axis 1")
        x = bottoms[0]
        M = x.shape[0]
        x = (x.reshape(M, C, self.K).transpose(0, 1) if ctx.laned[0]
             else x.reshape(M, self.K))
        w = params[0]
        cb = ctx.crossbar.get(self.name) if ctx.crossbar else None
        turn = (lambda t: t) if self.transpose else \
            (lambda t: t.transpose(1, 2))         # (C, K, num_output)
        if cb is not None:
            broken, stuck, seeds, sigma, q_bits, use_kernel = cb
            y = crossbar_matmul_lanes(x.float(), turn(w).float(),
                                      turn(broken), turn(stuck).float(),
                                      seeds, sigma, q_bits,
                                      use_kernel).to(x.dtype)
        else:
            y = torch.matmul(x, turn(w))
        if ctx.adc_bits:
            y = quantize_ste(y, ctx.adc_bits, lanes=C)
        if self.bias_term:
            y = y + params[1][:, None, :]
        return [y.transpose(0, 1).reshape(M, C * self.num_output)]
