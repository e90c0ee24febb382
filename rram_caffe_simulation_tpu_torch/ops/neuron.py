"""Elementwise neuron layers (counterpart of the reference package's
ops/neuron.py): ReLU, with Caffe's optional negative slope."""
from __future__ import annotations

import torch

from ..core.registry import Layer, register_layer


@register_layer("ReLU")
class ReLULayer(Layer):
    lane_rule = "any"

    def setup(self, bottom_shapes):
        self.negative_slope = self.lp.relu_param.negative_slope
        self.top_shapes = [tuple(bottom_shapes[0])]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        if self.negative_slope:
            return [torch.where(x > 0, x, self.negative_slope * x)]
        return [torch.relu(x)]
