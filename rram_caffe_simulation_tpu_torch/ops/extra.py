"""The Python layer (counterpart of the reference package's
ops/extra.py; reference include/caffe/layers/python_layer.hpp).

`type: "Python"` with python_param {module, layer, param_str} builds the
user's class and drives it with Caffe's setup/reshape/forward/backward
contract on the host. The user object gets pycaffe-style blob wrappers
with numpy `.data`/`.diff`, `reshape`, `shape` and `count()`. The
backward runs through a torch.autograd.Function that calls the user's
`backward(top, propagate_down, bottom)` (python_layer.hpp:40 delegates
so) and reads the bottoms' `.diff`; a class without `backward` gives
zero gradients.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..core.registry import Layer, register_layer


class PyBlob:
    """A blob as a Python layer sees it: float32 `.data` and `.diff`."""

    def __init__(self, shape):
        self.reshape(*shape)

    def reshape(self, *shape):
        self._shape = list(shape)
        self.data = np.zeros(shape, np.float32)
        self.diff = np.zeros(shape, np.float32)

    @property
    def shape(self):
        return self._shape

    def count(self):
        return self.data.size


def _blobs(arrays) -> list:
    out = []
    for a in arrays:
        b = PyBlob(a.shape)
        b.data[...] = a
        out.append(b)
    return out


class _PythonFunction(torch.autograd.Function):
    """The user layer's forward, and its backward as the gradient."""

    @staticmethod
    def forward(ctx, layer, *bottoms):
        ctx.layer = layer
        ctx.save_for_backward(*bottoms)
        tops = layer.host_forward([b.detach().cpu().numpy() for b in bottoms])
        return tuple(torch.from_numpy(t).to(bottoms[0].device)
                     for t in tops)

    @staticmethod
    def backward(ctx, *top_diffs):
        bottoms = ctx.saved_tensors
        if not ctx.layer.has_backward:
            return (None,) + tuple(torch.zeros_like(b) for b in bottoms)
        diffs = ctx.layer.host_backward(
            [b.detach().cpu().numpy() for b in bottoms],
            [g.detach().cpu().numpy() for g in top_diffs])
        return (None,) + tuple(torch.from_numpy(d).to(b.device)
                               for d, b in zip(diffs, bottoms))


@register_layer("Python")
class PythonLayer(Layer):
    """A user-written layer named by python_param (the module must be
    importable)."""

    def setup(self, bottom_shapes):
        ppar = self.lp.python_param
        module = importlib.import_module(ppar.module)
        self.obj = getattr(module, ppar.layer)()
        self.obj.param_str = ppar.param_str
        bottoms = [PyBlob(s) for s in bottom_shapes]
        tops = [PyBlob((1,)) for _ in range(max(len(self.lp.top), 1))]
        self.obj.setup(bottoms, tops)
        self.obj.reshape(bottoms, tops)
        self.has_backward = callable(getattr(self.obj, "backward", None))
        self.top_shapes = [tuple(t.shape) for t in tops]
        return self.top_shapes

    def host_forward(self, arrays) -> list:
        bottoms = _blobs(arrays)
        tops = [PyBlob(s) for s in self.top_shapes]
        self.obj.reshape(bottoms, tops)
        self.obj.forward(bottoms, tops)
        return [np.asarray(t.data, np.float32) for t in tops]

    def host_backward(self, arrays, top_diffs) -> list:
        """The bottoms' diffs. The forward runs again on these bottoms
        first: Caffe calls Backward right after Forward on the same
        object, and user layers keep forward state (pyloss's diff)."""
        bottoms = _blobs(arrays)
        tops = [PyBlob(s) for s in self.top_shapes]
        self.obj.reshape(bottoms, tops)
        self.obj.forward(bottoms, tops)
        for t, g in zip(tops, top_diffs):
            t.diff[...] = g
        self.obj.backward(tops, [True] * len(bottoms), bottoms)
        return [np.asarray(b.diff, np.float32) for b in bottoms]

    def apply(self, params, bottoms, ctx):
        return list(_PythonFunction.apply(self, *(b.float() for b in bottoms)))
