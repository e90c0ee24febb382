"""InnerProduct, the RRAM fault target, Scale and Bias, Eltwise, and the
structural layers Concat, Slice, Split, Flatten and Reshape
(counterpart of the reference package's ops/common.py; reference
inner_product_layer.cpp:84-139 and net.cpp:482-493, which makes
InnerProduct params the failure-prone set; scale_layer.cpp,
bias_layer.cpp). The weight keeps Caffe's stored shape (num_output, K).

Under config lanes the weight is (C, num_output, K): a laned bottom
(N, C*ch, ...) is read as (C, N, K) (each lane in Caffe's flatten
order), the product is one batched matmul, or one launch of kernel B2
through `crossbar_matmul_lanes`, and the top is laned (N, C*num_output).
The bias gradient sums each (lane, output)'s rows as one contiguous row
(`_LaneBias`), so it does not depend on how many lanes share the call.

A layer the tile mapping names (ctx.tiles, cells per tile over the
stored weight) reads its (K, N) view through per-tile ADCs: kernel B2t
on the crossbar read, `tiled_crossbar_matmul` without one. Its
whole-output ADC is then skipped (the tiles have paid theirs).

Scale and Bias multiply or add an operand of shape s[axis:axis+num_axes]
(a learned param, or the second bottom) broadcast over the other axes.
Under config lanes a laned blob (N, C*d1, ...) is read as (N, C, d1,
...), a learned operand (C,) + shape broadcasts lane by lane, and an
unlaned bottom feeds every lane; axis 0 (the batch axis, which the
lanes do not split) and a laned second bottom raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import proto
from ..core import prng
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ..fault.hw_aware import (crossbar_matmul, crossbar_matmul_lanes,
                              quantize_ste, tiled_crossbar_matmul)
from ._util import flat_shape_from


class _LaneBias(torch.autograd.Function):
    """y (C, M, N) + b (C, N) lane by lane, whose backward sums each
    (lane, output)'s M cotangents as one contiguous row: autograd's
    broadcast reduction over M sums in an order that depends on how many
    lanes share the call (the sweep's config_block)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b[:, None, :]

    @staticmethod
    def backward(ctx, g):
        gb = g.transpose(1, 2).contiguous().sum(-1) \
            if ctx.needs_input_grad[1] else None
        return g, gb


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

    def init_params(self, key, device="cpu"):
        ip = self.lp.inner_product_param
        kw, kb = prng.split(key)
        params = [make_filler(ip.weight_filler)(kw, self.weight_shape,
                                                device)]
        if self.bias_term:
            params.append(make_filler(ip.bias_filler)(
                kb, (self.num_output,), device))
        return params

    def _kernel_tiles(self, ctx):
        """(bk, bn, adc_bits) over the (K, N) view, or None untiled: the
        tile's (rows, cols) over the stored weight swap under Caffe's
        (num_output, K) layout."""
        tl = ctx.tiles.get(self.name) if ctx.tiles else None
        if tl is None:
            return None
        bk, bn = (tl[0], tl[1]) if self.transpose else (tl[1], tl[0])
        return int(bk), int(bn), int(ctx.adc_bits)

    def apply(self, params, bottoms, ctx):
        if ctx.lanes:
            return self._apply_lanes(params, bottoms, ctx)
        x = bottoms[0].reshape(-1, self.K)
        w = params[0]
        cb = ctx.crossbar.get(self.name) if ctx.crossbar else None
        tiles = self._kernel_tiles(ctx)
        wv = w if self.transpose else w.t()
        if cb is not None:
            # the crossbar read runs on the (K, N) view; broken and stuck
            # are shaped like the stored weight and turn the same way
            broken, stuck, seed, sigma, q_bits, use_kernel = cb
            if not self.transpose:
                broken, stuck = broken.t(), stuck.t()
            y = crossbar_matmul(x.float(), wv.float(), broken, stuck.float(),
                                seed, sigma, q_bits, use_kernel,
                                tiles).to(x.dtype)
        elif tiles is not None:
            y = tiled_crossbar_matmul(x, wv, *tiles)
        else:
            y = x @ wv
        if ctx.adc_bits and tiles is None:
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
        tiles = self._kernel_tiles(ctx)
        turn = (lambda t: t) if self.transpose else \
            (lambda t: t.transpose(1, 2))         # (C, K, num_output)
        if cb is not None:
            broken, stuck, seeds, sigma, q_bits, use_kernel = cb
            y = crossbar_matmul_lanes(x.float(), turn(w).float(),
                                      turn(broken), turn(stuck).float(),
                                      seeds, sigma, q_bits,
                                      use_kernel, tiles).to(x.dtype)
        elif tiles is not None:
            y = tiled_crossbar_matmul(x, turn(w), *tiles)
        else:
            y = torch.matmul(x, turn(w))
        if ctx.adc_bits and tiles is None:
            y = quantize_ste(y, ctx.adc_bits, lanes=C)
        if self.bias_term:
            y = _LaneBias.apply(y, params[1])
        return [y.transpose(0, 1).reshape(M, C * self.num_output)]


class _AffineLayer(Layer):
    """What Scale and Bias share: the operand's shape and its broadcast
    over the bottom, with and without config lanes."""
    lane_rule = "own"

    def _setup_operand(self, bottom_shapes, axis, num_axes):
        s = tuple(bottom_shapes[0])
        self.learned = len(bottom_shapes) == 1
        self.axis = axis % len(s)
        # s[axis:axis+num_axes], to the end at num_axes -1
        end = len(s) if num_axes == -1 else self.axis + num_axes
        self.shape = (s[self.axis:end] if self.learned
                      else tuple(bottom_shapes[1]))
        self.rest = len(s) - self.axis - len(self.shape)
        self.bcast = (1,) * self.axis + self.shape + (1,) * self.rest
        self.top_shapes = [s]
        return self.top_shapes

    def _combine(self, x, mul, add, ctx):
        """x * mul + add (either may be None); mul and add are (tensor,
        laned) pairs, a laned tensor (C,) + shape."""
        if not ctx.lanes or not (any(ctx.laned) or self.num_params()):
            y = x if mul is None else x * mul[0].reshape(self.bcast)
            return y if add is None else y + add[0].reshape(self.bcast)
        C = ctx.lanes
        if self.axis == 0:
            raise NotImplementedError(
                f"{self.type_name} layer {self.name!r}: axis 0 under config "
                "lanes (the lanes split axis 1)")
        if len(ctx.laned) > 1 and ctx.laned[1]:
            raise NotImplementedError(
                f"{self.type_name} layer {self.name!r}: a laned second "
                "bottom under config lanes")
        n = x.shape[0]
        # (N, C, d1, ...): the lanes on their own axis (size 1 unlaned)
        xv = x.reshape((n, C, -1) + tuple(x.shape[2:])) if ctx.laned[0] \
            else x.unsqueeze(1)
        inner = (1,) * (self.axis - 1) + self.shape + (1,) * self.rest
        y = xv
        for op, fn in ((mul, torch.mul), (add, torch.add)):
            if op is not None:
                t, laned = op
                y = fn(y, t.reshape((1, C if laned else 1) + inner))
        if y.shape[1] != C:
            y = y.expand((n, C) + tuple(y.shape[2:]))
        return y.reshape((n, -1) + tuple(y.shape[3:]))


@register_layer("Bias")
class BiasLayer(_AffineLayer):
    """Adds a learned bias, or the second bottom, broadcast from `axis`
    (bias_layer.cpp)."""

    def setup(self, bottom_shapes):
        bp = self.lp.bias_param
        return self._setup_operand(bottom_shapes, bp.axis, bp.num_axes)

    def num_params(self):
        return 1 if self.learned else 0

    def init_params(self, key, device="cpu"):
        if not self.learned:
            return []
        return [make_filler(self.lp.bias_param.filler)(key, self.shape,
                                                        device)]

    def apply(self, params, bottoms, ctx):
        add = (params[0], True) if self.learned else (bottoms[1], False)
        return [self._combine(bottoms[0], None, add, ctx)]


@register_layer("Scale")
class ScaleLayer(_AffineLayer):
    """Multiplies by a learned scale, or the second bottom, broadcast from
    `axis`, then adds a learned bias with `bias_term` (scale_layer.cpp):
    the affine half of Caffe's BatchNorm + Scale pair. The scale's
    filler defaults to ones (scale_layer.cpp:39-47); the key splits into
    (scale, bias) keys before either draws, as the reference's does."""

    def setup(self, bottom_shapes):
        sp = self.lp.scale_param
        self.bias_term = sp.bias_term
        return self._setup_operand(bottom_shapes, sp.axis, sp.num_axes)

    def num_params(self):
        return int(self.learned) + int(self.bias_term)

    def init_params(self, key, device="cpu"):
        sp = self.lp.scale_param
        ks, kb = prng.split(key)
        params = []
        if self.learned:
            params.append(
                make_filler(sp.filler)(ks, self.shape, device)
                if sp.HasField("filler") else
                torch.ones(self.shape, dtype=torch.float32, device=device))
        if self.bias_term:
            params.append(make_filler(sp.bias_filler)(kb, self.shape,
                                                      device))
        return params

    def apply(self, params, bottoms, ctx):
        if self.learned:
            mul = (params[0], True)
            add = (params[1], True) if self.bias_term else None
        else:
            mul = (bottoms[1], False)
            add = (params[0], True) if self.bias_term else None
        return [self._combine(bottoms[0], mul, add, ctx)]


# ---------------------------------------------------------------------------
# structural layers and Eltwise (eltwise_layer.cpp, concat_layer.cpp,
# slice_layer.cpp, split_layer.cpp, flatten_layer.cpp, reshape_layer.cpp)
#
# Under config lanes a laned blob (N, C*d1, ...) is read as (N, C, d1,
# ...): a layer that cuts or joins axis 1 does so per lane, on axis 2 of
# that view. A bottom every lane shares, beside a laned one, is spread to
# every lane first (`_spread`).

def _lane_view(x, C: int):
    """(N, C*d1, ...) -> (N, C, d1, ...)."""
    return x.reshape((x.shape[0], C, -1) + tuple(x.shape[2:]))


def _fold(v):
    """(N, C, d1, ...) -> (N, C*d1, ...)."""
    return v.reshape((v.shape[0], -1) + tuple(v.shape[3:]))


def lanes_major(v, shape):
    """C lanes' values of a per-config blob of `shape`, (C,) + shape, in
    the laned layout: (d0, C*d1, ...) lane-major along axis 1, (d0, C)
    for a per-config (d0,), (C,) for a per-config scalar."""
    if not shape:
        return v
    return v.movedim(0, 1).reshape((shape[0], -1) + tuple(shape[2:]))


def _spread(bottoms, ctx):
    """(C, bottoms) with every bottom laned, an unlaned one repeated for
    each lane; C = 0 where no bottom is laned."""
    C = ctx.lanes if ctx.lanes and any(ctx.laned) else 0
    if not C:
        return 0, list(bottoms)
    out = []
    for x, laned in zip(bottoms, ctx.laned):
        if not laned:
            x = _fold(x.unsqueeze(1).expand(
                (x.shape[0], C) + tuple(x.shape[1:])))
        out.append(x)
    return C, out


@register_layer("Eltwise")
class EltwiseLayer(Layer):
    """PROD, SUM with coefficients, or MAX over the bottoms
    (eltwise_layer.cpp), as the reference writes them: SUM multiplies
    every bottom by its coefficient (1 by default) and adds in bottom
    order; MAX's gradient splits a tie evenly (jnp.maximum's rule)."""
    lane_rule = "any"

    def setup(self, bottom_shapes):
        ep = self.lp.eltwise_param
        self.op = ep.operation
        self.coeffs = [float(c) for c in ep.coeff] or \
            [1.0] * len(bottom_shapes)
        if len(self.coeffs) != len(bottom_shapes):
            raise ValueError(f"Eltwise layer {self.name!r}: one coeff a "
                             "bottom")
        self.top_shapes = [tuple(bottom_shapes[0])]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        _, bs = _spread(bottoms, ctx)
        if self.op == proto.ELTWISE_PROD:
            y = bs[0]
            for b in bs[1:]:
                y = y * b
        elif self.op == proto.ELTWISE_SUM:
            y = self.coeffs[0] * bs[0]
            for c, b in zip(self.coeffs[1:], bs[1:]):
                y = y + c * b
        else:
            y = bs[0]
            for b in bs[1:]:
                y = torch.maximum(y, b)
        return [y]


@register_layer("Concat")
class ConcatLayer(Layer):
    lane_rule = "own"

    def setup(self, bottom_shapes):
        cp = self.lp.concat_param
        axis = (cp.axis if cp.HasField("axis")
                or not cp.HasField("concat_dim") else cp.concat_dim)
        self.axis = axis % len(bottom_shapes[0])
        out = list(bottom_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in bottom_shapes)
        self.top_shapes = [tuple(out)]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        C, bs = _spread(bottoms, ctx)
        if C and self.axis == 1:
            return [_fold(torch.cat([_lane_view(b, C) for b in bs], 2))]
        return [torch.cat(bs, self.axis)]


@register_layer("Slice")
class SliceLayer(Layer):
    lane_rule = "own"

    def setup(self, bottom_shapes):
        sp = self.lp.slice_param
        axis = (sp.axis if sp.HasField("axis")
                or not sp.HasField("slice_dim") else sp.slice_dim)
        self.axis = axis % len(bottom_shapes[0])
        total = bottom_shapes[0][self.axis]
        n_top = len(self.lp.top)
        points = [int(p) for p in sp.slice_point]
        if points:
            if len(points) != n_top - 1:
                raise ValueError(f"Slice layer {self.name!r}: "
                                 f"{len(points)} slice points for {n_top} "
                                 "tops")
            bounds = [0] + points + [total]
        else:
            if total % n_top:
                raise ValueError(f"Slice layer {self.name!r}: {total} "
                                 f"does not split into {n_top} equal "
                                 "parts")
            bounds = list(range(0, total + 1, total // n_top))
        self.sizes = [b - a for a, b in zip(bounds, bounds[1:])]
        self.top_shapes = []
        for size in self.sizes:
            s = list(bottom_shapes[0])
            s[self.axis] = size
            self.top_shapes.append(tuple(s))
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
        if C and self.axis == 1:
            return [_fold(p) for p in
                    torch.split(_lane_view(x, C), self.sizes, 2)]
        return list(torch.split(x, self.sizes, self.axis))


@register_layer("Split")
class SplitLayer(Layer):
    """The bottom to every top; autograd sums the tops' gradients (the
    reference's InsertSplits, insert_splits.cpp:12)."""
    lane_rule = "any"

    def setup(self, bottom_shapes):
        self.top_shapes = [tuple(bottom_shapes[0])] * len(self.lp.top)
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        return [bottoms[0]] * len(self.top_shapes)


@register_layer("Flatten")
class FlattenLayer(Layer):
    """Axes axis..end_axis into one. A laned blob flattened from axis 1
    is its lanes' flattened blobs lane-major, (N, C*K): the layout
    InnerProduct's lane rule reads. Axis 0 would take the lanes into the
    batch axis, and raises under lanes."""
    lane_rule = "any"

    def setup(self, bottom_shapes):
        fp = self.lp.flatten_param
        s = bottom_shapes[0]
        self.start = fp.axis % len(s)
        self.end = fp.end_axis % len(s)
        mid = int(np.prod(s[self.start:self.end + 1]))
        self.top_shapes = [tuple(s[:self.start]) + (mid,)
                           + tuple(s[self.end + 1:])]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        if ctx.lanes and ctx.laned[0] and self.start == 0:
            raise NotImplementedError(
                f"Flatten layer {self.name!r}: axis 0 under config lanes "
                "(it would fold the lanes into the batch axis)")
        return [bottoms[0].flatten(self.start, self.end)]


@register_layer("Reshape")
class ReshapeLayer(Layer):
    """reshape_layer.cpp: a dim of 0 copies the bottom's, one -1 is
    inferred; axis and num_axes bound the replaced span. Under config
    lanes each lane's blob is reshaped in place in the lane-major
    layout, which needs the batch axis kept and a second axis; a reshape
    that moves the lane-folded channel axis raises."""
    lane_rule = "own"

    def setup(self, bottom_shapes):
        rp = self.lp.reshape_param
        s = list(bottom_shapes[0])
        a = rp.axis % (len(s) + 1) if rp.axis < 0 else rp.axis
        n = len(s) - a if rp.num_axes == -1 else rp.num_axes
        mid = [s[a + i] if d == 0 else int(d)
               for i, d in enumerate(rp.shape.dim)]
        total = int(np.prod(s[a:a + n])) if n > 0 else 1
        if -1 in mid:
            known = int(np.prod([d for d in mid if d != -1]))
            mid[mid.index(-1)] = total // known
        self.in_shape = tuple(s)
        self.out_shape = tuple(s[:a]) + tuple(mid) + tuple(s[a + n:])
        self.top_shapes = [self.out_shape]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
        if not C:
            return [x.reshape(self.out_shape)]
        o = self.out_shape
        if len(o) < 2 or o[0] != self.in_shape[0]:
            raise NotImplementedError(
                f"Reshape layer {self.name!r}: {self.in_shape} -> {o} "
                "moves the lane-folded channel axis under config lanes")
        return [_fold(x.reshape((x.shape[0], C) + tuple(o[1:])))]
