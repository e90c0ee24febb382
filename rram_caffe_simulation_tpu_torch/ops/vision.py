"""Convolution, Pooling, LRN and BatchNorm (counterpart of the reference
package's ops/vision.py; reference conv_layer.cpp, base_conv_layer.cpp,
pooling_layer.cpp, lrn_layer.cpp, batch_norm_layer.cpp). NCHW
throughout, as Caffe stores blobs.

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
grouped call (groups = C * group; a bottom every lane shares is
repeated once per lane) and pooling needs no change. A lane's result
must not depend on how many lanes share the call (the sweep's
config_block), so: on CPU tensors the call runs without oneDNN
(`_PerGroupConv2d`: oneDNN's grouped weight gradient sums in an order
that depends on the group count, ATen's own path computes each group
alone); a bottom every lane shares is, on the card, one group-1 forward
call whose weight gradient runs as batched im2col GEMMs of LANE_CHUNK
lanes each (`_SharedBottomConv2d`: cuDNN splits a group-1 call's
weight-gradient sums by its filter count), on the CPU repeated once per
lane into the grouped call; and the bias gradient sums each (sample,
channel) plane first (`_LaneConvBias`: one reduction over N, H and W
splits by the channel count on the card).

A Convolution the tile mapping names (ctx.tiles, cells per tile over
its im2col (K, N) = (C_in*kh*kw, C_out) view) is the explicit im2col
GEMM read through per-tile ADCs, its operand by ctx.conv_im2col:
"premat" (patch rows built once; kernel B2t on the crossbar read),
"tilewise" (per-K-tile slabs; the plain read) or "implicit" (gathered
from the raw activation; kernel B3). The three give equal bytes. A
laned bottom is read per lane as (C, N, ch, H, W), contiguous, for one
launch; the (C, N*OH*OW, C_out) result goes back to (N, C*C_out, OH,
OW). Grouped convolution has no im2col crossbar view and is refused.

BatchNorm normalises each channel over the batch and the spatial axes;
under lanes the laned blob's channels are (lane, channel) pairs, so the
same reduction is BatchNorm per lane and per channel, and the (C, ch)
statistics read as (C*ch,).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import proto
from ..core import prng
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ..fault.hw_aware import (CONV_OPERANDS, conv_operand_slabs,
                              crossbar_conv_matmul,
                              crossbar_conv_matmul_lanes, crossbar_matmul,
                              crossbar_matmul_lanes,
                              tiled_crossbar_matmul_slabs)
from ..fault.mapping import conv_geom, conv_patch_rows, to_im2col
from .pool_backward import max_pool
from ._util import (ave_pool_divisors, ceil_pad_hi, conv_spatial_params,
                    pool_spatial_params, pooled_size)


class _NoOneDNN:
    """oneDNN off for a block (the global switch, restored after)."""

    def __enter__(self):
        self.prev = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.mkldnn.enabled = self.prev
        return False


class _PerGroupConv2d(torch.autograd.Function):
    """F.conv2d of CPU tensors, forward and backward, on ATen's own
    convolution (oneDNN off): each group computed alone, whatever the
    group count."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (list(stride), list(pad), list(dilation), groups)
        with _NoOneDNN():
            return F.conv2d(x, w, None, stride, pad, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, pad, dilation, groups = ctx.conf
        with _NoOneDNN():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy.contiguous(), x, w, None, stride, pad, dilation, False,
                [0] * len(pad), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


LANE_CHUNK = 16      # lanes a batched GEMM of a shared bottom's dw


def _fixed_chunk_matmul(r, patches):
    """A chunk of lanes' (k, o, N*L) cotangent rows against the shared
    (N*L, K) patch rows, as one GEMM of LANE_CHUNK lanes' rows whatever
    k is (a short chunk padded with zero rows): cuBLAS splits a GEMM's
    sums by its shape, so a fixed shape keeps each lane's sums."""
    k = r.shape[0]
    if k < LANE_CHUNK:
        pad = r.new_zeros((LANE_CHUNK - k,) + tuple(r.shape[1:]))
        r = torch.cat([r, pad])
    return torch.matmul(r, patches)[:k]


class _SharedBottomConv2d(torch.autograd.Function):
    """F.conv2d of one bottom (N, ch, H, W) every lane reads with
    `lanes` lanes' filters (lanes*o, ch, kh, kw), on the card: the
    forward one group-1 call (cuDNN); the weight gradient the im2col
    GEMM, LANE_CHUNK lanes a call (a shorter chunk padded), so a lane's
    sums are the same whatever the lane count (cuDNN splits a group-1
    call's weight-gradient sums by its filter count, cuBLAS a GEMM's by
    its shape)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilation, lanes):
        ctx.save_for_backward(x, w)
        ctx.conf = (list(stride), list(pad), list(dilation), lanes)
        return F.conv2d(x, w, None, stride, pad, dilation, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dilation, lanes = ctx.conf
        out = [0] * len(pad)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, pad, dilation, False, out, 1,
                [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            # each lane's (o, N*L) cotangent rows against the shared
            # patch rows, LANE_CHUNK lanes a batched GEMM (cuBLAS splits
            # the N*L sums by the batch count)
            n, (kh, kw) = x.shape[0], w.shape[2:]
            cols = F.unfold(x, (kh, kw), dilation, pad, stride)
            L = cols.shape[-1]
            patches = cols.transpose(1, 2).reshape(n * L, -1)
            rows = g.reshape(n, lanes, -1, L).permute(1, 2, 0, 3) \
                .reshape(lanes, -1, n * L)
            gw = torch.cat([_fixed_chunk_matmul(r, patches)
                            for r in rows.split(LANE_CHUNK)]).reshape(w.shape)
        return gx, gw, None, None, None, None


def lane_conv2d(x, w, stride, pad, dilation, groups):
    """The laned (grouped) convolution: cuDNN's one call on the card,
    the per-group ATen call on the CPU."""
    if x.is_cuda:
        return F.conv2d(x, w, None, stride, pad, dilation, groups)
    return _PerGroupConv2d.apply(x, w, tuple(stride), tuple(pad),
                                 tuple(dilation), groups)


class _LaneConvBias(torch.autograd.Function):
    """y (N, C*ch, H, W) + b (C, ch), whose backward sums each (sample,
    channel) plane, then the samples, in an order no lane count moves
    (the CPU's second sum over contiguous rows)."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.b_shape = b.shape
        return y + b.reshape(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, g):
        gb = None
        if ctx.needs_input_grad[1]:
            planes = g.sum((2, 3))
            gb = (planes.sum(0) if g.is_cuda
                  else planes.t().contiguous().sum(1)).reshape(ctx.b_shape)
        return g, gb


def add_conv_bias(y, b, lanes: int):
    return _LaneConvBias.apply(y, b) if lanes else \
        y + b.reshape(1, -1, 1, 1)


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
        self.out_hw = out
        self.top_shapes = [(n, self.num_output) + out] * max(1, len(
            self.lp.top))
        return self.top_shapes

    def num_params(self):
        return 2 if self.bias_term else 1

    def init_params(self, key, device="cpu"):
        cp = self.lp.convolution_param
        kw, kb = prng.split(key)
        params = [make_filler(cp.weight_filler)(kw, self.weight_shape,
                                                device)]
        if self.bias_term:
            params.append(make_filler(cp.bias_filler)(
                kb, (self.num_output,), device))
        return params

    def _crossbar_conv(self, x, w, ctx, tl, laned):
        """The tiled crossbar read of this layer: the im2col operand
        against the (K, C_out) weight view, per-(K, N)-tile ADC partial
        sums accumulated over K-tiles. `tl` = (bk, bn) cells per tile
        over the view."""
        if self.group != 1:
            raise ValueError(
                f"layer {self.name!r}: grouped convolution "
                f"(group={self.group}) is not mappable onto the im2col "
                "crossbar view — each group is a separate GEMM and the "
                "tile grid would straddle group boundaries; train this "
                "layer untiled (tile_spec='1x1') or ungrouped")
        mode = ctx.conv_im2col or "premat"
        if mode not in CONV_OPERANDS:
            raise ValueError(f"conv_im2col={mode!r}: expected one of "
                             f"{CONV_OPERANDS}")
        C = ctx.lanes
        n, _, h, wd = x.shape
        if C and laned:
            # the (C, N, ch, H, W) view; the implicit read copies it once,
            # padded (pad_activation_flat)
            x = x.reshape(n, C, -1, h, wd).transpose(0, 1)
            if mode != "implicit":
                x = x.contiguous()
        geom = conv_geom(self.kernel, self.stride, self.pad, self.dilation)
        tiles = (int(tl[0]), int(tl[1]), int(ctx.adc_bits))
        wv = to_im2col(w, 4)                     # (C, K, C_out) / (K, C_out)
        cb = ctx.crossbar.get(self.name) if ctx.crossbar else None
        if cb is not None:
            broken, stuck, seed, sigma, q_bits, use_kernel = cb
            bv, sv = to_im2col(broken, 4), to_im2col(stuck, 4).float()
            if mode != "premat":
                fn = crossbar_conv_matmul_lanes if C else crossbar_conv_matmul
                y = fn(x, wv.float(), bv, sv, seed, sigma, q_bits, tiles,
                       geom, use_kernel, mode)
            else:
                fn = crossbar_matmul_lanes if C else crossbar_matmul
                y = fn(conv_patch_rows(x, geom), wv.float(), bv, sv, seed,
                       sigma, q_bits, use_kernel, tiles)
        else:
            # no crossbar read armed: the stored weight through the tiles
            y = tiled_crossbar_matmul_slabs(
                conv_operand_slabs(x, geom, mode), wv, *tiles)
        oh, ow = self.out_hw
        if C:
            return y.reshape(C, n, oh, ow, -1).permute(1, 0, 4, 2, 3) \
                .reshape(n, -1, oh, ow)
        return y.reshape(n, oh, ow, -1).permute(0, 3, 1, 2).contiguous()

    def apply(self, params, bottoms, ctx):
        w, C = params[0], ctx.lanes
        tl = ctx.tiles.get(self.name) if ctx.tiles else None
        if tl is not None:
            tops = []
            for i, x in enumerate(bottoms):
                y = self._crossbar_conv(x, w, ctx, tl,
                                        bool(C) and ctx.laned[i])
                if self.bias_term:
                    y = add_conv_bias(y, params[1], C)
                tops.append(y)
            return tops
        if C:
            # lane c's filters become output channels c*num_output + o
            w = w.reshape((-1,) + tuple(w.shape[2:]))
        tops = []
        for i, x in enumerate(bottoms):
            if C and x.is_cuda and not ctx.laned[i] and self.group == 1:
                y = _SharedBottomConv2d.apply(x, w, tuple(self.stride),
                                              tuple(self.pad),
                                              tuple(self.dilation), C)
            elif C:
                if not ctx.laned[i]:
                    x = x.repeat(1, C, 1, 1)
                y = lane_conv2d(x, w, self.stride, self.pad, self.dilation,
                                C * self.group)
            else:
                y = F.conv2d(x, w, None, self.stride, self.pad,
                             self.dilation, self.group)
            if self.bias_term:
                y = add_conv_bias(y, params[1], C)
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


class _PowF64(torch.autograd.Function):
    """x ** e of a float32 tensor x > 0 and a float exponent e: float64's
    pow rounded once to float32, the correctly rounded value but for a
    double rounding (1 ulp from XLA's CPU pow at 0.02% of LRN's scales);
    the backward is JAX's rule, g * (e * x ** (e - 1)) in float32."""

    @staticmethod
    def forward(ctx, x, e):
        ctx.save_for_backward(x)
        ctx.e = e
        return torch.pow(x.double(), e).float()

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        e = np.float32(ctx.e)
        jac = torch.pow(x.double(), float(e - np.float32(1.0))).float() \
            * float(e)
        return g * jac, None


@register_layer("LRN")
class LRNLayer(Layer):
    """Local response normalization (lrn_layer.cpp:118-164): x * scale **
    -beta, scale = k + alpha / n * (the sum of x^2 over the window), n
    the window's count. ACROSS_CHANNELS sums `local_size` neighbouring
    channels of zero-padded channels, as the reference does, shifted
    slice by shifted slice in its order; WITHIN_CHANNEL sums a
    local_size x local_size box of zero-padded planes (in the row-major
    order of XLA's reduce_window, as avg_pool2d sums). Under config
    lanes a laned bottom's channels are (lane, channel) pairs: the
    within-channel box is per channel (lane rule "any"), the
    across-channels window pads each lane's channel edges, never
    between lanes ("own")."""

    def setup(self, bottom_shapes):
        lp = self.lp.lrn_param
        self.size = lp.local_size
        if self.size % 2 != 1:
            raise ValueError(f"LRN layer {self.name!r}: local_size must be "
                             "odd")
        self.alpha, self.beta, self.k = lp.alpha, lp.beta, lp.k
        self.across = lp.norm_region == proto.ACROSS_CHANNELS
        self.lane_rule = "own" if self.across else "any"
        n = self.size if self.across else self.size * self.size
        self.coef = float(np.float32(self.alpha / n))
        self.top_shapes = [tuple(bottom_shapes[0])]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        sq = x * x
        half = (self.size - 1) // 2
        if self.across:
            C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
            v = (sq.reshape((sq.shape[0], C, -1) + tuple(sq.shape[2:]))
                 if C else sq.unsqueeze(1))
            c = v.shape[2]
            padded = F.pad(v, [0, 0] * (v.dim() - 3) + [half, half])
            ssum = padded[:, :, 0:c]
            for d in range(1, self.size):
                ssum = ssum + padded[:, :, d:d + c]
            ssum = ssum.reshape(sq.shape)
        else:
            ssum = F.avg_pool2d(sq, self.size, 1, half,
                                count_include_pad=True, divisor_override=1)
        scale = ssum * self.coef + self.k
        return [x * _PowF64.apply(scale, -self.beta)]


@register_layer("BatchNorm")
class BatchNormLayer(Layer):
    """Caffe's BatchNorm (batch_norm_layer.cpp:14-140): three blobs,
    the moving mean, the moving variance and scale_factor (1,), no
    learned affine (a Scale layer follows for that). The stored stats
    are sums discounted by scale_factor: the global-stats forward
    divides by it. In TRAIN the layer normalises by the batch's mean and
    biased variance (autograd carries the full backward) and reports
    the moving update through ctx.updates (registry.py): mean' = maf *
    mean + batch mean, var' = maf * var + m / (m - 1) * batch var (m =
    N*H*W), sf' = maf * sf + 1, each from detached values. sf' is the
    fused multiply-add the reference's jitted step computes (XLA
    contracts it), so the sequence is the reference's bit for bit."""
    lane_rule = "own"
    updates_state = True

    def setup(self, bottom_shapes):
        bp = self.lp.batch_norm_param
        s = tuple(bottom_shapes[0])
        self.channels = s[1] if len(s) > 1 else 1
        self.use_global_stats = (bp.use_global_stats
                                 if bp.HasField("use_global_stats")
                                 else self.phase == proto.TEST)
        self.maf = bp.moving_average_fraction
        self.eps = bp.eps
        self.top_shapes = [s]
        return self.top_shapes

    def num_params(self):
        return 3

    def param_specs(self):
        # the statistics take no solver update (batch_norm_layer.cpp:39)
        specs = super().param_specs()
        for s in specs:
            s.lr_mult = s.decay_mult = 0.0
        return specs

    def init_params(self, key, device="cpu"):
        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)
        return [zeros(self.channels), zeros(self.channels), zeros(1)]

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        mean_b, var_b, sf = params
        C = ctx.lanes
        if C:
            # lane-major channels; an unlaned bottom feeds every lane
            if not ctx.laned[0]:
                x = x.repeat((1, C) + (1,) * (x.dim() - 2))
            mean_b, var_b = mean_b.reshape(-1), var_b.reshape(-1)
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        if self.use_global_stats:
            s = sf[..., 0]
            scale = torch.where(s == 0, torch.zeros_like(s),
                                torch.reciprocal(torch.clamp_min(s, 1e-30)))
            if C:
                scale = scale.repeat_interleave(self.channels)
            mean, var = mean_b * scale, var_b * scale
            return [(x - mean.reshape(bshape))
                    * torch.rsqrt(var.reshape(bshape) + self.eps)]
        axes = (0,) + tuple(range(2, x.dim()))
        m = x.shape[0] * int(np.prod(x.shape[2:]))
        mean = x.mean(axes)
        xc = x - mean.reshape(bshape)
        var = (xc * xc).mean(axes)
        y = xc * torch.rsqrt(var.reshape(bshape) + self.eps)
        if ctx.updates is not None:
            corr = m / (m - 1.0) if m > 1 else 1.0
            new_mean = self.maf * mean_b.detach() + mean.detach()
            new_var = self.maf * var_b.detach() + corr * var.detach()
            if C:
                new_mean = new_mean.reshape(C, -1)
                new_var = new_var.reshape(C, -1)
            ctx.updates[self.name] = [new_mean, new_var,
                                      prng.fma(sf.detach(), self.maf, 1.0)]
        return [y]
