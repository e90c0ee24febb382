"""Softmax, SoftmaxWithLoss, EuclideanLoss, ContrastiveLoss and Accuracy
(counterpart of the reference package's ops/losses.py; reference
softmax_layer.cpp, softmax_loss_layer.cpp, euclidean_loss_layer.cpp,
contrastive_loss_layer.cpp, accuracy_layer.cpp). The losses are written
out as the reference writes them (max-shifted softmax, -log(max(p,
FLT_MIN)), normalizer; sum((a - b)^2) / 2N) rather than through
F.cross_entropy or F.mse_loss, so the two packages compute the same
expression.

Under config lanes a loss layer gives one loss per lane, a (C,) top,
each lane's terms summed as contiguous rows (the same order whatever
the lane count; EuclideanLoss and ContrastiveLoss in rows of at most
256 terms, `_lane_sums`), and a laned bottom beside an unlaned one
(the data's labels or targets) meets every lane with the same
values."""
from __future__ import annotations

import numpy as np
import torch

from .. import proto
from ..core import prng
from ..core.registry import Layer, register_layer

_FLT_MIN = float(np.finfo(np.float32).tiny)


def _softmax(x, axis):
    x = x - x.amax(dim=axis, keepdim=True).detach()
    e = torch.exp(x)
    return e / e.sum(dim=axis, keepdim=True)


def _per_lane_rows(x, laned: bool, C: int, n: int):
    """A bottom's samples as rows: (C, N, K) of a laned blob (N, C*d1,
    ...), else (1, N, K), one set every lane meets."""
    if not laned:
        return x.reshape(1, n, -1)
    return x.reshape(n, C, -1).transpose(0, 1)


_ROW = 256     # a lane's sum is taken in rows of at most this many terms


def _lane_sums(t, C: int):
    """Each lane's terms summed, t (C, ...) -> (C,): in rows of at most
    _ROW terms, their sums again in rows, and so on. A reduction of a
    long row is split across threads by the number of rows reduced
    beside it (the card's reduction kernel picks its split by the
    output count), so short rows keep each lane's order whatever C is."""
    t = t.reshape(C, -1)
    while t.shape[1] > _ROW:
        pad = -t.shape[1] % _ROW
        if pad:
            t = torch.cat([t, t.new_zeros(C, pad)], 1)
        t = t.reshape(C, -1, _ROW).sum(2)
    return t.sum(1)


def _div(t, d: float):
    """t / d, a true division (on the card, dividing by a host scalar
    multiplies by its reciprocal)."""
    return t / torch.tensor(d, dtype=t.dtype, device=t.device)


def _normalization_mode(loss_param):
    # the legacy `normalize` flag overrides (softmax_loss_layer.cpp:40-47)
    if loss_param.HasField("normalize"):
        return proto.NORM_VALID if loss_param.normalize \
            else proto.NORM_BATCH_SIZE
    return loss_param.normalization


def _lane_labels(labels, ctx, C: int, shape):
    """Labels shaped `shape` ((C, N, ...) under lanes): per lane where the
    label blob is laned ((N, C, ...) folded, each lane's own samples),
    else one set shared by every lane."""
    if C and ctx.laned[1]:
        lab = labels.reshape((shape[1], C, -1)).movedim(1, 0)
        return lab.reshape(shape).long()
    lab = labels.reshape(shape[1 if C else 0:]).long()
    return lab.expand(shape)


def _normalizer(mode, outer, spatial, valid):
    """softmax_loss_layer.cpp:70-91 get_normalizer, clamped at 1."""
    if mode == proto.NORM_FULL:
        n = float(outer * spatial)
    elif mode == proto.NORM_VALID:
        n = valid
    elif mode == proto.NORM_BATCH_SIZE:
        n = float(outer)
    else:
        n = 1.0
    return torch.clamp_min(n, 1.0) if isinstance(n, torch.Tensor) \
        else max(n, 1.0)


@register_layer("Softmax")
class SoftmaxLayer(Layer):
    """The max-shifted softmax along `axis`; under config lanes a laned
    bottom's axis 1 holds (lane, channel) pairs, so axis 1 is taken per
    lane."""
    lane_rule = "own"

    def setup(self, bottom_shapes):
        self.axis = self.lp.softmax_param.axis % len(bottom_shapes[0])
        self.top_shapes = [tuple(bottom_shapes[0])]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x = bottoms[0]
        C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
        if C and self.axis == 1:
            v = x.reshape((x.shape[0], C, -1) + tuple(x.shape[2:]))
            return [_softmax(v, 2).reshape(x.shape)]
        return [_softmax(x, self.axis)]


@register_layer("SoftmaxWithLoss")
class SoftmaxWithLossLayer(Layer):
    """Under config lanes a laned bottom (N, C*ch, ...) gives one loss
    per lane, a (C,) top, and the prob top laned like the bottom."""
    auto_top_blobs = True
    lane_rule = "own"

    def default_loss_weight(self, top_index: int) -> float:
        return 1.0 if top_index == 0 else 0.0

    def setup(self, bottom_shapes):
        self.axis = self.lp.softmax_param.axis % len(bottom_shapes[0])
        lp = self.lp.loss_param
        self.ignore_label = (lp.ignore_label if lp.HasField("ignore_label")
                             else None)
        self.norm_mode = _normalization_mode(lp)
        self.top_shapes = [()]
        if len(self.lp.top) > 1:
            self.top_shapes.append(tuple(bottom_shapes[0]))
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x, labels = bottoms[0].float(), bottoms[1]
        C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
        if C:
            # (N, C*ch, ...) -> (C, N, ch, ...): the lane axis leads
            x = x.reshape((x.shape[0], C, -1) + tuple(x.shape[2:]))
            x = torch.movedim(x, 1, 0)
        axis = self.axis + (1 if C else 0)
        prob = _softmax(x, axis)
        pm = torch.movedim(prob, axis, -1)
        lab = _lane_labels(labels, ctx, C, pm.shape[:-1])
        p_true = torch.gather(pm, -1, lab.unsqueeze(-1)).squeeze(-1)
        nll = -torch.log(torch.clamp_min(p_true, _FLT_MIN))
        per_lane = x[0] if C else x
        outer = per_lane.shape[0]
        spatial = per_lane.numel() // per_lane.shape[self.axis] // outer
        if self.ignore_label is not None:
            mask = lab != self.ignore_label
            nll = torch.where(mask, nll, torch.zeros((), device=x.device))
            valid = (mask.reshape(C, -1).sum(1) if C and ctx.laned[1]
                     else (mask[0] if C else mask).sum()).to(x.dtype)
        else:
            valid = float(outer * spatial)
        total = nll.reshape(C, -1).sum(1) if C else nll.sum()
        loss = total / _normalizer(self.norm_mode, outer, spatial, valid)
        tops = [loss]
        if len(self.top_shapes) > 1:
            if C:
                prob = torch.movedim(prob, 0, 1).reshape(bottoms[0].shape)
            tops.append(prob)
        return tops


class _LossLayer(Layer):
    """The first top has loss weight 1 (loss_layer.cpp:9)."""
    auto_top_blobs = True
    lane_rule = "own"

    def default_loss_weight(self, top_index: int) -> float:
        return 1.0 if top_index == 0 else 0.0


@register_layer("EuclideanLoss")
class EuclideanLossLayer(_LossLayer):
    """sum((a - b)^2) / (2 N) (euclidean_loss_layer.cpp:20-27); b is
    read in a's shape."""

    def setup(self, bottom_shapes):
        a, b = bottom_shapes[0], bottom_shapes[1]
        if a[0] != b[0] or int(np.prod(a[1:])) != int(np.prod(b[1:])):
            raise ValueError(
                f"EuclideanLoss {self.name!r}: inputs must agree in batch "
                f"size and per-sample count, got {a} vs {b}")
        self.num = a[0]
        self.top_shapes = [()]
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        a, b = bottoms[0].float(), bottoms[1].float()
        C = ctx.lanes if ctx.lanes and any(ctx.laned) else 0
        if not C:
            d = a - b.reshape(a.shape)
            return [_div((d * d).sum(), 2.0 * self.num)]
        av, bv = (_per_lane_rows(t, laned, C, self.num)
                  for t, laned in zip((a, b), ctx.laned))
        d = (av - bv).expand(C, -1, -1)
        return [_div(_lane_sums(d * d, C), 2.0 * self.num)]


@register_layer("ContrastiveLoss")
class ContrastiveLossLayer(_LossLayer):
    """Siamese contrastive loss (contrastive_loss_layer.cpp:40-64): for
    each pair d^2 = |a - b|^2; similar pairs (label 1) cost d^2,
    dissimilar ones max(margin - d, 0)^2, or max(margin - d^2, 0) in the
    legacy version, with d = sqrt(max(d^2, 1e-12)) (correctly rounded);
    the sum over pairs / 2N."""

    def setup(self, bottom_shapes):
        self.num = bottom_shapes[0][0]
        clp = self.lp.contrastive_loss_param
        self.margin = float(np.float32(clp.margin))
        self.legacy = clp.legacy_version
        self.top_shapes = [()]
        return self.top_shapes

    def _pair_losses(self, dist_sq, y):
        zero = torch.zeros((), dtype=dist_sq.dtype, device=dist_sq.device)
        if self.legacy:
            dissim = torch.maximum(self.margin - dist_sq, zero)
        else:
            dist = _Sqrt.apply(torch.maximum(
                dist_sq, torch.full((), 1e-12, dtype=dist_sq.dtype,
                                    device=dist_sq.device)))
            gap = torch.maximum(self.margin - dist, zero)
            dissim = gap * gap
        return y * dist_sq + (1.0 - y) * dissim

    def apply(self, params, bottoms, ctx):
        a, b = bottoms[0].float(), bottoms[1].float()
        y = bottoms[2]
        C = ctx.lanes if ctx.lanes and any(ctx.laned) else 0
        n = self.num
        if not C:
            d = (a - b).reshape(n, -1)
            per = self._pair_losses((d * d).sum(1),
                                    y.reshape(-1).to(a.dtype))
            return [_div(per.sum(), 2.0 * n)]
        av, bv = (_per_lane_rows(t, laned, C, n)
                  for t, laned in zip((a, b), ctx.laned))
        d = av - bv                                  # (C or 1, N, K)
        dist_sq = (d * d).sum(2).expand(C, n)
        yv = _per_lane_rows(y, ctx.laned[2], C, n).reshape(-1, n) \
            .to(a.dtype).expand(C, n)
        per = self._pair_losses(dist_sq, yv)
        return [_div(_lane_sums(per, C), 2.0 * n)]


class _Sqrt(torch.autograd.Function):
    """The correctly rounded sqrt (XLA's CPU sqrt; torch's vectorised CPU
    sqrt is not always), with JAX's backward g * (0.5 / y)."""

    @staticmethod
    def forward(ctx, x):
        y = prng._sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (0.5 / y)


@register_layer("Accuracy")
class AccuracyLayer(Layer):
    """Top-k accuracy with ignore_label and the optional per-class top;
    an evaluation output, outside the objective. Under config lanes a
    laned bottom (N, C*ch, ...) gives one accuracy per lane, a (C,) top;
    the per-class top has no laned form yet and raises there."""
    lane_rule = "own"

    def setup(self, bottom_shapes):
        ap = self.lp.accuracy_param
        self.top_k = ap.top_k
        self.axis = ap.axis % len(bottom_shapes[0])
        self.ignore_label = (ap.ignore_label if ap.HasField("ignore_label")
                             else None)
        self.num_classes = bottom_shapes[0][self.axis]
        self.top_shapes = [()]
        if len(self.lp.top) > 1:
            self.top_shapes.append((self.num_classes,))
        return self.top_shapes

    def apply(self, params, bottoms, ctx):
        x, labels = bottoms[0].detach(), bottoms[1]
        C = ctx.lanes if ctx.lanes and ctx.laned[0] else 0
        if C:
            if len(self.top_shapes) > 1:
                raise NotImplementedError(
                    f"layer {self.name!r} (Accuracy): the per-class top "
                    "over config lanes is not ported")
            # (N, C*ch, ...) -> (C, N, ch, ...): the lane axis leads
            x = torch.movedim(x.reshape((x.shape[0], C, -1)
                                        + tuple(x.shape[2:])), 1, 0)
        xm = torch.movedim(x, self.axis + (1 if C else 0), -1)
        lab = _lane_labels(labels, ctx, C, xm.shape[:-1])
        score_true = torch.gather(xm, -1, lab.unsqueeze(-1))
        # correct when fewer than top_k classes score strictly higher
        correct = (xm > score_true).sum(-1) < self.top_k
        # per lane: the sums over each lane's samples
        lane = (lambda t: t.reshape(C, -1)) if C else (
            lambda t: t.reshape(1, -1))
        if self.ignore_label is not None:
            mask = lab != self.ignore_label
            acc = (lane(correct & mask).sum(1)
                   / lane(mask).sum(1).clamp_min(1))
        else:
            mask = torch.ones_like(correct)
            acc = lane(correct.to(x.dtype)).mean(1)
        if not C:
            acc = acc[0]
        tops = [acc.to(x.dtype)]
        if len(self.top_shapes) > 1:
            flat = lab.reshape(-1)
            hit = torch.zeros(self.num_classes, dtype=x.dtype,
                              device=x.device).index_add_(
                0, flat, (correct & mask).reshape(-1).to(x.dtype))
            cnt = torch.zeros(self.num_classes, dtype=x.dtype,
                              device=x.device).index_add_(
                0, flat, mask.reshape(-1).to(x.dtype))
            tops.append(hit / cnt.clamp_min(1.0))
        return tops
