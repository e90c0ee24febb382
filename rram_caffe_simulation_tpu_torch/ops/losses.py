"""SoftmaxWithLoss and Accuracy (counterpart of the reference package's
ops/losses.py; reference softmax_loss_layer.cpp, accuracy_layer.cpp).
The loss is written out as the reference writes it (max-shifted
softmax, -log(max(p, FLT_MIN)), normalizer) rather than through
F.cross_entropy, so the two packages compute the same expression."""
from __future__ import annotations

import numpy as np
import torch

from .. import proto
from ..core.registry import Layer, register_layer

_FLT_MIN = float(np.finfo(np.float32).tiny)


def _softmax(x, axis):
    x = x - x.amax(dim=axis, keepdim=True).detach()
    e = torch.exp(x)
    return e / e.sum(dim=axis, keepdim=True)


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
