"""Net: a prototxt graph as init/apply over tensors (counterpart of the
reference package's net/builder.py; reference net.cpp Init :49,
FilterNet/StateMeetsRule :289/:319, AppendParam :451 and the fork's
failure-param bookkeeping :482-493).

Params are a plain dict {layer_name: [tensor, ...]} holding only owner
layers' blobs; shared params (ParamSpec names) resolve through a table
built once. Gradients of multi-consumer blobs sum through autograd, so
Caffe's split layers are not needed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import ops  # noqa: F401  (registers every ported layer type)
from .. import proto
from ..core.registry import LayerContext, create_layer
from ..device import resolve_device


@dataclasses.dataclass
class ParamRef:
    """One learnable parameter slot, in Caffe's learnable_params_
    order."""
    layer_name: str
    slot: int
    owner_layer: str
    owner_slot: int
    name: str
    lr_mult: float
    decay_mult: float
    fault_target: bool

    @property
    def key(self) -> tuple:
        return (self.owner_layer, self.owner_slot)


def state_meets_rule(state, rule) -> bool:
    """net.cpp:319 StateMeetsRule."""
    if rule.HasField("phase") and rule.phase != state.phase:
        return False
    if rule.HasField("min_level") and state.level < rule.min_level:
        return False
    if rule.HasField("max_level") and state.level > rule.max_level:
        return False
    stages = set(state.stage)
    if any(s not in stages for s in rule.stage):
        return False
    return not any(s in stages for s in rule.not_stage)


def filter_net(net_param, state) -> proto.Message:
    """net.cpp:289 FilterNet: the layers whose include/exclude rules
    admit `state`."""
    out = net_param.copy()
    kept = []
    for lp in net_param.layer:
        if lp.include and lp.exclude:
            raise ValueError(f"layer {lp.name}: specify include or exclude "
                             "rules, not both")
        if lp.include:
            keep = any(state_meets_rule(state, r) for r in lp.include)
        else:
            keep = not any(state_meets_rule(state, r) for r in lp.exclude)
        if keep:
            kept.append(lp.copy())
    out._values["layer"] = kept
    return out


class Net:
    """A network built from a NetParameter for one phase, on `device`
    (default: the card; raises without one unless device="cpu")."""

    def __init__(self, net_param, phase: int, stages=(), level: int = 0,
                 device=None):
        self.device = resolve_device(device)
        state = (net_param.state.copy() if net_param.HasField("state")
                 else proto.Message("NetState"))
        state.phase = phase
        state.level = level
        for s in stages:
            if s not in state.stage:
                state.stage.append(s)
        self.param_proto = filter_net(net_param, state)
        self.name = net_param.name
        self.phase = int(phase)
        self.layers = []
        self.layer_by_name = {}
        self.data_source_tops: dict = {}
        self.loss_weights: dict = {}
        self._build()

    def _build(self) -> None:
        produced: dict = {}
        consumed: set = set()
        self.learnable_params: list = []
        shared_by_name: dict = {}
        self._layer_slots: dict = {}
        for lp in self.param_proto.layer:
            layer = create_layer(lp, self.phase)
            if lp.name in self.layer_by_name:
                raise ValueError(f"duplicate layer name {lp.name!r}")
            bottom_shapes = []
            for b in lp.bottom:
                if b not in produced:
                    raise ValueError(
                        f"layer {lp.name!r}: unknown bottom blob {b!r}")
                bottom_shapes.append(produced[b])
                consumed.add(b)
            top_shapes = layer.setup(bottom_shapes)
            if layer.auto_top_blobs and len(lp.top) < len(top_shapes):
                for i in range(len(lp.top), len(top_shapes)):
                    auto = "(automatic)"
                    if auto in produced or auto in lp.top:
                        auto = f"(automatic)_{lp.name}_{i}"
                    lp.top.append(auto)
            for t, shape in zip(lp.top, top_shapes):
                produced[t] = tuple(shape)
                if layer.is_data_source:
                    self.data_source_tops[t] = tuple(shape)
            for i, t in enumerate(lp.top):
                w = (lp.loss_weight[i] if i < len(lp.loss_weight)
                     else layer.default_loss_weight(i))
                if w != 0.0:
                    self.loss_weights[t] = self.loss_weights.get(t, 0.0) + w
            slots = []
            for slot, spec in enumerate(layer.param_specs()):
                if spec.name and spec.name in shared_by_name:
                    owner = shared_by_name[spec.name]
                else:
                    owner = (lp.name, slot)
                    if spec.name:
                        shared_by_name[spec.name] = owner
                slots.append(owner)
                self.learnable_params.append(ParamRef(
                    lp.name, slot, owner[0], owner[1], spec.name,
                    spec.lr_mult, spec.decay_mult, layer.fault_target))
            self._layer_slots[lp.name] = slots
            self.layers.append(layer)
            self.layer_by_name[lp.name] = layer
        self.blob_shapes = produced
        self.output_names = [b for b in produced if b not in consumed]
        # the fork's bookkeeping (net.cpp:482-493): the failure-prone
        # params are all owned params of fault-target layers
        # (InnerProduct: weights AND biases); fc_params_ids indexes their
        # weight matrices within that list
        self.failure_param_refs = [
            r for r in self.learnable_params
            if r.fault_target and r.key == (r.layer_name, r.slot)]
        self.fc_params_ids = [i for i, r in enumerate(self.failure_param_refs)
                              if r.slot == 0]

    def init(self, gen: torch.Generator) -> dict:
        """Draw every owner layer's parameters from the CPU generator
        `gen`, in layer order, then place them on the net's device."""
        params = {}
        for layer in self.layers:
            n = layer.num_params()
            if n == 0:
                continue
            slots = self._layer_slots[layer.name]
            owns = [i for i in range(n) if slots[i] == (layer.name, i)]
            if not owns:
                continue
            if layer.lp.blobs:
                raise NotImplementedError(
                    f"layer {layer.name!r}: weights inside the prototxt "
                    "(blobs) are not read by the port yet")
            blobs = layer.init_params(gen)
            params[layer.name] = [
                blobs[i].to(self.device) if i in owns else None
                for i in range(n)]
        return params

    def _gather_layer_params(self, params, layer) -> list:
        return [params[owner][slot]
                for owner, slot in self._layer_slots[layer.name]]

    def apply(self, params, batch: Optional[dict] = None,
              adc_bits: int = 0, crossbar: Optional[dict] = None,
              lanes: int = 0):
        """Run the net; returns (blobs, loss). `batch` feeds the
        data-source tops; `crossbar` routes named InnerProduct layers
        through the crossbar read (see LayerContext.crossbar).

        `lanes` = C > 0 runs C configs at once (the sweep): every param
        carries a leading C axis, the batch is shared, and a blob
        computed from params is "laned": a per-config blob of shape
        (d0, d1, ...) is held as (d0, C*d1, ...), lane-major along axis
        1, and a per-config scalar (a loss) as (C,). The loss is then
        one value per lane, (C,)."""
        batch = batch or {}
        ctx = LayerContext(phase=self.phase, adc_bits=adc_bits,
                           crossbar=crossbar, lanes=lanes)
        blobs = {}
        laned = set()
        for name in self.data_source_tops:
            if name in batch:
                blobs[name] = batch[name]
        for layer in self.layers:
            if layer.is_data_source:
                continue
            for b in layer.lp.bottom:
                if b not in blobs:
                    raise ValueError(f"batch missing data blob {b!r}")
            ctx.laned = tuple(b in laned for b in layer.lp.bottom)
            out_laned = bool(lanes) and (any(ctx.laned)
                                         or layer.num_params() > 0)
            if out_laned and layer.lane_rule is None:
                raise NotImplementedError(
                    f"layer {layer.name!r} ({layer.type_name}) has no "
                    "config-lane rule yet")
            tops = layer.apply(self._gather_layer_params(params, layer),
                               [blobs[b] for b in layer.lp.bottom], ctx)
            for t, v in zip(layer.lp.top, tops):
                blobs[t] = v
                (laned.add if out_laned else laned.discard)(t)
        loss = torch.zeros((lanes,) if lanes else (), dtype=torch.float32,
                           device=self.device)
        for blob_name, w in self.loss_weights.items():
            if blob_name in blobs:
                v = blobs[blob_name]
                if blob_name not in laned:
                    term = v.sum()
                elif self.blob_shapes[blob_name] == ():
                    term = v
                else:
                    term = v.reshape(v.shape[0], lanes, -1).sum((0, 2))
                loss = loss + w * term
        return blobs, loss
