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

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers every ported layer type)
from .. import proto
from ..core import prng
from ..core.registry import LayerContext, create_layer
from ..device import resolve_device
from ..utils.io import (array_to_blob, blob_to_array, read_net_param,
                        upgrade_batchnorm)


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
        # in-memory messages (a SolverParameter's net_param) get the
        # upgrade read_net_param gives files; filter_net copied them
        upgrade_batchnorm(self.param_proto)
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

    def feeds_batchnorm(self, layer_name: str) -> bool:
        """Whether the first layer to read `layer_name`'s top (in place or
        not) is a BatchNorm. The normalisation removes such a layer's
        bias, so the bias's true gradient is zero and what a summation
        order computes for it is rounding, often an exact 0."""
        at = self.layers.index(self.layer_by_name[layer_name])
        top = self.layers[at].lp.top[0]
        reader = next((ly for ly in self.layers[at + 1:]
                       if top in ly.lp.bottom), None)
        return reader is not None and reader.type_name == "BatchNorm"

    def bn_fed_biases(self, keys) -> set:
        """The bias keys "layer/1" among `keys` (fault keys "layer/slot",
        a Solver's `_fault_keys`) of the layers `feeds_batchnorm` names:
        whether such a cell counts a write rests on rounding."""
        return {k for k in keys if k.endswith("/1")
                and self.feeds_batchnorm(k.rsplit("/", 1)[0])}

    def laned_blobs(self, laned_data: bool = False) -> set:
        """The blobs `apply(lanes=C)` returns laned, the lane axis folded
        in: every top of a layer with params or a laned bottom and every
        top a layer draws from the forward key (Layer.laned_tops), the
        rest (blobs computed from the data alone) shared by every lane;
        with `laned_data` the data tops and everything after them."""
        laned = set()
        for layer in self.layers:
            if layer.is_data_source:
                if laned_data:
                    laned.update(layer.lp.top)
                continue
            outs = layer.laned_tops([b in laned for b in layer.lp.bottom])
            for t, out in zip(layer.lp.top, outs):
                (laned.add if out else laned.discard)(t)
        return laned

    def lanes_first(self, name: str, v: torch.Tensor, lanes: int,
                    laned: bool) -> torch.Tensor:
        """Blob `name` as apply(lanes=C) returns it, with the lanes on a
        leading axis, (C,) + its per-config shape; a blob no lane
        changes is repeated for every lane."""
        shape = tuple(self.blob_shapes[name])
        if not laned:
            return v.unsqueeze(0).expand((lanes,) + tuple(v.shape))
        if shape == ():
            return v
        return v.reshape((shape[0], lanes) + shape[1:]).movedim(1, 0)

    def init(self, key) -> dict:
        """Draw every owner layer's parameters from the threefry key
        `key` (core/prng.py) on the net's device, in layer order: each
        owner layer takes `key, sub = split(key)` and draws from `sub`,
        as the reference's Net.init does. A layer whose prototxt carries
        blobs (a net read from a `.caffemodel`) takes them instead; it
        still consumes its split, so the other layers draw the same
        values either way."""
        params = {}
        for layer in self.layers:
            n = layer.num_params()
            if n == 0:
                continue
            slots = self._layer_slots[layer.name]
            owns = [i for i in range(n) if slots[i] == (layer.name, i)]
            if not owns:
                continue
            key, sub = prng.split(key)
            blobs = layer.init_params(sub, self.device)
            if layer.lp.blobs:
                blobs = [torch.from_numpy(blob_to_array(b).astype(
                    np.float32).reshape(tuple(d.shape))).to(self.device)
                    for b, d in zip(layer.lp.blobs, blobs)]
            params[layer.name] = [blobs[i] if i in owns else None
                                  for i in range(n)]
        return params

    def _gather_layer_params(self, params, layer) -> list:
        return [params[owner][slot]
                for owner, slot in self._layer_slots[layer.name]]

    def apply(self, params, batch: Optional[dict] = None, rng=None,
              adc_bits: int = 0, crossbar: Optional[dict] = None,
              lanes: int = 0, tiles: Optional[dict] = None,
              conv_im2col: Optional[str] = None, with_updates: bool = False,
              probes: Optional[dict] = None,
              trace_sites: Optional[dict] = None,
              laned_data: bool = False):
        """Run the net; returns (blobs, loss), or (blobs, loss,
        new_params) `with_updates`: `params` with the forward-state
        updates (BatchNorm's moving statistics) in place of the layers'
        lists, the tensors passed in untouched. `batch` feeds the
        data-source tops; `rng` is the forward key (a core/prng.py key
        (2,), or (C, 2) under `lanes`, lane c's in row c) that Dropout in
        TRAIN and random DummyData draw from (None: such a layer raises);
        `crossbar` routes named fault-target layers
        through the crossbar read, `tiles` names the layers read through
        tiles and `conv_im2col` their conv operand mode (see
        LayerContext).

        `lanes` = C > 0 runs C configs at once (the sweep): every param
        carries a leading C axis, the batch is shared, and a blob
        computed from params is "laned": a per-config blob of shape
        (d0, d1, ...) is held as (d0, C*d1, ...), lane-major along axis
        1, and a per-config scalar (a loss) as (C,). The loss is then
        one value per lane, (C,). With `laned_data` each lane reads its
        own samples: the batch's tops come laned, a per-config (d0, d1,
        ...) as (d0, C*d1, ...) and a per-config (d0,) (labels) as
        (d0, C).

        The `debug_info` capture points (observe/debug.py; both off by
        default, and then nothing is added): `probes` maps (layer, top)
        production sites to zero tensors added to that top as it is
        produced, so the gradient with respect to a probe is the blob's
        cotangent at that site; `trace_sites`, a dict, receives the
        mean-abs of every computed top under the same site, and of
        every fed data top under ("__data__", top) when it is fed (per
        lane under `lanes`)."""
        batch = batch or {}
        if trace_sites is not None:
            from ..observe.debug import blob_mean_abs
        if rng is not None:
            rng = np.asarray(rng, dtype=np.uint32)
            if rng.shape != ((lanes, 2) if lanes else (2,)):
                raise ValueError(
                    f"the forward key is {((lanes, 2) if lanes else (2,))} "
                    f"uint32 at lanes={lanes}, got shape {rng.shape}")
        ctx = LayerContext(phase=self.phase, rng=rng, device=self.device,
                           adc_bits=adc_bits,
                           crossbar=crossbar, lanes=lanes, tiles=tiles,
                           conv_im2col=conv_im2col,
                           updates={} if with_updates else None)
        blobs = {}
        laned = set()
        for name in self.data_source_tops:
            if name in batch:
                blobs[name] = batch[name]
                if laned_data:
                    laned.add(name)
                if trace_sites is not None:
                    # captured when fed: an in-place layer on a data top
                    # must not alias the data layer's own line
                    trace_sites[("__data__", name)] = blob_mean_abs(
                        batch[name], lanes, laned_data)
        for layer in self.layers:
            if layer.is_data_source:
                continue
            for b in layer.lp.bottom:
                if b not in blobs:
                    raise ValueError(f"batch missing data blob {b!r}")
            ctx.laned = tuple(b in laned for b in layer.lp.bottom)
            tops_laned = (layer.laned_tops(ctx.laned) if lanes
                          else [False] * len(layer.lp.top))
            if any(tops_laned) and layer.lane_rule is None:
                raise NotImplementedError(
                    f"layer {layer.name!r} ({layer.type_name}) has no "
                    "config-lane rule yet")
            tops = layer.apply(self._gather_layer_params(params, layer),
                               [blobs[b] for b in layer.lp.bottom], ctx)
            for t, v, out_laned in zip(layer.lp.top, tops, tops_laned):
                if probes is not None:
                    probe = probes.get((layer.name, t))
                    if probe is not None:
                        v = v + probe.to(v.dtype)
                if trace_sites is not None:
                    trace_sites[(layer.name, t)] = blob_mean_abs(
                        v, lanes, out_laned, self.blob_shapes[t] == ())
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
        if with_updates:
            new_params = {ln: list(vals) for ln, vals in params.items()}
            new_params.update(ctx.updates)
            return blobs, loss, new_params
        return blobs, loss

    def copy_trained_from(self, params, source) -> dict:
        """Name-matched weight loading (net.cpp:765 CopyTrainedLayersFrom):
        every blob of a `source` layer (a NetParameter with blobs, or a
        path to one) whose name this net has replaces that slot, reshaped
        to it. Returns new params; `params` is not changed."""
        if isinstance(source, str):
            source = read_net_param(source)
        params = {ln: list(v) for ln, v in params.items()}
        for lp in source.layer:
            target = params.get(lp.name)
            if lp.name not in self.layer_by_name or not lp.blobs \
                    or target is None:
                continue
            for i, b in enumerate(lp.blobs):
                if i >= len(target) or target[i] is None:
                    continue
                arr = blob_to_array(b).reshape(tuple(target[i].shape))
                target[i] = torch.as_tensor(arr, dtype=target[i].dtype,
                                            device=target[i].device)
        return params

    def to_proto(self, params) -> proto.Message:
        """The layer definitions with `params` as their blobs (net.cpp
        ToProto): what a `.caffemodel` holds."""
        out = proto.Message("NetParameter")
        out.name = self.name or ""
        for layer in self.layers:
            lp = layer.lp.copy()
            lp.ClearField("blobs")
            for t in params.get(layer.name, ()):
                if t is not None:
                    lp.blobs.append(array_to_blob(t.detach().cpu().numpy()))
            out.layer.append(lp)
        return out
