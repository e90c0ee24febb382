"""Layer contract and registry (counterpart of the reference package's
core/registry.py; reference layer.hpp:33 and layer_factory.hpp:56-137).
A layer is configured from its LayerParameter, resolves static shapes
in `setup`, draws its parameters in `init_params`, and computes its
tops in `apply` on tensors; autograd differentiates `apply`.

Forward state (BatchNorm's moving statistics, which the reference's
`apply` returns as new params): a layer with `updates_state` writes the
replacement values of its params into `ctx.updates[name]` when the
caller asked for them (`ctx.updates` is a dict, else None); it never
writes into the param tensors.

The forward key (`ctx.rng`, a core/prng.py key (2,), or (C, 2) under
config lanes) feeds the layers that draw: Dropout in TRAIN and a
DummyData top with a random filler. Such a layer names the tops it
draws (`draws_tops`); under lanes each of them is laned, each lane
drawing from its own key, whatever its bottoms are."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

LAYER_REGISTRY: dict = {}


def register_layer(name: str) -> Callable[[type], type]:
    def wrap(cls: type) -> type:
        if name in LAYER_REGISTRY:
            raise KeyError(f"Layer type {name!r} registered twice")
        LAYER_REGISTRY[name] = cls
        cls.type_name = name
        return cls
    return wrap


def create_layer(layer_param, phase: int) -> "Layer":
    t = layer_param.type
    if t not in LAYER_REGISTRY:
        raise KeyError(
            f"Layer type {t!r} (layer {layer_param.name!r}) is not ported; "
            f"ported: {sorted(LAYER_REGISTRY)}")
    return LAYER_REGISTRY[t](layer_param, phase)


@dataclasses.dataclass
class LayerContext:
    """Per-forward context threaded through every layer apply."""
    phase: int
    # the forward key (core/prng.py): (2,) uint32, (C, 2) under lanes (lane
    # c's key in row c); None = no key (a layer that draws raises)
    rng: Any = None
    # the net's device: where a layer that makes a top from no bottom
    # (DummyData) puts it
    device: Any = None
    # Hardware-aware ADC model (RRAMForwardParameter.adc_bits): when
    # nonzero, crossbar (InnerProduct) layers quantize their output.
    adc_bits: int = 0
    # Crossbar read: fault-target layer name -> (broken, stuck, seed,
    # sigma, q_bits, use_kernel); the layer computes its matmul through
    # fault/hw_aware.crossbar_matmul, whose forward is kernel B2 when
    # use_kernel is set (its plain version otherwise). Under config
    # lanes the seed is a (C,) int32 tensor, one per lane.
    crossbar: Optional[dict] = None
    # Config lanes (the sweep): 0 = one config; C > 0 = every learnable
    # param carries a leading C axis and a "laned" blob holds C configs'
    # values (Net's docstring gives the layout). `laned` flags, per
    # bottom of the layer being applied, which bottoms are laned.
    lanes: int = 0
    laned: tuple = ()
    # Tiled crossbar mapping (fault/mapping.py): layer name -> (tr, tc)
    # cells per tile, over the stored weight for InnerProduct, over the
    # im2col (K, N) view for Convolution; only layers spanning more than
    # one tile are named. Such a layer reads through per-tile ADCs.
    tiles: Optional[dict] = None
    # The conv operand mode of a tiled Convolution: "premat" (patch rows
    # built once), "tilewise" (per K-tile) or "implicit" (gathered
    # through the address plan; kernel B3); None = "premat". The solver
    # resolves it (its argument, RRAM_CONV_IM2COL, the kernel path's
    # rules); the layer only reads it.
    conv_im2col: Optional[str] = None
    # Forward-state updates (Net.apply(with_updates=True)): layer name ->
    # the replacement values of its params, detached; None = not asked.
    updates: Optional[dict] = None


@dataclasses.dataclass
class ParamSpec:
    name: str = ""
    lr_mult: float = 1.0
    decay_mult: float = 1.0


class Layer:
    type_name = "?"
    is_data_source = False
    # loss layers may omit `top:` (layer.hpp AutoTopBlobs)
    auto_top_blobs = False
    fault_target = False
    # how the layer meets config lanes (Net.apply): "any" = its apply is
    # per channel and runs on a laned blob unchanged; "own" = its apply
    # reads ctx.lanes/ctx.laned; None = no lane rule (raises under lanes
    # when it has params or a laned bottom)
    lane_rule: Optional[str] = None
    # whether apply reports forward-state updates (ctx.updates)
    updates_state = False

    def __init__(self, layer_param, phase: int):
        self.lp = layer_param
        self.phase = phase
        self.name = layer_param.name
        self.top_shapes: list = []

    def setup(self, bottom_shapes: Sequence[tuple]) -> list:
        raise NotImplementedError

    def init_params(self, key, device="cpu") -> list:
        """The layer's params drawn from the threefry key `key` (a
        core/prng.py key) on `device`."""
        return []

    def param_specs(self) -> list:
        """One spec per param blob; pads/truncates lp.param like Caffe."""
        specs = []
        for i in range(self.num_params()):
            if i < len(self.lp.param):
                p = self.lp.param[i]
                specs.append(ParamSpec(p.name, p.lr_mult, p.decay_mult))
            else:
                specs.append(ParamSpec())
        return specs

    def num_params(self) -> int:
        return 0

    def apply(self, params: Sequence[Any], bottoms: Sequence[Any],
              ctx: LayerContext) -> list:
        raise NotImplementedError

    def default_loss_weight(self, top_index: int) -> float:
        return 0.0

    def draws_tops(self) -> tuple:
        """Per top, whether apply draws it from the forward key ctx.rng;
        () = none."""
        return ()

    def laned_tops(self, laned_bottoms: Sequence[bool]) -> list:
        """Per top, whether it is laned under config lanes: every top of
        a layer with params or a laned bottom, and each top the layer
        draws (each lane draws its own, from a shared bottom or from
        none)."""
        base = any(laned_bottoms) or self.num_params() > 0
        draws = self.draws_tops()
        return [base or (i < len(draws) and bool(draws[i]))
                for i in range(len(self.lp.top))]

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


# ---------------------------------------------------------------------------
# the fault-process registry (fault/processes/): the string -> class seam
# the layer registry gives the net, for fault physics; a new
# fault model is a registration, not a solver edit (the reference's
# core/registry.py:47-68)

FAULT_PROCESS_REGISTRY: dict = {}


def register_fault_process(name: str) -> Callable[[type], type]:
    def wrap(cls: type) -> type:
        if name in FAULT_PROCESS_REGISTRY:
            raise KeyError(f"Fault process {name!r} registered twice")
        FAULT_PROCESS_REGISTRY[name] = cls
        cls.process_name = name
        return cls
    return wrap


def create_fault_process(name: str, params: Optional[dict] = None):
    """The process registered as `name`, built from its spec parameters
    (a FaultSpec entry's `k=v` dict)."""
    if name not in FAULT_PROCESS_REGISTRY:
        raise KeyError(
            f"Unknown fault process {name!r}; registered: "
            f"{sorted(FAULT_PROCESS_REGISTRY)}")
    return FAULT_PROCESS_REGISTRY[name](params or {})
