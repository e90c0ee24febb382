"""Layer contract and registry (counterpart of the reference package's
core/registry.py; reference layer.hpp:33 and layer_factory.hpp:56-137).
A layer is configured from its LayerParameter, resolves static shapes
in `setup`, draws its parameters in `init_params`, and computes its
tops in `apply` on tensors; autograd differentiates `apply`."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

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

    def __init__(self, layer_param, phase: int):
        self.lp = layer_param
        self.phase = phase
        self.name = layer_param.name
        self.top_shapes: list = []

    def setup(self, bottom_shapes: Sequence[tuple]) -> list:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator) -> list:
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

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
