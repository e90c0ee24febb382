"""`read_disturb`: read-stress wear, every crossbar read costs lifetime,
so cells expire on the forward pass's clock (counterpart of the
reference package's fault/processes/read_disturb.py).

Each forward pass reads every cell of a fault-target matrix once a
sample, so a step's reads are the batch size, the quantity the fork's
write decrement hard-codes (failure_maker.cpp:75): ``reads_per_step``
defaults to the solver's write quantum and can be set per process
(``read_disturb:reads_per_step=400``). The state is the endurance
family's (lifetimes ~ N(mean, std), stuck values in {-1, 0, +1}); the
decrement lands every step, written or not.

Packed banks: the counters hold ``ceil(lifetime / reads_per_step)``,
decremented by 1 every step (kernel B1's mode "always").
"""
from __future__ import annotations

import torch

from ...core.registry import register_fault_process
from .. import engine as fault_engine
from .. import packed as fault_packed
from .base import FaultProcess, float_param


@register_fault_process("read_disturb")
class ReadDisturb(FaultProcess):

    phase = "clamp"
    has_lifetimes = True
    supports_packed = True
    #: kernel B1 decrements every step: every step reads
    fused_mode = "always"
    param_names = ("reads_per_step",)

    def __init__(self, params=None):
        super().__init__(params)
        self.reads_per_step = self.params.get("reads_per_step")
        if self.reads_per_step is not None:
            self.reads_per_step = float_param(self.params, "reads_per_step",
                                              0.0)
            if not self.reads_per_step > 0:
                raise ValueError(
                    f"read_disturb reads_per_step must be > 0, got "
                    f"{self.reads_per_step!r}")

    def _reads(self, decrement: float) -> float:
        # default: the reads a step = the batch rows of a forward = the
        # solver's write quantum
        return (self.reads_per_step if self.reads_per_step is not None
                else float(decrement))

    def write_quantum(self, decrement: float) -> float:
        return self._reads(decrement)

    def init_state(self, key, shapes, pattern, tiles=None, device="cpu"):
        return fault_engine.init_fault_state(key, shapes, pattern,
                                             tiles=tiles, device=device)

    def draw_rescaled(self, key, shapes, pattern, mean, std, tiles=None,
                      device="cpu"):
        return fault_engine.draw_rescaled_state(key, shapes, pattern, mean,
                                                std, tiles=tiles,
                                                device=device)

    def fail(self, fault_params, state, fault_diffs, decrement):
        reads = self._reads(decrement)
        new_params, new_life = {}, {}
        for name, data in fault_params.items():
            life = state["lifetimes"][name]
            # the read happens whether or not the step wrote the cell
            life2 = torch.where(life > 0, life - reads, life)
            new_params[name] = torch.where(life2 <= 0,
                                           state["stuck"][name], data)
            new_life[name] = life2
        return new_params, {**state, "lifetimes": new_life}

    def fail_packed(self, fault_params, state, fault_diffs, pack_spec):
        return fault_packed.fail_packed(fault_params, state, fault_diffs,
                                        pack_spec, mode="always")
