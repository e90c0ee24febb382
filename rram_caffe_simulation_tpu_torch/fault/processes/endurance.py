"""`endurance_stuck_at`, the fork's fault model (failure_maker.cpp/.cu),
behind the process interface (counterpart of the reference package's
fault/processes/endurance.py).

Every hook delegates to the engine functions the solver called before
the registry (engine.init_fault_state, draw_rescaled_state, fail,
packed.fail_packed), so the default stack draws, steps and writes what
the port did without it, byte for byte.
"""
from __future__ import annotations

from ...core.registry import register_fault_process
from .. import engine as fault_engine
from .. import packed as fault_packed
from .base import FaultProcess


@register_fault_process("endurance_stuck_at")
class EnduranceStuckAt(FaultProcess):
    """Per-cell lifetimes ~ N(mean, std) lose the write quantum on every
    written step (|diff| >= 1e-20); an expired cell clamps to its stuck
    value in {-1, 0, +1} for good (FailKernel, failure_maker.cu:23-40)."""

    phase = "clamp"
    has_lifetimes = True
    supports_packed = True
    #: kernel B1 decrements on written steps only
    fused_mode = "write"
    param_names = ()

    def init_state(self, key, shapes, pattern, tiles=None, device="cpu"):
        return fault_engine.init_fault_state(key, shapes, pattern,
                                             tiles=tiles, device=device)

    def draw_rescaled(self, key, shapes, pattern, mean, std, tiles=None,
                      device="cpu"):
        return fault_engine.draw_rescaled_state(key, shapes, pattern, mean,
                                                std, tiles=tiles,
                                                device=device)

    def fail(self, fault_params, state, fault_diffs, decrement):
        return fault_engine.fail(fault_params, state, fault_diffs,
                                 decrement)

    def fail_packed(self, fault_params, state, fault_diffs, pack_spec):
        return fault_packed.fail_packed(fault_params, state, fault_diffs,
                                        pack_spec)
