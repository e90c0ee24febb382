"""The fault-process contract (counterpart of the reference package's
fault/processes/base.py): what a fault physics model provides to run
in the train step's Fail phase.

A process owns STATE GROUPS, named subtrees of the fault state with one
leaf per fault-target parameter, and a transform
``fail(params, state, diffs, decrement)`` applied at Fail
(solver.cpp:305). A stack merges the groups of its processes, so
everything keyed on the state tree (`engine.iter_state_leaves`, the
packed banks, checkpoints, the sweep's draws and lane refills) works for
any mix.

Two phases order a stack: ``decay`` processes (conductance drift) move
weight values and run first; ``clamp`` processes (the stuck-at family)
pin broken cells to their stuck values and run last, so a cell both
drifting and broken ends the step at its stuck value. A stack holds at
most one clamp process.

Keys are the port's host threefry keys (core/prng.py); a batch of keys
(C, 2) draws C states, each leaf with a leading C axis, and `mean`,
`std` are then (C,) arrays. Draws run on `device`.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .. import fused as fault_fused


def lane_count(t: torch.Tensor, lanes: int) -> torch.Tensor:
    """The sum of a boolean tensor, per lane under `lanes` (the leading
    axis), as int64."""
    t = t.reshape(lanes, -1) if lanes else t.reshape(-1)
    return t.sum(-1)


class FaultProcess:
    """Base fault process. Subclasses register with
    ``core.registry.register_fault_process`` and implement the state and
    transform hooks below. ``params`` is the spec's parameter dict
    (``name:key=value,...``); an unknown key raises at construction."""

    process_name = "?"
    #: "decay" processes run before "clamp" processes in a stack
    phase = "clamp"
    #: whether the process carries the lifetimes/stuck groups (the clamp
    #: family): the census and the strategies read them
    has_lifetimes = False
    #: whether its state survives the packed banks (fault/packed.py:
    #: lifetime counters and 2-bit stuck codes; other f32 groups ride
    #: along untouched)
    supports_packed = False
    #: kernel B1's decrement mode for this process ("write", "always" or
    #: "never"), or None when its transform is not the fused kernel's
    #: subtract, counter decrement and clamp
    fused_mode: Optional[str] = None
    #: the parameter names the process accepts
    param_names: Tuple[str, ...] = ()

    def __init__(self, params: Optional[dict] = None):
        params = dict(params or {})
        unknown = set(params) - set(self.param_names)
        if unknown:
            raise ValueError(
                f"fault process {self.process_name!r} does not accept "
                f"parameter(s) {sorted(unknown)}; known: "
                f"{sorted(self.param_names)}")
        self.params = params

    # --- state ---------------------------------------------------------
    def init_state(self, key, shapes: Dict[str, tuple], pattern,
                   tiles=None, device="cpu") -> dict:
        """Draw this process's state groups for the fault-target shapes;
        `tiles` (a mapping.TileSpec or None) draws each crossbar tile of
        a >= 2-D param from its own folded key."""
        raise NotImplementedError

    def draw_rescaled(self, key, shapes: Dict[str, tuple], pattern, mean,
                      std, tiles=None, device="cpu") -> dict:
        """One independent per-config draw with the lifetimes re-anchored
        to (mean, std): the sweep's per-lane draw and a lane refill's.
        A process without lifetimes ignores (mean, std)."""
        raise NotImplementedError

    # --- the in-step transform ----------------------------------------
    def fail(self, fault_params: Dict[str, torch.Tensor], state: dict,
             fault_diffs: Dict[str, torch.Tensor], decrement: float):
        """One fault step: (params', state'). `decrement` is the solver's
        write quantum (fail_decrement)."""
        raise NotImplementedError

    def fail_packed(self, fault_params, state, fault_diffs,
                    pack_spec: dict):
        """`fail` on the packed banks; only called when
        `supports_packed`."""
        raise NotImplementedError(
            f"fault process {self.process_name!r} has no packed-state "
            "path (supports_packed is False)")

    def fail_fused(self, fault_params, state, fault_diffs, pack_spec: dict):
        """ApplyUpdate + Fail as kernel B1 in this process's mode, one
        launch for every leaf (`fault/fused.py fused_tail`; the
        reference's launches once a leaf): `fault_params` holds the
        values BEFORE the update, `fault_diffs` the updates. Equal to
        ``data - diff`` then `fail_packed`."""
        if self.fused_mode is None:
            raise NotImplementedError(
                f"fault process {self.process_name!r} has no fused "
                "epilogue (fused_mode is None)")
        fn = functools.partial(fault_fused.fused_update_fail_leaves,
                               mode=self.fused_mode)
        return fault_fused.fused_tail(fn, list(fault_params), fault_params,
                                      fault_diffs, state)

    # --- telemetry ----------------------------------------------------
    def counters(self, state: dict, life_view: Dict[str, torch.Tensor],
                 lanes: int = 0) -> dict:
        """This process's entries in the step's metrics tree
        (`fault.per_process`), device tensors, per lane under `lanes`.
        `life_view` is the f32 lifetimes view ({} without a clamp
        process). The clamp family's default: the broken count."""
        if not self.has_lifetimes:
            return {}
        broken = None
        for v in life_view.values():
            c = lane_count(v <= 0, lanes)
            broken = c if broken is None else broken + c
        return {"broken": broken}

    def health(self, state: dict, life_view: Dict[str, torch.Tensor],
               stuck_view: Dict[str, torch.Tensor], tiles, edges: dict,
               ndims: Dict[str, int]) -> dict:
        """This process's per-(param, tile) wear census
        (observe/health.py): {param: {stat: tensor}}, the stats of a
        stack's processes disjoint. `edges` holds the bin layouts
        ({"life": ..., "age": ...}), `ndims` each fault target's stored
        rank. The clamp family's default: the lifetime and stuck
        census."""
        if not self.has_lifetimes:
            return {}
        from .. import mapping as fault_mapping
        return {name: fault_mapping.per_tile_health(
                    life_view[name], stuck_view[name], tiles,
                    edges["life"], ndims[name])
                for name in sorted(life_view)}

    # --- packing -------------------------------------------------------
    def write_quantum(self, decrement: float) -> float:
        """The lifetime quantum the packed counter banks divide by: the
        solver's write decrement, or the per-step amount of a process
        whose clock runs otherwise (read disturb)."""
        return float(decrement)

    # --- the spec -------------------------------------------------------
    def canonical_params(self) -> str:
        """``k=v,...`` of the given params, sorted keys, %g floats: what
        two specs are compared by."""
        parts = []
        for k in sorted(self.params):
            v = self.params[k]
            parts.append(f"{k}={v:g}" if isinstance(v, float)
                         else f"{k}={v}")
        return ",".join(parts)

    def canonical(self) -> str:
        p = self.canonical_params()
        return f"{self.process_name}:{p}" if p else self.process_name

    def __repr__(self):
        return f"<{type(self).__name__} {self.canonical()!r}>"


def float_param(params: dict, name: str, default: float) -> float:
    """A spec parameter as a float (a spec value is a str or a
    number)."""
    v = params.get(name, default)
    try:
        return float(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"fault-process parameter {name}={v!r} is not a number"
        ) from None
