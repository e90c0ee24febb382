"""Fault processes (counterpart of the reference package's
fault/processes/): each fault physics model is a `FaultProcess`
registered by name (core/registry.py), and a `FaultSpec` selects and
parameterizes a process STACK that runs in the train step's Fail phase:

    endurance_stuck_at                      # the fork's model (default)
    conductance_drift:nu=0.2,sigma=0.1      # retention loss
    read_disturb:reads_per_step=400         # read-stress wear
    permanent_fault_map:fraction=0.05       # static defect maps
    endurance_stuck_at+conductance_drift    # a composed stack

Spec syntax: `name[:k=v[,k=v...]]` joined by `+`. A stack takes a fixed
order (decay processes first, the clamp family last, then by name) and
a canonical string, which the sweep checkpoint's meta (v5) and the
driver's run-dir manifest pin, so a resume under another process is
refused instead of replaying the wrong physics.

Every process owns its state groups in the one fault state, so
`engine.iter_state_leaves`, the packed banks, checkpoints, the sweep's
per-config draws and the lane refills work for any stack.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ...core import prng
from ...core.registry import (FAULT_PROCESS_REGISTRY, create_fault_process,
                              register_fault_process)
from ..mapping import TileSpec
from .base import FaultProcess
# importing the built-ins registers them
from .endurance import EnduranceStuckAt
from .drift import ConductanceDrift
from .read_disturb import ReadDisturb
from .permanent import PermanentFaultMap

DEFAULT_PROCESS = "endurance_stuck_at"


def _parse_value(text: str):
    try:
        return float(text)
    except ValueError:
        return text


class FaultSpec:
    """A parsed stack selection, [(name, params), ...]. `parse` takes the
    spec syntax, `build` the ProcessStack, `canonical()` the normalized
    string two specs are compared by (sorted params, the stack's order),
    `to_model()` the setup record's `fault_model`."""

    def __init__(self, processes: List[Tuple[str, dict]]):
        if not processes:
            raise ValueError("FaultSpec needs at least one process")
        self.processes = [(str(n), dict(p)) for n, p in processes]

    @classmethod
    def parse(cls, text) -> "FaultSpec":
        if isinstance(text, FaultSpec):
            return text
        if text is None or not str(text).strip():
            text = DEFAULT_PROCESS
        procs = []
        for part in str(text).split("+"):
            part = part.strip()
            if not part:
                raise ValueError(
                    f"empty process entry in fault spec {text!r}")
            name, _, ptext = part.partition(":")
            name = name.strip()
            params = {}
            if ptext.strip():
                for kv in ptext.split(","):
                    k, sep, v = kv.partition("=")
                    if not sep or not k.strip():
                        raise ValueError(
                            f"bad parameter {kv!r} in fault spec "
                            f"{text!r} (expected key=value)")
                    params[k.strip()] = _parse_value(v.strip())
            procs.append((name, params))
        return cls(procs)

    def build(self, tiles=None) -> "ProcessStack":
        """The ProcessStack; `tiles` (a mapping.TileSpec) is the tile
        mapping every draw of the stack follows (None or 1x1: untiled)."""
        return ProcessStack([create_fault_process(n, p)
                             for n, p in self.processes], tiles=tiles)

    def canonical(self) -> str:
        return self.build().canonical()

    def to_model(self) -> dict:
        """The `setup` record's `fault_model`: the canonical spec and each
        process's given params."""
        stack = self.build()
        model = {"spec": stack.canonical()}
        params = {p.process_name: dict(p.params)
                  for p in stack.processes if p.params}
        if params:
            model["processes"] = params
        return model

    def __repr__(self):
        return f"FaultSpec({self.canonical()!r})"


class ProcessStack:
    """An ordered, checked composition of fault processes sharing one
    fault state: decay first, clamp last, at most one clamp process
    (two lifetime clocks over the same cells do not compose), the state
    groups disjoint."""

    def __init__(self, processes: List[FaultProcess], tiles=None):
        if not processes:
            raise ValueError("ProcessStack needs at least one process")
        self.tiles = None
        if tiles is not None:
            tiles = TileSpec.parse(tiles)
            if not tiles.is_default:
                self.tiles = tiles
        order = {"decay": 0, "clamp": 1}
        self.processes = sorted(
            processes, key=lambda p: (order.get(p.phase, 2),
                                      p.process_name))
        names = [p.process_name for p in self.processes]
        if len(set(names)) != len(names):
            raise ValueError(
                f"fault process listed twice in stack: {names}")
        clamps = [p for p in self.processes if p.phase == "clamp"]
        if len(clamps) > 1:
            raise ValueError(
                "a fault-process stack supports at most one clamp "
                "(lifetime-bearing) process; got "
                f"{[p.process_name for p in clamps]}")

    # --- static properties --------------------------------------------
    @property
    def has_lifetimes(self) -> bool:
        return any(p.has_lifetimes for p in self.processes)

    @property
    def supports_packed(self) -> bool:
        return (self.has_lifetimes
                and all(p.supports_packed for p in self.processes))

    def unpackable(self) -> List[str]:
        """The processes that keep the stack off the packed banks ([]
        when it supports them)."""
        if not self.has_lifetimes:
            return [p.process_name for p in self.processes]
        return [p.process_name for p in self.processes
                if not p.supports_packed]

    @property
    def supports_fused_epilogue(self) -> bool:
        """Whether ApplyUpdate + Fail can run as kernel B1: one process
        with a `fused_mode`. A stack of more never fuses: a decay
        process moves weight values between the update and the clamp,
        which the kernel's subtract, decrement and clamp cannot do."""
        return (len(self.processes) == 1
                and self.processes[0].fused_mode is not None)

    @property
    def fused_mode(self):
        """Kernel B1's mode for this stack, or None when it cannot
        fuse."""
        return (self.processes[0].fused_mode
                if self.supports_fused_epilogue else None)

    def fused_unsupported_reason(self) -> str:
        """Why the fused epilogue cannot engage ('' when it can)."""
        if self.supports_fused_epilogue:
            return ""
        if len(self.processes) > 1:
            return (f"multi-process stack {self.canonical()!r} (decay "
                    "runs between update and clamp)")
        return (f"process {self.processes[0].process_name!r} declares "
                "no fused_mode")

    def write_quantum(self, decrement: float) -> float:
        for p in self.processes:
            if p.has_lifetimes:
                return p.write_quantum(decrement)
        return float(decrement)

    def canonical(self) -> str:
        return "+".join(p.canonical() for p in self.processes)

    # --- state ---------------------------------------------------------
    def _merge(self, parts: List[dict]) -> dict:
        state: dict = {}
        for st in parts:
            for group in st:
                if group in state:
                    raise ValueError(
                        f"fault-process state group {group!r} declared "
                        "by two processes in the stack")
            state.update(st)
        return state

    def _keys(self, key):
        # process 0 takes the raw key, so the default stack draws the
        # state the engine draws
        return [key if i == 0 else prng.fold_in(key, i)
                for i in range(len(self.processes))]

    def init_state(self, key, shapes: Dict[str, tuple], pattern,
                   device="cpu") -> dict:
        return self._merge([
            p.init_state(k, shapes, pattern, tiles=self.tiles,
                         device=device)
            for p, k in zip(self.processes, self._keys(key))])

    def draw_rescaled(self, key, shapes: Dict[str, tuple], pattern, mean,
                      std, device="cpu") -> dict:
        return self._merge([
            p.draw_rescaled(k, shapes, pattern, mean, std,
                            tiles=self.tiles, device=device)
            for p, k in zip(self.processes, self._keys(key))])

    # --- the in-step transform ----------------------------------------
    def fail(self, fault_params, state, fault_diffs, decrement):
        for p in self.processes:
            fault_params, state = p.fail(fault_params, state, fault_diffs,
                                         decrement)
        return fault_params, state

    def fail_packed(self, fault_params, state, fault_diffs, pack_spec):
        for p in self.processes:
            fault_params, state = p.fail_packed(fault_params, state,
                                                fault_diffs, pack_spec)
        return fault_params, state

    def fail_fused(self, fault_params, state, fault_diffs, pack_spec):
        """ApplyUpdate + Fail as kernel B1 (`fault_params` holds the
        values before the update); only when `supports_fused_epilogue`."""
        if not self.supports_fused_epilogue:
            raise ValueError("fused epilogue unsupported: "
                             + self.fused_unsupported_reason())
        return self.processes[0].fail_fused(fault_params, state,
                                            fault_diffs, pack_spec)

    # --- telemetry ----------------------------------------------------
    def counters(self, state, life_view, lanes: int = 0) -> dict:
        out = {}
        for p in self.processes:
            c = p.counters(state, life_view, lanes)
            if c:
                out[p.process_name] = c
        return out

    def health(self, state, life_view, stuck_view, edges, ndims) -> dict:
        """The stack's per-(param, tile) wear census: each process's
        stats under the shared param keys (disjoint stat names)."""
        out: dict = {}
        for p in self.processes:
            h = p.health(state, life_view, stuck_view, self.tiles, edges,
                         ndims)
            for name, stats in h.items():
                out.setdefault(name, {}).update(stats)
        return out

    def __repr__(self):
        return f"<ProcessStack {self.canonical()!r}>"


__all__ = [
    "FaultProcess", "FaultSpec", "ProcessStack", "DEFAULT_PROCESS",
    "FAULT_PROCESS_REGISTRY", "register_fault_process",
    "create_fault_process", "EnduranceStuckAt", "ConductanceDrift",
    "ReadDisturb", "PermanentFaultMap",
]
