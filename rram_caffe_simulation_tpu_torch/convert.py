"""Carrying one init between the reference package and the port.

The two packages draw from different generators (threefry vs
torch.Generator), so a parity run draws once, in the reference, and
carries the draw across:

- params: {layer name: [array, ...]} in Caffe layout (None for a shared
  slot) on both sides, numpy there, tensors here;
- fault state: {"lifetimes": {...}, "stuck": {...}} (f32) or the packed
  {"life_q": {...}, "stuck_bits": {...}}, keyed "layer/slot".

- a sweep's state: the same, every leaf with a leading config axis,
  plus the SGD history {"layer/slot": {"h": array}}
  (`sweep_state_from_jax` / `sweep_state_to_jax`).

The inverses serve the tests.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def params_from_jax(params: Dict[str, List[Optional[np.ndarray]]],
                    device="cpu") -> Dict[str, list]:
    """Reference params (numpy or any array-like) -> the port's."""
    return {ln: [None if a is None else
                 torch.from_numpy(np.array(a, copy=True)).to(device)
                 for a in vals]
            for ln, vals in params.items()}


def params_to_jax(params: Dict[str, list]) -> Dict[str, list]:
    """The port's params -> numpy arrays, as the reference holds them."""
    return {ln: [None if t is None else t.detach().cpu().numpy()
                 for t in vals]
            for ln, vals in params.items()}


def fault_state_from_jax(state: Dict[str, Dict[str, np.ndarray]],
                         device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference fault state (f32 or packed, numpy) -> the port's,
    dtype for dtype (int16/int32 counters, uint8 banks)."""
    return {group: {k: torch.from_numpy(np.array(v, copy=True)).to(device)
                    for k, v in leaves.items()}
            for group, leaves in state.items()}


def fault_state_to_jax(state) -> Dict[str, Dict[str, np.ndarray]]:
    return {group: {k: v.detach().cpu().numpy() for k, v in leaves.items()}
            for group, leaves in state.items()}


def _same_layout(name, new, old):
    flat = lambda tree: {k: tuple(v.shape) for k, v in _leaves(tree)}
    if flat(new) != flat(old):
        raise ValueError(f"sweep state: {name} does not fit the runner "
                         f"(shapes {flat(new)} vs {flat(old)})")


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


def sweep_state_from_jax(runner, params, history, fault_states):
    """Load a reference SweepRunner's params, history and fault_states
    (numpy, config axis leading) into the port's `runner`, dtype for
    dtype; the layouts must match the runner's own."""
    dev = runner.device
    new_params = params_from_jax(params, dev)
    new_hist = {k: {s: torch.from_numpy(np.array(v, copy=True)).to(dev)
                    for s, v in slots.items()}
                for k, slots in history.items()}
    new_fault = fault_state_from_jax(fault_states, dev)
    for name, new, old in (("params", new_params, runner.params),
                           ("history", new_hist, runner.history),
                           ("fault_states", new_fault,
                            runner.fault_states)):
        _same_layout(name, new, old)
    runner.params, runner.history, runner.fault_states = \
        new_params, new_hist, new_fault


def sweep_state_to_jax(runner):
    """(params, history, fault_states) of a port SweepRunner as numpy,
    in the reference runner's layout."""
    return (params_to_jax(runner.params),
            {k: {s: v.detach().cpu().numpy() for s, v in slots.items()}
             for k, slots in runner.history.items()},
            fault_state_to_jax(runner.fault_states))
