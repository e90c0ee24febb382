"""Carrying a state between the reference package and the port.

The port draws what the reference draws: core/prng.py is the reference's
threefry key chain, so a Solver built from the same prototxt and
`random_seed` holds the reference's params, fault state and crossbar
seeds, bit for bit on the CPU (normal included: 0 of 2 x (2^20 + 3)
draws differ, tests/test_torch_prng.py) and on the card alike
(chip_smoke.py phase 13). A state one package reached crosses to the
other on disk, in either direction: a sweep's checkpoint
(`SweepRunner.checkpoint` / `restore`, the v6 .npz) and a Solver's
snapshot (`.caffemodel`, `.solverstate`, `.faultstate`) are the same
files in both packages. The converters here carry a state in memory,
where a parity test needs identical inputs that did not come from a
seed:

- params: {layer name: [array, ...]} in Caffe layout (None for a shared
  slot) on both sides, numpy there, tensors here; BatchNorm's three
  blobs (mean, variance, scale_factor) and Scale's two are params like
  any other;
- fault state: {"lifetimes": {...}, "stuck": {...}} (f32) or the packed
  {"life_q": {...}, "stuck_bits": {...}}, keyed "layer/slot"; conv
  leaves (`conv_also`) keep their stored 4-D shape in both packages
  (the packed banks along the last axis), tiled or not, so they need no
  format of their own.

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
