"""Carrying one init between the reference package and the port.

The two packages draw from different generators (threefry vs
torch.Generator), so a parity run draws once, in the reference, and
carries the draw across:

- params: {layer name: [array, ...]} in Caffe layout (None for a shared
  slot) on both sides, numpy there, tensors here;
- fault state: {"lifetimes": {...}, "stuck": {...}} (f32) or the packed
  {"life_q": {...}, "stuck_bits": {...}}, keyed "layer/slot".

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
