"""Bit-packed fault-state banks (counterpart of the reference package's
fault/packed.py, bit for bit down to the bank bytes).

- ``life_q``: integer write counters ``ceil(lifetime / decrement)``,
  int16 when the (mean, std) range fits with a 12-sigma margin, else
  int32 (the 1e8 endurance point needs int32). One write decrements a
  counter by 1; a cell is broken iff its counter is <= 0.
- ``stuck_bits``: 2-bit stuck codes (value + 1 in {0, 1, 2}), four cells
  per uint8 along the last axis, the last byte zero-padded.

There is no broken-mask bank: broken is ``life_q <= 0``. Unpacking a
counter gives the mid-bin lifetime ``(q - 0.5) * decrement``, so every
zero comparison agrees with the counter's and pack(unpack(q)) == q.
Packing runs on the host (numpy, float64 division so the 1e8 point's
ceil lands on the right side); `fail_packed` and `unpacked_view` run on
the state's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import engine as fault_engine

PACKED_GROUPS = ("life_q", "stuck_bits")
LIFE_DTYPE_MARGIN = 12.0


def choose_life_dtype(means, stds, decrement: float) -> str:
    """"int16" when every (mean, std) keeps the write-count range inside
    int16 with a 12-sigma margin, else "int32" (analytic, so a later
    draw from the same spec can never overflow the bank)."""
    means = np.atleast_1d(np.asarray(means, np.float64))
    stds = np.atleast_1d(np.asarray(stds, np.float64))
    hi = float(np.max(means + LIFE_DTYPE_MARGIN * stds)) / decrement
    lo = float(np.min(means - LIFE_DTYPE_MARGIN * stds)) / decrement
    if -32000.0 < lo and hi < 32000.0:
        return "int16"
    return "int32"


def make_pack_spec(state, decrement: float, means=None, stds=None,
                   pattern=None) -> dict:
    """Static packing parameters: the write quantum, the counter dtype
    and each leaf's true last-axis length."""
    if means is None:
        means = [float(pattern.mean)] if pattern is not None else [0.0]
    if stds is None:
        stds = [float(pattern.std)] if pattern is not None else [0.0]
    return {
        "decrement": float(decrement),
        "life_dtype": choose_life_dtype(means, stds, decrement),
        "last_dim": {k: int(v.shape[-1])
                     for k, v in state["lifetimes"].items()},
    }


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def pack_lifetimes(life, decrement: float, dtype) -> np.ndarray:
    """f32 lifetimes -> integer write counters (host)."""
    q = np.ceil(np.asarray(_host(life), np.float64) / float(decrement))
    info = np.iinfo(np.dtype(dtype))
    if q.size and (q.min() < info.min or q.max() > info.max):
        raise ValueError(
            f"lifetime write-counts [{q.min():.0f}, {q.max():.0f}] do "
            f"not fit {np.dtype(dtype).name} banks")
    return (q + 0.0).astype(dtype)      # + 0.0: ceil(-0.x) is -0.0


def unpack_lifetimes(life_q: torch.Tensor, decrement: float):
    """Integer write counters -> mid-bin f32 lifetimes."""
    return (life_q.float() - 0.5) * float(decrement)


def pack_stuck(stuck) -> np.ndarray:
    """Stuck values in {-1, 0, +1} -> 2-bit codes, 4 cells per uint8
    along the last axis (host)."""
    codes = (_host(stuck) + 1.0).astype(np.uint8)
    pad = -codes.shape[-1] % 4
    if pad:
        codes = np.pad(codes, [(0, 0)] * (codes.ndim - 1) + [(0, pad)])
    codes = codes.reshape(codes.shape[:-1] + (-1, 4))
    shifts = np.arange(4, dtype=np.uint8) * 2
    return np.bitwise_or.reduce(codes << shifts, axis=-1).astype(np.uint8)


def unpack_stuck(bank: torch.Tensor, last_dim: int) -> torch.Tensor:
    """uint8 2-bit banks -> f32 stuck values shaped (..., last_dim)."""
    parts = [(bank >> (2 * i)) & 3 for i in range(4)]
    codes = torch.stack(parts, dim=-1).reshape(bank.shape[:-1] + (-1,))
    return codes[..., :last_dim].float() - 1.0


def pack_state(state, spec: dict, device=None) -> dict:
    """f32 FaultState -> packed banks, as tensors on `device` (default:
    the lifetimes' device). Extra groups ride along."""
    d, dtype = spec["decrement"], np.dtype(spec["life_dtype"])
    life_q, stuck_bits = {}, {}
    for k, life in state["lifetimes"].items():
        dev = device if device is not None else life.device
        life_q[k] = torch.from_numpy(pack_lifetimes(life, d, dtype)).to(dev)
        stuck_bits[k] = torch.from_numpy(
            pack_stuck(state["stuck"][k])).to(dev)
    out = {"life_q": life_q, "stuck_bits": stuck_bits}
    for group in state:
        if group not in ("lifetimes", "stuck"):
            out[group] = state[group]
    return out


def unpacked_view(state: dict, spec: dict) -> dict:
    """An f32 view of a packed state for read-side consumers."""
    d = spec["decrement"]
    view = {
        "lifetimes": {k: unpack_lifetimes(q, d)
                      for k, q in state["life_q"].items()},
        "stuck": {k: unpack_stuck(b, spec["last_dim"][k])
                  for k, b in state["stuck_bits"].items()},
    }
    for group in state:
        if group not in PACKED_GROUPS:
            view[group] = state[group]
    return view


def fail_packed(fault_params: Dict[str, torch.Tensor], state: dict,
                fault_diffs: Dict[str, torch.Tensor], spec: dict,
                mode: str = "write"):
    """engine.fail on the packed banks: the write decrement is an
    integer -1 on the counter bank, the stuck clamp unpacks the 2-bit
    codes, broken stays derived (`life_q <= 0`). `mode`: "write"
    (decrement on written steps), "always" (every step) or "never"."""
    new_params, new_life = {}, {}
    for name, data in fault_params.items():
        lq = state["life_q"][name]
        alive = lq > 0
        if mode == "write":
            written = fault_diffs[name].abs() >= fault_engine.EPSILON32
            lq2 = torch.where(alive & written, lq - 1, lq)
        elif mode == "always":
            lq2 = torch.where(alive, lq - 1, lq)
        elif mode == "never":
            lq2 = lq
        else:
            raise ValueError(f"unknown fail_packed mode {mode!r} "
                             "(expected 'write', 'always', or 'never')")
        stuck = unpack_stuck(state["stuck_bits"][name],
                             spec["last_dim"][name])
        new_params[name] = torch.where(lq2 <= 0, stuck.to(data.dtype), data)
        new_life[name] = lq2
    return new_params, {**state, "life_q": new_life}
