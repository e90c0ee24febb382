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
Packing runs where the state lies (float64 division so the 1e8 point's
ceil lands on the right side), as do `fail_packed` and `unpacked_view`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import engine as fault_engine

PACKED_GROUPS = ("life_q", "stuck_bits")
LIFE_DTYPE_MARGIN = 12.0


def is_packed(state) -> bool:
    """True for a packed fault state (the f32 one carries "lifetimes"
    and "stuck", the packed one the bank groups)."""
    return state is not None and "life_q" in state


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


def check_spec_bounds(spec: dict, mean: float, std: float):
    """Raise if a (mean, std) spec could overflow the counter dtype the
    banks were sized with (a self-healing config submitted after the
    int16 choice was frozen)."""
    if spec["life_dtype"] == "int32":
        return
    if choose_life_dtype([mean], [std], spec["decrement"]) != "int16":
        raise ValueError(
            f"fault spec (mean={mean}, std={std}) exceeds the int16 "
            "lifetime banks this packed sweep was built with; build the "
            "runner with this spec present (the dtype choice covers "
            "every known spec) or with packed_state=False")


def _tensor(a) -> torch.Tensor:
    """A tensor as it is (on its own device), a host array as a CPU
    tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.array(a))


def pack_life_bank(life, decrement: float, dtype) -> torch.Tensor:
    """f32 lifetimes -> integer write counters, on the lifetimes' own
    device (float64 division by a tensor, then ceil)."""
    life = _tensor(life)
    q = torch.ceil(life.double() / torch.tensor(
        float(decrement), dtype=torch.float64, device=life.device))
    if q.numel():
        lo, hi = (float(v) for v in torch.stack(torch.aminmax(q)).tolist())
        info = np.iinfo(np.dtype(dtype))
        if lo < info.min or hi > info.max:
            raise ValueError(
                f"lifetime write-counts [{lo:.0f}, {hi:.0f}] do not fit "
                f"{np.dtype(dtype).name} banks")
    return q.to(getattr(torch, np.dtype(dtype).name))


def pack_stuck_bank(stuck) -> torch.Tensor:
    """Stuck values in {-1, 0, +1} -> 2-bit codes, 4 cells per uint8
    along the last axis, on the values' own device."""
    codes = (_tensor(stuck) + 1.0).to(torch.uint8)
    pad = -codes.shape[-1] % 4
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    codes = codes.reshape(codes.shape[:-1] + (-1, 4))
    return (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
            | (codes[..., 3] << 6))


def pack_lifetimes(life, decrement: float, dtype) -> np.ndarray:
    """`pack_life_bank` as a host array."""
    return pack_life_bank(fault_engine.host_array(life), decrement,
                          dtype).numpy()


def unpack_lifetimes(life_q: torch.Tensor, decrement: float):
    """Integer write counters -> mid-bin f32 lifetimes."""
    return (life_q.float() - 0.5) * float(decrement)


def pack_stuck(stuck) -> np.ndarray:
    """`pack_stuck_bank` as a host array."""
    return pack_stuck_bank(fault_engine.host_array(stuck)).numpy()


def unpack_stuck(bank: torch.Tensor, last_dim: int) -> torch.Tensor:
    """uint8 2-bit banks -> f32 stuck values shaped (..., last_dim)."""
    parts = [(bank >> (2 * i)) & 3 for i in range(4)]
    codes = torch.stack(parts, dim=-1).reshape(bank.shape[:-1] + (-1,))
    return codes[..., :last_dim].float() - 1.0


def pack_state(state, spec: dict, device=None) -> dict:
    """f32 FaultState -> packed banks, as tensors on `device` (default:
    the lifetimes' device). Each leaf packs where it lies, so a runner's
    state on the card never makes the host round trip. Extra groups
    ride along."""
    d, dtype = spec["decrement"], np.dtype(spec["life_dtype"])
    life_q, stuck_bits = {}, {}
    for k, life in state["lifetimes"].items():
        dev = device if device is not None else _tensor(life).device
        life_q[k] = pack_life_bank(life, d, dtype).to(dev)
        stuck_bits[k] = pack_stuck_bank(state["stuck"][k]).to(dev)
    out = {"life_q": life_q, "stuck_bits": stuck_bits}
    for group in state:
        if group not in ("lifetimes", "stuck"):
            out[group] = state[group]
    return out


def unpack_state(packed: dict, spec: dict) -> dict:
    """Packed banks -> the f32 FaultState on the host (numpy): mid-bin
    lifetimes, f32 stuck values; other groups ride along."""
    host = lambda a: torch.from_numpy(fault_engine.host_array(a))
    out = {"lifetimes": {k: unpack_lifetimes(host(q), spec["decrement"])
                         .numpy() for k, q in packed["life_q"].items()},
           "stuck": {k: unpack_stuck(host(b), spec["last_dim"][k]).numpy()
                     for k, b in packed["stuck_bits"].items()}}
    for group in packed:
        if group not in PACKED_GROUPS:
            out[group] = packed[group]
    return out


def convert_flat(arrays: Dict[str, np.ndarray], to_packed: bool,
                 spec: dict) -> Dict[str, np.ndarray]:
    """A flat {"group/key": host array} fault mapping (the checkpoint and
    save_fault_states layout, engine.state_to_arrays) in the other
    format: packed with `spec`, or unpacked to f32 with it. A mapping
    already in the asked format comes back as it is."""
    state: dict = {}
    for name, arr in arrays.items():
        group, key = name.split("/", 1)
        state.setdefault(group, {})[key] = np.asarray(arr)
    if to_packed == is_packed(state):
        return dict(arrays)
    state = (pack_state(state, spec, device="cpu") if to_packed
             else unpack_state(state, spec))
    return {name: fault_engine.host_array(v)
            for name, v in fault_engine.iter_state_leaves(state)}


def unpacked_view(state: dict, spec: dict, keys=None) -> dict:
    """An f32 view of a packed state for read-side consumers (the
    strategies' flag matrices and lifetimes), of every leaf or of the
    leaves `keys`. On the mid-bin lifetimes `< 0` and `<= 0` both read
    `life_q <= 0`."""
    d = spec["decrement"]
    keys = list(state["life_q"]) if keys is None else keys
    view = {
        "lifetimes": {k: unpack_lifetimes(state["life_q"][k], d)
                      for k in keys},
        "stuck": {k: unpack_stuck(state["stuck_bits"][k],
                                  spec["last_dim"][k]) for k in keys},
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
