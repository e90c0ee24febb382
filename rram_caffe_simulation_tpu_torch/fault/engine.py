"""RRAM cell-endurance fault engine (counterpart of the reference
package's fault/engine.py; reference failure_maker.cpp:4-84,
failure_maker.cu:6-60).

- Construction: per fault-target parameter, per-cell lifetimes
  ~ N(mean, std) and stuck values in {-1, 0, +1} from one uniform draw
  against the cumulative FailureProbParameter splits (default 10/20/10).
- Fail, per iteration: a live cell whose update was a write
  (|diff| >= 1e-20) loses `decrement` (100, the reference's hard-coded
  batch size) of lifetime; a cell whose lifetime is <= 0 is broken and
  its weight is clamped to its stuck value.

A FaultState is {"lifetimes": {key: f32 tensor}, "stuck": {key: f32
tensor}}, keyed "layer/slot" in failure_learnable_params order
(net.cpp:482-493). It is drawn from a threefry key with the reference's
key chain (core/prng.py): `key, k_life, k_stuck = split(key, 3)` per
param, in dict order, so a key gives the reference's state. Under a
tile spec (fault/mapping.py) every crossbar tile of a param is drawn
from its own folded key, tile-major, and a single-tile param is drawn
exactly as without one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import prng
from .mapping import tiled_draw

FaultState = Dict[str, Dict[str, torch.Tensor]]

EPSILON = 1e-20  # failure_maker.cpp:56 / failure_maker.cu:25
# the same threshold as the float32 the reference compares in; both are
# exact float32 values, so the comparison agrees in either precision
EPSILON32 = float(np.float32(EPSILON))


def param_key(layer_name: str, slot: int) -> str:
    return f"{layer_name}/{slot}"


def stuck_splits(pattern) -> Tuple[float, float]:
    """Cumulative probability splits of the stuck-value draw
    (failure_maker.cpp:10-24)."""
    if pattern.HasField("failure_prob"):
        p = pattern.failure_prob
        probs = [p.neg, p.zero, p.pos]
        if min(probs) < 0:
            raise ValueError("failure_prob entries must be >= 0")
    else:
        probs = [10, 20, 10]
    total = float(sum(probs))
    if total <= 0:
        raise ValueError("failure_prob entries must sum to > 0")
    return probs[0] / total, (probs[0] + probs[1]) / total


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d, rounded as IEEE division on either device (CUDA divides by
    a host scalar through its reciprocal, so d goes over as a tensor)."""
    return t / torch.tensor(d, dtype=torch.float32, device=t.device)


def init_fault_state(key, param_shapes: Dict[str, tuple], pattern,
                     tiles=None, device="cpu") -> FaultState:
    """Draw lifetimes and stuck values for every fault-target param
    (GaussianFailureMaker ctor) on `device`, with the reference's key
    chain: per param in dict order `key, k_life, k_stuck = split(key,
    3)`; lifetimes mean + std * normal(k_life), stuck values from one
    uniform(k_stuck) against the cumulative splits. `tiles` (a
    mapping.TileSpec) draws each crossbar tile of a >= 2-D param from
    its own folded key. A batch of keys (C, 2) draws C states, each
    leaf with a leading C axis."""
    split1, split2 = (float(np.float32(v)) for v in stuck_splits(pattern))
    mean, std = float(np.float32(pattern.mean)), float(np.float32(
        pattern.std))

    def life_draw(k, shape):
        return prng.normal(k, shape, device) * std + mean

    def stuck_draw(k, shape):
        u = prng.uniform(k, shape, device=device)
        return torch.where(u < split1, -1.0,
                           torch.where(u < split2, 0.0, 1.0))

    lifetimes, stuck = {}, {}
    for name, shape in param_shapes.items():
        ks = prng.split(key, 3)
        key, k_life, k_stuck = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
        lifetimes[name] = tiled_draw(k_life, shape, tiles, life_draw)
        stuck[name] = tiled_draw(k_stuck, shape, tiles, stuck_draw)
    return {"lifetimes": lifetimes, "stuck": stuck}


def draw_rescaled_state(key, param_shapes: Dict[str, tuple], pattern,
                        mean, std, tiles=None, device="cpu") -> FaultState:
    """`init_fault_state(key)` with the lifetimes re-anchored from the
    pattern's (mean, std) to the given pair: z = (life - base_mean) /
    base_std kept, life = mean + std * z (float32 at each step, as the
    reference computes it). Under a batch of keys (C, 2), `mean` and
    `std` are (C,) arrays, one pair per config."""
    st = init_fault_state(key, param_shapes, pattern, tiles, device)
    base_m = float(np.float32(pattern.mean))
    base_s = float(np.float32(pattern.std))
    m = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    s = torch.as_tensor(np.asarray(std, np.float32), device=device)
    life = {}
    for name, v in st["lifetimes"].items():
        lead = m.shape + (1,) * (v.dim() - m.dim())
        z = (_div(v - base_m, base_s) if base_s
             else torch.zeros_like(v))
        life[name] = m.reshape(lead) + s.reshape(lead) * z
    return {"lifetimes": life, "stuck": st["stuck"]}


def draw_state_rows(key, param_shapes: Dict[str, tuple], pattern,
                    n_configs: int, means, stds, rows=None, process=None,
                    tiles=None, device="cpu") -> FaultState:
    """Rows [lo, hi) of the n_configs-stacked draw, exactly as the full
    stack holds them: the per-config keys are split from `key` over the
    full count and then sliced (the reference's draw_state_rows), and
    the rows drawn as one batch (vectorised over configs). `process` (a
    fault/processes ProcessStack) draws each config through the stack,
    which carries its own tile spec; None is the endurance draw under
    `tiles`, which the default stack draws byte for byte."""
    lo, hi = (0, n_configs) if rows is None else (int(rows[0]),
                                                  int(rows[1]))
    if not (0 <= lo <= hi <= n_configs):
        raise ValueError(f"draw_state_rows rows [{lo}, {hi}) outside "
                         f"[0, {n_configs})")
    keys = prng.split(key, n_configs)[lo:hi]
    means = np.asarray(means, np.float32)[lo:hi]
    stds = np.asarray(stds, np.float32)[lo:hi]
    if process is not None:
        return process.draw_rescaled(keys, param_shapes, pattern, means,
                                     stds, device=device)
    return draw_rescaled_state(keys, param_shapes, pattern, means, stds,
                               tiles, device)


def stack_fault_states(key, param_shapes: Dict[str, tuple], pattern,
                       n_configs: int, means=None, stds=None, rows=None,
                       process=None, tiles=None,
                       device="cpu") -> FaultState:
    """n_configs independent draws stacked on a leading config axis (the
    reference's parallel/sweep.py stack_fault_states): lane c's
    lifetimes re-anchored to its own (mean, std), default the
    pattern's; `rows=(lo, hi)` draws that block of lanes alone;
    `process` the ProcessStack that draws (`draw_state_rows`)."""
    means = (np.asarray(means, np.float32) if means is not None
             else np.full((n_configs,), float(pattern.mean), np.float32))
    stds = (np.asarray(stds, np.float32) if stds is not None
            else np.full((n_configs,), float(pattern.std), np.float32))
    return draw_state_rows(key, param_shapes, pattern, n_configs, means,
                           stds, rows=rows, process=process, tiles=tiles,
                           device=device)


def fail(fault_params: Dict[str, torch.Tensor], state: FaultState,
         fault_diffs: Dict[str, torch.Tensor],
         decrement: float = 100.0):
    """One fault step over the fault-target params (FailKernel,
    failure_maker.cu:23-40): returns (clamped params, new state).
    `fault_diffs` are the update values the solver just applied."""
    new_params, new_life = {}, {}
    for name, data in fault_params.items():
        life = state["lifetimes"][name]
        alive = life > 0
        written = fault_diffs[name].abs() >= EPSILON32
        life2 = torch.where(alive & written, life - decrement, life)
        new_params[name] = torch.where(life2 <= 0, state["stuck"][name],
                                       data)
        new_life[name] = life2
    return new_params, {**state, "lifetimes": new_life}


def stuck_zero_flags(state: FaultState, name: str) -> torch.Tensor:
    """1.0 where a cell is broken AND stuck at 0, the remapping
    strategy's flag matrix (strategy.cpp:36-45 GetFailFlagMat). It tests
    `lifetime < 0`, not `<= 0`, as the reference does."""
    life = state["lifetimes"][name]
    return ((life < 0) & (state["stuck"][name] == 0)).float()


def fault_counters(prev_life: Dict[str, torch.Tensor],
                   new_life: Dict[str, torch.Tensor], lanes: int = 0):
    """Per-parameter fault census: broken cells, cells newly expired
    this step, min/mean remaining lifetime (per lane under `lanes`, the
    leading axis). Returns (totals, per_param) of device tensors; the
    host reads them only when it logs. Counts are int64 (the
    reference's int32 values)."""
    def red(t, op):
        t = t.reshape(lanes, -1) if lanes else t.reshape(-1)
        return getattr(t, op)(-1)
    per = {}
    broken_tot = newly_tot = life_min = life_sum = None
    n_cells = 0
    for name in sorted(new_life):
        l_new, l_prev = new_life[name], prev_life[name]
        broken = red(l_new <= 0, "sum")
        newly = red((l_new <= 0) & (l_prev > 0), "sum")
        pmin = red(l_new, "amin").float()
        psum = red(l_new.float(), "sum")
        cells = l_new.numel() // max(lanes, 1)
        per[name] = {"broken": broken, "newly_expired": newly,
                     "life_min": pmin, "life_mean": psum / cells}
        if broken_tot is None:
            broken_tot, newly_tot, life_min, life_sum = (broken, newly,
                                                         pmin, psum)
        else:
            broken_tot = broken_tot + broken
            newly_tot = newly_tot + newly
            life_min = torch.minimum(life_min, pmin)
            life_sum = life_sum + psum
        n_cells += cells
    totals = {"broken_total": broken_tot, "newly_expired": newly_tot,
              "life_min": life_min,
              "life_mean": life_sum / max(n_cells, 1)}
    return totals, per


def broken_fraction(state: FaultState) -> float:
    """Share of broken cells, either format: the f32 lifetimes and the
    packed write counters share the `<= 0` broken semantics."""
    lives = (state["life_q"] if "life_q" in state
             else state.get("lifetimes", {}))
    if not lives:
        return 0.0
    broken = sum(int((life <= 0).sum()) for life in lives.values())
    total = sum(life.numel() for life in lives.values())
    return broken / max(total, 1)


def iter_state_leaves(state: FaultState):
    """("group/key", leaf) in the canonical sorted order, the flat
    layout the reference's .npz writers use."""
    for group in sorted(state):
        for key in sorted(state[group]):
            yield f"{group}/{key}", state[group][key]


def host_array(a) -> np.ndarray:
    """A tensor's host copy as numpy (an array as it is)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def state_to_arrays(state: FaultState) -> Dict[str, np.ndarray]:
    """Flatten a fault state to {"group/key": host array}."""
    return {name: v.detach().cpu().numpy()
            for name, v in iter_state_leaves(state)}


def state_from_arrays(arrays: Dict[str, np.ndarray],
                      device="cpu") -> FaultState:
    """The inverse of `state_to_arrays`, placed on `device`."""
    state: FaultState = {}
    for name, arr in arrays.items():
        group, key = name.split("/", 1)
        state.setdefault(group, {})[key] = torch.as_tensor(
            np.asarray(arr), device=device)
    return state


# ---------------------------------------------------------------------------
# the .faultstate file: a NetParameter named "fault_state" whose entries
# carry the state as BlobProtos, the reference's layout entry for entry

def fault_state_to_proto(state: FaultState):
    """The f32 fault state as the reference's `.faultstate` message: per
    leaf in sorted order a `FaultState` entry (blobs: lifetimes, stuck),
    then per group id a `RemapSlots` entry (float64 blob), then per other
    group and leaf a `FaultLeaf:<group>` entry."""
    from .. import proto
    from ..utils.io import array_to_blob
    out = proto.Message("NetParameter")
    out.name = "fault_state"

    def entry(name, type_name, arrays):
        lp = proto.Message("LayerParameter")
        lp.name, lp.type = name, type_name
        lp.blobs = [array_to_blob(a) for a in arrays]
        out.layer.append(lp)

    for name in sorted(state.get("lifetimes", {})):
        entry(name, "FaultState", [host_array(state["lifetimes"][name]),
                                   host_array(state["stuck"][name])])
    for gid in sorted(state.get("remap_slots", {})):
        entry(gid, "RemapSlots",
              [host_array(state["remap_slots"][gid]).astype(np.float64)])
    for group in sorted(state):
        if group in ("lifetimes", "stuck", "remap_slots"):
            continue
        for name in sorted(state[group]):
            entry(name, f"FaultLeaf:{group}",
                  [host_array(state[group][name])])
    return out


def fault_state_from_proto(message, device="cpu") -> FaultState:
    """The inverse of `fault_state_to_proto`, on `device`: lifetimes and
    stuck values f32, remap slots int32, other leaves as stored."""
    from ..utils.io import blob_to_array

    def put(arr, dtype=None):
        return torch.as_tensor(arr if dtype is None else arr.astype(dtype),
                               device=device)

    lifetimes, stuck, slots, extra = {}, {}, {}, {}
    for lp in message.layer:
        if lp.type == "RemapSlots":
            slots[lp.name] = put(blob_to_array(lp.blobs[0]), np.int32)
        elif lp.type.startswith("FaultLeaf:"):
            extra.setdefault(lp.type[len("FaultLeaf:"):], {})[lp.name] = \
                put(blob_to_array(lp.blobs[0]))
        else:
            lifetimes[lp.name] = put(blob_to_array(lp.blobs[0]))
            stuck[lp.name] = put(blob_to_array(lp.blobs[1]))
    out: FaultState = {}
    if lifetimes:
        out["lifetimes"], out["stuck"] = lifetimes, stuck
    if slots:
        out["remap_slots"] = slots
    out.update(extra)
    return out
