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
(net.cpp:482-493). The draw is the port's own (`torch.Generator`), so it
matches the reference only in distribution; parity tests carry one
state across with convert.py.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

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


def init_fault_state(gen: torch.Generator, param_shapes: Dict[str, tuple],
                     pattern) -> FaultState:
    """Draw lifetimes and stuck values for every fault-target param
    (GaussianFailureMaker ctor), on the generator's device, in dict
    order: lifetimes then stuck per param."""
    split1, split2 = stuck_splits(pattern)
    mean, std = float(pattern.mean), float(pattern.std)
    lifetimes, stuck = {}, {}
    for name, shape in param_shapes.items():
        lifetimes[name] = mean + std * torch.randn(shape, generator=gen)
        u = torch.rand(shape, generator=gen)
        stuck[name] = torch.where(
            u < split1, -1.0, torch.where(u < split2, 0.0, 1.0))
    return {"lifetimes": lifetimes, "stuck": stuck}


def stack_fault_states(gen: torch.Generator, param_shapes: Dict[str, tuple],
                       pattern, n_configs: int, means=None,
                       stds=None) -> FaultState:
    """n_configs independent draws stacked on a leading config axis
    (the reference's stack_fault_states / draw_rescaled_state): lane c's
    lifetimes are mean_c + std_c * z with z ~ N(0, 1), re-anchored to
    its own (mean, std), default the pattern's; stuck values are drawn
    per lane from the pattern's splits. Drawn lane by lane, in dict
    order, on the CPU generator `gen`."""
    split1, split2 = stuck_splits(pattern)
    means = np.broadcast_to(np.asarray(
        float(pattern.mean) if means is None else means, np.float32),
        (n_configs,))
    stds = np.broadcast_to(np.asarray(
        float(pattern.std) if stds is None else stds, np.float32),
        (n_configs,))
    lanes = []
    for c in range(n_configs):
        life, stuck = {}, {}
        for name, shape in param_shapes.items():
            z = torch.randn(shape, generator=gen)
            life[name] = float(means[c]) + float(stds[c]) * z
            u = torch.rand(shape, generator=gen)
            stuck[name] = torch.where(
                u < split1, -1.0, torch.where(u < split2, 0.0, 1.0))
        lanes.append((life, stuck))
    return {"lifetimes": {k: torch.stack([ln[0][k] for ln in lanes])
                          for k in param_shapes},
            "stuck": {k: torch.stack([ln[1][k] for ln in lanes])
                      for k in param_shapes}}


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


def fault_counters(prev_life: Dict[str, torch.Tensor],
                   new_life: Dict[str, torch.Tensor]):
    """Per-parameter fault census: broken cells, cells newly expired
    this step, min/mean remaining lifetime. Returns (totals,
    per_param) of tensors; the host reads them only when it logs."""
    per = {}
    broken_tot = newly_tot = 0
    life_min = None
    life_sum = 0.0
    n_cells = 0
    for name in sorted(new_life):
        l_new, l_prev = new_life[name], prev_life[name]
        broken = (l_new <= 0).sum()
        newly = ((l_new <= 0) & (l_prev > 0)).sum()
        pmin = l_new.min().float()
        per[name] = {"broken": broken, "newly_expired": newly,
                     "life_min": pmin, "life_mean": l_new.float().mean()}
        broken_tot = broken_tot + broken
        newly_tot = newly_tot + newly
        life_min = pmin if life_min is None else torch.minimum(life_min,
                                                               pmin)
        life_sum = life_sum + l_new.float().sum()
        n_cells += l_new.numel()
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
