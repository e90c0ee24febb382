"""Mitigation strategies against RRAM cell failures (counterpart of the
reference package's fault/strategies.py; reference strategy.hpp and
strategy.cpp). They run between ComputeUpdate and ApplyUpdate
(solver.cpp:299-305):

- Threshold (strategy.cpp:7-33): zero every fault-leaf update with
  |diff| <= threshold * rate * lr_mult. The cutoff is rounded to float32
  at each product, as the reference's jitted step computes it from its
  float32 rate; each param uses its own lr_mult (the reference's
  deliberate departure from strategy.cpp's index slip).
- Remapping (strategy.cpp:36-137): on its iterations, rank the hidden FC
  neurons by their count of broken stuck-at-0 cells and permute neuron
  rows and columns so the most broken physical neurons host the most
  prunable logical ones. The rank is a stable sort, as `jnp.argsort`
  is: the counts are full of ties. `track_identity` routes each logical
  neuron from the slot it lives in.
- Genetic (strategy.cpp:140-288): a host-side random search of neuron
  pair swaps between steps. It draws from `np.random.RandomState(seed)`
  in the reference's call order, so it replays the reference's swaps.

Threshold and remapping are a compare, an argsort and gathers in plain
torch on the state's device: no kernel and no host round trip. Both take
a leading config-lane axis (the sweep's): each lane ranks and permutes
by its own fault state, in one call for all lanes, and lane c equals
the single-config call on lane c's tensors bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import FaultState, stuck_zero_flags

EPSILON = 1e-20  # strategy.cpp:163

FcPairs = Sequence[Tuple[str, Optional[str]]]


# ---------------------------------------------------------------------------
# Threshold

def threshold_cutoff(threshold: float, rate, lr_mult: float):
    """threshold * rate * lr_mult in float32, rounded after each product
    (the order of the reference's `threshold * rate * lr_mult` on its
    float32 rate). `rate` a number, or a (C,) float32 tensor of per-lane
    rates (a (C,) cutoff, the same float32 products on the device)."""
    if isinstance(rate, torch.Tensor):
        return (rate * float(np.float32(threshold))) \
            * float(np.float32(lr_mult))
    return float(np.float32(np.float32(threshold) * np.float32(rate))
                 * np.float32(lr_mult))


def threshold_diffs(fault_diffs: Dict[str, torch.Tensor], rate,
                    lr_mults: Dict[str, float],
                    threshold: float) -> Dict[str, torch.Tensor]:
    """Zero small updates (ThresholdFailureStrategy::Apply): a diff with
    |diff| <= the param's cutoff becomes +0. Per-lane rates (a (C,)
    tensor) cut each lane of a (C, ...) diff at its own cutoff."""
    out = {}
    for name, diff in fault_diffs.items():
        cutoff = threshold_cutoff(threshold, rate, lr_mults.get(name, 1.0))
        if isinstance(cutoff, torch.Tensor):
            cutoff = cutoff.view((-1,) + (1,) * (diff.dim() - 1))
        out[name] = diff.masked_fill(diff.abs() <= cutoff, 0.0)
    return out


# ---------------------------------------------------------------------------
# Remapping

def sort_fc_neurons(state: FaultState,
                    weight_keys: Sequence[str]) -> List[torch.Tensor]:
    """Rank hidden FC neurons by broken stuck-at-0 cell count
    (SortFCNeurons, strategy.cpp:48-88): for hidden group i (between FC
    i-1 and FC i), neuron j's count is row j of FC i-1's flag matrix
    plus column j of FC i's. One ascending, stable order per group (and
    per lane, (C, n), under a leading lane axis)."""
    flags = [stuck_zero_flags(state, k) for k in weight_keys]
    return [torch.argsort(flags[i - 1].sum(-1) + flags[i].sum(-2), dim=-1,
                          stable=True)
            for i in range(1, len(flags))]


def _permute_group(dicts, w_in, b_in, w_out, perm):
    """Rows of W_{i-1}, its bias and columns of W_i take `perm`
    (dest <- src, (n,) or one row a lane, (C, n)), in every dict of
    `dicts`."""
    for d in dicts:
        d[w_in] = torch.take_along_dim(d[w_in], perm[..., :, None], dim=-2)
        if b_in is not None and b_in in d:
            d[b_in] = torch.take_along_dim(d[b_in], perm, dim=-1)
        d[w_out] = torch.take_along_dim(d[w_out], perm[..., None, :],
                                        dim=-1)


def _prune_tensor(order: torch.Tensor, prune) -> torch.Tensor:
    return torch.as_tensor(prune, dtype=torch.long, device=order.device)


def _placed(order: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """perm with perm[..., order[..., j]] = src[..., j] along the last
    axis, per lane (`src` broadcasts over the lanes)."""
    return torch.empty_like(order).scatter_(-1, order,
                                            src.expand_as(order))


def remap_fc_neurons(data: Dict[str, torch.Tensor],
                     diffs: Dict[str, torch.Tensor], state: FaultState,
                     fc_pairs: FcPairs, prune_orders: Sequence):
    """Permute hidden FC neurons (RemappingFailureStrategy::Apply,
    strategy.cpp:89-137): physical slot order[j] (the j-th least broken)
    receives logical neuron prune_order[j]; the rows of W_{i-1} and its
    bias and the columns of W_i move together, the fault state stays
    with the physical cells. `fc_pairs` = [(weight key, bias key or
    None)] in FC order; `prune_orders` one ordering per hidden group.
    Returns (new data, new diffs)."""
    weight_keys = [w for w, _ in fc_pairs]
    orders = sort_fc_neurons(state, weight_keys)
    data, diffs = dict(data), dict(diffs)
    for i in range(1, len(fc_pairs)):
        order = orders[i - 1]
        perm = _placed(order, _prune_tensor(order, prune_orders[i - 1]))
        _permute_group((data, diffs), fc_pairs[i - 1][0], fc_pairs[i - 1][1],
                       weight_keys[i], perm)
    return data, diffs


def remap_fc_neurons_tracked(data: Dict[str, torch.Tensor],
                             diffs: Dict[str, torch.Tensor],
                             state: FaultState, fc_pairs: FcPairs,
                             prune_orders: Sequence,
                             slots: Dict[str, torch.Tensor]):
    """Identity-tracking remapping (FailureStrategyParameter.
    track_identity): `slots[str(g)]` maps logical neuron -> current
    physical slot of hidden group g, and each event routes logical
    prune_order[j] from wherever it lives onto the j-th least broken
    slot. Returns (new data, new diffs, new slots)."""
    weight_keys = [w for w, _ in fc_pairs]
    orders = sort_fc_neurons(state, weight_keys)
    data, diffs, new_slots = dict(data), dict(diffs), dict(slots)
    for i in range(1, len(fc_pairs)):
        order = orders[i - 1]
        prune = _prune_tensor(order, prune_orders[i - 1])
        sol = slots[str(i - 1)]
        perm = _placed(order, sol.index_select(-1, prune).long())
        _permute_group((data, diffs), fc_pairs[i - 1][0], fc_pairs[i - 1][1],
                       weight_keys[i], perm)
        new = torch.empty_like(sol)
        new[..., prune] = order.to(sol.dtype)
        new_slots[str(i - 1)] = new
    return data, diffs, new_slots


# ---------------------------------------------------------------------------
# Genetic (host side, between steps)

@dataclasses.dataclass
class GeneticStrategy:
    """Random neuron-pair swap search (GeneticFailureStrategy,
    strategy.cpp:140-288) on host numpy copies between steps.
    `prune_weights`: one [out, in] mask per FC layer (>= EPSILON =
    unprunable), permuted by kept swaps as the reference permutes its
    prune net."""
    fc_pairs: List[Tuple[str, Optional[str]]]
    prune_weights: List[np.ndarray]
    start: int
    period: int
    switch_time: int
    seed: int = 0

    def __post_init__(self):
        self.times = 0
        self._rng = np.random.RandomState(self.seed)
        self.prune_weights = [np.array(w) for w in self.prune_weights]
        if len(self.fc_pairs) < 2:
            # strategy.cpp:174 draws rand() % (size - 1): with one FC
            # fault target there is no neuron pair to swap
            raise ValueError(
                "genetic strategy needs >= 2 fault-target FC layers")

    def overall_dist(self, lifetimes: Dict[str, np.ndarray]) -> int:
        """Count of unprunable-AND-failed cells (CalculateOverallDist,
        strategy.cpp:140-158; failed is lifetime < 0)."""
        return sum(int(np.sum((prune < EPSILON) & (lifetimes[wkey] < 0)))
                   for (wkey, _), prune in zip(self.fc_pairs,
                                               self.prune_weights))

    def due_at(self, iteration: int) -> bool:
        """start/period gating (strategy.cpp:160-163) before
        `iteration`, where the reference's times_ counter is
        iteration + 1."""
        times = iteration + 1
        return not (times < self.start or (times - self.start) % self.period)

    def due(self) -> bool:
        """`due_at` of the next iteration; call once per iteration: it
        advances the times_ counter."""
        self.times += 1
        return self.due_at(self.times - 1)

    def apply(self, data: Dict[str, np.ndarray], diffs: Dict[str, np.ndarray],
              lifetimes: Dict[str, np.ndarray]) -> None:
        """One application; permutes `data`, `diffs` and the prune masks
        in place. The caller gates it with due()."""
        n_fc = len(self.fc_pairs)
        i = attempts = 0
        while i < self.switch_time and attempts < 100 * self.switch_time:
            attempts += 1
            layer = self._rng.randint(1, n_fc)          # hidden group
            w_in_key, b_in_key = self.fc_pairs[layer - 1]
            w_out_key = self.fc_pairs[layer][0]
            n = data[w_in_key].shape[0]
            a = self._rng.randint(n)
            b = self._rng.randint(n)
            if a == b:      # the same neuron: draw again (bounded)
                continue
            i += 1
            life_in = lifetimes[w_in_key]
            life_out = lifetimes[w_out_key]
            prune_in = self.prune_weights[layer - 1]
            prune_out = self.prune_weights[layer]

            # the pair's distance with logical neurons (pa, pb) on
            # physical (a, b): failed cells stay, the masks move
            def local(pa, pb):
                return (np.sum((prune_in[pa] < EPSILON) & (life_in[a] < 0))
                        + np.sum((prune_in[pb] < EPSILON) & (life_in[b] < 0))
                        + np.sum((prune_out[:, pa] < EPSILON)
                                 & (life_out[:, a] < 0))
                        + np.sum((prune_out[:, pb] < EPSILON)
                                 & (life_out[:, b] < 0)))

            if local(b, a) < local(a, b):
                for d in (data, diffs):
                    d[w_in_key][[a, b]] = d[w_in_key][[b, a]]
                    if b_in_key is not None and b_in_key in d:
                        d[b_in_key][[a, b]] = d[b_in_key][[b, a]]
                    d[w_out_key][:, [a, b]] = d[w_out_key][:, [b, a]]
                prune_in[[a, b]] = prune_in[[b, a]]
                prune_out[:, [a, b]] = prune_out[:, [b, a]]


# ---------------------------------------------------------------------------
# Construction from SolverParameter.failure_strategy

@dataclasses.dataclass
class StrategyConfig:
    """The parsed failure_strategy entries (FailureStrategyParameter)."""
    threshold: Optional[float] = None           # every iteration
    remap_start: int = 0                        # remap iterations
    remap_period: int = 0
    prune_orders: Optional[List[np.ndarray]] = None
    remap_tracked: bool = False                 # track_identity
    genetic: Optional[GeneticStrategy] = None   # host side, between steps


def load_prune_orders(path: str) -> List[np.ndarray]:
    """The prune_order_file (examples/gaussian_failure/prune_order.py):
    one line of space-separated neuron indices per hidden FC group."""
    orders = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                orders.append(np.asarray([int(x) for x in line.split()],
                                         dtype=np.int32))
    return orders


def _check_prune_orders(orders, hidden_sizes) -> None:
    """Each row must be a full permutation of its hidden group; a short
    or duplicated row would map leftover slots to logical neuron 0."""
    if hidden_sizes is None:
        return
    if len(orders) != len(hidden_sizes):
        raise ValueError(
            f"prune_order_file has {len(orders)} rows but the net has "
            f"{len(hidden_sizes)} hidden FC groups")
    for i, (row, n) in enumerate(zip(orders, hidden_sizes)):
        if len(row) != n or not np.array_equal(np.sort(row), np.arange(n)):
            raise ValueError(
                f"prune_order row {i} is not a permutation of 0..{n - 1} "
                f"(got {len(row)} entries)")


def build_strategies(solver_param, fc_pairs, prune_net_loader=None,
                     hidden_sizes=None) -> StrategyConfig:
    """The strategy set of SolverParameter.failure_strategy (Solver ctor,
    solver.cpp:134-148). `prune_net_loader(net_file, model_file)` gives
    the genetic strategy's FC masks; `hidden_sizes` (the output width of
    each hidden FC group) validates remapping's prune orders."""
    cfg = StrategyConfig()
    for sp in solver_param.failure_strategy:
        if sp.type == "threshold":
            cfg.threshold = float(sp.threshold)
        elif sp.type == "remapping":
            cfg.remap_start = int(sp.start)
            cfg.remap_period = max(int(sp.period), 1)
            cfg.prune_orders = load_prune_orders(sp.prune_order_file)
            cfg.remap_tracked = bool(sp.track_identity)
            _check_prune_orders(cfg.prune_orders, hidden_sizes)
        elif sp.type == "genetic":
            if prune_net_loader is None:
                raise ValueError("genetic strategy requires a prune net")
            cfg.genetic = GeneticStrategy(
                fc_pairs=list(fc_pairs),
                prune_weights=prune_net_loader(sp.prune_net_file,
                                               sp.prune_model_file),
                start=int(sp.start), period=max(int(sp.period), 1),
                switch_time=int(sp.switch_time))
        elif sp.type:
            raise ValueError(f"unknown failure strategy {sp.type!r}")
    return cfg
