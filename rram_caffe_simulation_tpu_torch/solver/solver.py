"""Solver: the RRAM fault-training step, eager on tensors (counterpart
of the reference package's solver/solver.py; reference solver.cpp Step
:238 and sgd_solver.cpp ComputeUpdate :102, ApplyUpdate :119).

One iteration keeps the fork's order (solver.cpp:299-305):

    ForwardBackward -> ComputeUpdate -> ApplyStrategy -> ApplyUpdate -> Fail

ApplyStrategy runs the solver's failure strategies (fault/strategies.py):
threshold zeroes small fault-leaf updates every step, remapping permutes
hidden FC neurons on its iterations (flags from the unpacked view of
packed banks), and the genetic search runs on the host between steps,
in `step`, on its own iterations only.

With the crossbar read armed (rram_forward.sigma > 0 or a quantizing
dtype_policy) every InnerProduct weight is read
through `crossbar_matmul` (kernel B2 on the "cuda" engine), biases
through `quantize_ste`/`perturb_weight`; with packed banks and the
fused epilogue, ApplyUpdate+Fail of every fault leaf is kernel B1, one
launch a step for all of them (`fused_tail`).

The Fail phase runs the solver's fault-process stack
(`Solver(fault_process=spec)`, fault/processes/; default
endurance_stuck_at): each process in its order, or with the fused
epilogue kernel B1 in the stack's mode where one process fuses
("write", "always" or "never"); a stack that cannot fuse runs unfused
and `step.fused_epilogue_reason` says why.

`failure_pattern.conv_also` makes Convolution params fault targets too.
A tile spec (`Solver(tile_spec=)`, else `rram_forward.tiles`; see
fault/mapping.py) draws every crossbar tile's faults on its own and
reads every layer spanning more than one tile through per-tile ADCs:
InnerProduct through kernel B2t, a tiled Convolution through B2t over
its patch rows ("premat") or B3 over the raw activation ("implicit"),
by `conv_im2col` (constructor, else RRAM_CONV_IM2COL, else "premat").
An untiled conv fault target is read like a bias.

Test nets (Solver::Test): `test_all` runs every test net at sigma 0
through `adc_bits` and the tile mapping, and prints the reference's log
lines; `step` runs it at `test_interval`.

Random numbers follow the reference's threefry key chain (core/prng.py):
`PRNGKey(seed)` split for the params and again for the fault state, the
step's key `fold_in(key, iter)`, and fault key i's noise key
`fold_in(fold_in(step key, 0x4A7), i)`, whose `randint` is a crossbar
read's seed. A seed therefore draws the reference's params, fault state
and crossbar seeds, on the card and on the CPU alike.

Snapshots (Solver::Snapshot, Restore): `step` writes one every
`snapshot` iterations, `solve()` runs to max_iter and writes the last,
`restore(state_file)` / `solve(resume_file)` resumes. A snapshot is the
reference's three files, byte for byte what the reference writes for the
same state: `<prefix>_iter_N.caffemodel` (the net with its params),
`.solverstate` (iter, the model's name, current_step, the SGD history)
and `.faultstate` (the fault state, f32: under packed banks their
mid-bin view, re-packed on restore). So a snapshot of either package
resumes in the other. Under `snapshot_format: HDF5` the model and the
state are the reference's `.caffemodel.h5` and `.solverstate.h5`
(utils/io.py, through `h5py`), the `.faultstate` beside them as ever;
where `h5py` cannot be imported HDF5 raises by name, in `solve()` before
it trains when a snapshot will be due. `enable_background_snapshots()`
moves the writes to a thread.

ComputeUpdate (sgd_solver.cpp:102-117) runs the reference's six rules
(solver/updates.py), chosen by `type` or the legacy `solver_type` enum:
ClipGradients over the raw accumulated gradients (each config lane by
its own norm), then per param Normalize (diff / iter_size), Regularize
(L2 or L1) and the rule. `iter_size` > 1 stacks that many sub-batches
on a leading axis; sub-pass i reads with the key fold_in(step key, i)
and the gradients add up in order.

Forward state (BatchNorm's moving statistics): the forward runs
`Net.apply(with_updates=True)` and the step takes the advanced
statistics as its data before ComputeUpdate (reference :994); under
`iter_size` sub-pass i + 1 reads those sub-pass i advanced, the weights
staying the step's. The TRAIN graph never reads them, so their
gradient is zero and, at lr_mult = decay_mult = 0, every rule's update
for them an exact 0. The test nets read them through
`use_global_stats` and advance nothing.

Telemetry (observe/): `enable_metrics(*sinks)` builds the step with the
in-step counters (loss, lr, gradient and update norms, the fault census,
threshold-suppressed writes, per-tile counters under a tile spec), which
stay on the device until a display boundary writes one record to every
sink; `enable_health(every)` runs the wear census every `every`
iterations, apart from the step, into the sinks and `health_ledger`.

`debug_info: true` (observe/debug.py) prints the reference's
[Forward] / [Backward] / [Update] lines every iteration and writes a
`debug_trace` record to the sinks: the step reduces every capture point
into a few device vectors, with the numeric sentinels beside them.
`enable_watchdog("halt" | "snapshot")` reads the sentinels every
iteration: on a trip or a non-finite loss it names the first bad phase
and layer, snapshots under "snapshot", and stops the run.

Not ported yet (a solver asking for one raises): `solve(fused_chunk=)`
(step_fused), data/tensor/pipeline parallelism and a sub-f32 compute
dtype.
"""
from __future__ import annotations

import functools
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import async_exec, proto
from ..core import prng
from ..data.feed import batch_to, build_feed
from ..device import resolve_device
from ..fault import engine as fault_engine
from ..fault import packed as fault_packed
from ..fault import strategies as fault_strategies
from ..fault.fused import (fused_tail, fused_update_fail_leaves,
                           fused_update_fail_leaves_plain)
from ..fault.hw_aware import CONV_OPERANDS, perturb_weight, quantize_ste
from ..fault import mapping as fault_mapping
from ..fault.mapping import TileSpec, conv_geom
from ..fault.processes import DEFAULT_PROCESS, FaultSpec
from ..net.builder import Net
from ..observe import counters as obs_counters
from ..utils.io import (array_to_blob, blob_to_array, read_net_param,
                        read_proto_binary, read_solver_param,
                        read_solver_state_hdf5, require_h5py,
                        write_net_hdf5, write_proto_binary,
                        write_solver_state_hdf5)
from . import updates as U
from .lr_policies import current_step_fn, learning_rate_fn

HW_ENGINES = ("auto", "cuda", "torch")
NOISE_FOLD = 0x4A7      # the reference's fold of a step key into noise keys
DTYPE_POLICY_BITS = {None: 0, "": 0, "f32": 0, "float32": 0, "ternary": 2,
                     "int8": 8}


class _IntervalClock:
    """The interval between two metrics records: training wall time
    (test and snapshot time excluded by `exclude`), iterations, and the
    per-step writes_saved device scalars summed into the record's
    interval total. One lives on the Solver, so repeated `step(1)` calls
    keep one interval."""

    def __init__(self):
        self.reset()

    def reset(self, now: Optional[float] = None):
        self.t0 = time.perf_counter() if now is None else now
        self.excl = 0.0
        self.n = 0
        self.ws: list = []

    def tick(self, k: int = 1, writes_saved=None):
        self.n += k
        if writes_saved is not None:
            self.ws.append(writes_saved)

    def exclude(self, t_start: float):
        self.excl += time.perf_counter() - t_start

    def elapsed(self, now: float) -> float:
        return now - self.t0 - self.excl


def clip_gradients(grads: Dict[str, torch.Tensor], clip: float,
                   lanes: int = 0) -> Dict[str, torch.Tensor]:
    """ClipGradients (sgd_solver.cpp:82-100): scale every gradient by
    clip / l2 where l2, the norm over all of them, exceeds `clip`. Under
    lanes each lane clips by its own norm (a sum over every axis but the
    first)."""
    sumsq = sum((v * v).reshape(lanes, -1).sum(1) if lanes
                else (v * v).sum() for v in grads.values())
    l2 = U._sqrt(sumsq)
    clip_t = torch.full_like(l2, clip)
    scale = torch.where(l2 > clip_t,
                        torch.div(clip_t, torch.clamp_min(l2, 1e-30)),
                        torch.ones_like(l2))
    return {k: v * (scale.view((-1,) + (1,) * (v.dim() - 1)) if lanes
                    else scale) for k, v in grads.items()}


def noise_keys(rng, n: int) -> np.ndarray:
    """Fault key i's noise key, fold_in(fold_in(rng, 0x4A7), i), for i <
    n: (..., n, 2) for a step key (..., 2) (one per lane under lanes),
    in one threefry pass per fold."""
    base = prng.fold_in(rng, NOISE_FOLD)
    return prng.fold_in(base[..., None, :], np.arange(n))


class StepNoise:
    """What a step's reads draw from, for a step key rng (..., 2): the
    noise keys of its first `n` fault keys and the randint seeds of
    those at `seeded` (the crossbar reads). `step_key(key, it, lanes)`
    hands out iteration `it`'s step key (fold_in(key, it), then
    fold_in(., c) for lane c under lanes) and derives BLOCK iterations
    at once, in one vectorised numpy pass per fold (with `subs` > 1, the
    iter_size sub-pass keys fold_in(step key, i) instead); calling the
    object with such a key then finds its noise there, and derives any
    other key on the spot. With `block` B < lanes (the sweep's
    config_block) the lanes' keys of every slice [g*B, (g+1)*B) find
    their noise too: the slices of the block's one derivation, never a
    derivation of their own. The host's share of a step stays a few
    microseconds however many lanes there are."""
    BLOCK = 64

    def __init__(self, n: int, seeded, subs: int = 1):
        self.n, self.seeded, self.subs = n, list(seeded), int(subs)
        self._steps, self._memo = {}, {}

    def _derive(self, rng):
        if not self.n:
            return None, None
        nk = noise_keys(rng, self.n)
        return nk, (prng.randint(nk[..., self.seeded, :]) if self.seeded
                    else None)

    def step_key(self, key, it: int, lanes: int = 0,
                 block: int = 0) -> np.ndarray:
        at = (np.asarray(key).tobytes(), int(it), int(lanes))
        if at not in self._steps:
            cuts = ([slice(g, g + block) for g in range(0, lanes, block)]
                    if lanes and 0 < block < lanes else [])
            rng = prng.fold_in(key, np.arange(it, it + self.BLOCK))
            if lanes:
                rng = prng.fold_in(rng[:, None], np.arange(lanes))
            self._steps = {(at[0], it + b, at[2]): rng[b]
                           for b in range(self.BLOCK)}
            self._memo = {}
            for read in ([rng] if self.subs == 1 else
                         [prng.fold_in(rng, i) for i in range(self.subs)]):
                nk, seeds = self._derive(read)
                for sl in [slice(None)] + cuts:
                    self._memo.update({
                        (read[b][sl].shape, read[b][sl].tobytes()): (
                            None if nk is None else nk[b][sl],
                            None if seeds is None else seeds[b][sl])
                        for b in range(self.BLOCK)})
        return self._steps[at]

    def lane_step_keys(self, key, its, cfgs) -> np.ndarray:
        """(k, C, 2) step keys of per-lane clocks `its` (k, C) (the
        self-healing sweep's virtual time): lane c's key at row j is
        fold_in(fold_in(key, its[j, c]), cfgs[c]), folded by the lane's
        config id, as the reference's virtual-time step derives it. The
        noise of all k rows is derived here in one vectorised pass, and
        found by calling the object with a row."""
        rng = prng.fold_in(prng.fold_in(key, np.asarray(its, np.int64)),
                           np.asarray(cfgs, np.int64)[None])
        nk, seeds = self._derive(rng)
        self._memo = {(rng[b].shape, rng[b].tobytes()): (
            None if nk is None else nk[b],
            None if seeds is None else seeds[b]) for b in range(len(rng))}
        return rng

    def __call__(self, rng):
        rng = np.asarray(rng, dtype=np.uint32)
        hit = self._memo.get((rng.shape, rng.tobytes()))
        return hit if hit is not None else self._derive(rng)


def stack_batches(feed: Callable, iter_size: int, device) -> dict:
    """One pull of `feed` as tensors on `device`, or, at iter_size > 1,
    that many pulls stacked on a leading axis (Solver::Step's
    sub-batches, in pull order). A pull may hold host arrays or tensors
    (a prefetching feed's, already on the device)."""
    if max(int(iter_size), 1) == 1:
        return batch_to(feed(), device)
    subs = [feed() for _ in range(int(iter_size))]
    if any(isinstance(v, torch.Tensor) for v in subs[0].values()):
        return {k: torch.stack([batch_to({k: sb[k]}, device)[k]
                                for sb in subs]) for k in subs[0]}
    return {k: torch.from_numpy(np.stack([np.asarray(sb[k]) for sb in subs]))
            .to(device) for k in subs[0]}


def _lane_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) per-lane vector shaped to broadcast over `like` (C, ...)."""
    return v.view((-1,) + (1,) * (like.dim() - 1))


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without a blocking copy (a pinned buffer
    and a non-blocking copy on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _lane_seeds(seeds: np.ndarray, device) -> torch.Tensor:
    """(lanes,) int32 crossbar seeds placed on `device` without a
    blocking copy (a pinned buffer; a plain copy to the card would wait
    for the stream at every step)."""
    return _to_device(np.asarray(seeds, dtype=np.int32), device)


def solver_seed(param) -> int:
    """The run's seed, as the reference picks it: `random_seed` when >=
    0, else RRAM_TPU_SEED (masked to 31 bits), else the wall clock."""
    if param.random_seed >= 0:
        return int(param.random_seed)
    if os.environ.get("RRAM_TPU_SEED"):
        return int(os.environ["RRAM_TPU_SEED"]) & 0x7FFFFFFF
    return int(time.time()) & 0x7FFFFFFF


def _test_net_params(param) -> list:
    """InitTestNets' sources (solver.cpp:156-230): test_net_param
    entries, then test_net files, then the train net once for every
    test_iter entry left; one test_iter and at most one test_state per
    net."""
    sources = [p.copy() for p in param.test_net_param]
    sources += [read_net_param(path) for path in param.test_net]
    if len(param.test_iter) > len(sources) and (
            param.HasField("net") or param.HasField("net_param")):
        sources += [_train_net_param(param)
                    for _ in range(len(param.test_iter) - len(sources))]
    if len(param.test_iter) != len(sources):
        raise ValueError(
            f"test_iter has {len(param.test_iter)} entries but "
            f"{len(sources)} test nets could be sourced")
    if param.test_state and len(param.test_state) != len(sources):
        raise ValueError(
            f"test_state must have one entry per test net "
            f"({len(param.test_state)} != {len(sources)})")
    return sources


def _train_net_param(param) -> proto.Message:
    """Solver::InitTrainNet (solver.cpp:95-130): exactly one of net /
    net_param / train_net / train_net_param."""
    sources = [f for f in ("net", "net_param", "train_net",
                           "train_net_param") if param.HasField(f)]
    if len(sources) != 1:
        raise ValueError("specify exactly one train net source "
                         f"(got {len(sources)})")
    src = sources[0]
    if src in ("net_param", "train_net_param"):
        return getattr(param, src).copy()
    return read_net_param(getattr(param, src))


class Solver:
    """Owns the train net, params, SGD history and fault state, and runs
    the step. `device` defaults to the card (raises without one unless
    device="cpu"). The step's configuration (engine, dtype policy,
    fault-bank format, fused epilogue) is fixed at construction;
    `make_train_step` builds other configurations for comparison.
    `test_feeds` (one callable per test net) default to each test net's
    own Data layers, pulled in the step; with `prefetch` those default
    feeds run ahead on producer threads instead (data/feed.py
    PrefetchingFeed), which `close()` stops."""

    def __init__(self, param, device=None,
                 train_feed: Optional[Callable] = None, test_feeds=None,
                 fail_decrement: Optional[float] = None,
                 hw_engine: str = "auto", dtype_policy=None,
                 fault_format: str = "f32", fused_epilogue=None,
                 tile_spec=None, conv_im2col=None, fault_process=None,
                 prefetch: bool = False):
        if isinstance(param, str):
            param = read_solver_param(param)
        self.param = param
        self.device = resolve_device(device)
        self.type = U.resolve_solver_type(param)
        if self.type not in U.UPDATE_RULES:
            raise ValueError(f"unknown solver type {self.type!r}")
        # the constructor's spec wins over the proto's rram_forward.tiles
        if tile_spec is None and param.HasField("rram_forward"):
            tile_spec = param.rram_forward.tiles or None
        self.tile_spec = TileSpec.parse(tile_spec)
        if conv_im2col is not None:
            conv_im2col = str(conv_im2col).strip().lower()
            if conv_im2col not in CONV_OPERANDS:
                raise ValueError(f"Solver(conv_im2col={conv_im2col!r}): "
                                 "expected 'premat', 'tilewise' or "
                                 "'implicit'")
        self.conv_im2col = conv_im2col
        self.iter = 0
        self.losses: list = []
        self.smoothed_loss = 0.0
        self._requested_action = None   # "stop": the step loop ends
        self.last_loss = None
        self.last_outputs = {}
        self.seed = solver_seed(param)
        # the key chain on the host; every draw derives from it alone
        self._key = prng.PRNGKey(self.seed)

        self.net = Net(_train_net_param(param), proto.TRAIN,
                       stages=tuple(param.train_state.stage),
                       level=param.train_state.level, device=self.device)
        self.test_nets = []
        for i, net_param in enumerate(_test_net_params(param)):
            state = (param.test_state[i] if i < len(param.test_state)
                     else proto.Message("NetState"))
            self.test_nets.append(Net(net_param, proto.TEST,
                                      stages=tuple(state.stage),
                                      level=state.level, device=self.device))
        self._key, k_init = prng.split(self._key)
        self.params = self.net.init(k_init)
        seen = set()
        self._owner_refs = [
            r for r in self.net.learnable_params
            if r.key == (r.layer_name, r.slot)
            and not (r.key in seen or seen.add(r.key))]
        self.history = U.init_history(self.type, self._flat(self.params))

        self.fail_decrement = 100.0 if fail_decrement is None \
            else float(fail_decrement)
        if not self.fail_decrement > 0:
            raise ValueError(f"fail_decrement must be > 0, got "
                             f"{fail_decrement!r}")
        self._fault_keys = [fault_engine.param_key(r.layer_name, r.slot)
                            for r in self.net.failure_param_refs]
        pattern = param.failure_pattern
        if param.HasField("failure_pattern") and pattern.conv_also:
            # conv params are crossbar cells too (the fork's fault-prone
            # set is InnerProduct-only, net.cpp:485-493); the port has no
            # Deconvolution layer yet
            for r in self._owner_refs:
                layer = self.net.layer_by_name[r.layer_name]
                k = fault_engine.param_key(r.layer_name, r.slot)
                if layer.type_name == "Convolution" \
                        and k not in self._fault_keys:
                    self._fault_keys.append(k)
        refs = self.net.failure_param_refs
        self._crossbar_keys = {
            fault_engine.param_key(refs[i].layer_name, refs[i].slot)
            for i in self.net.fc_params_ids}
        self.fault_state = None
        # the fault-process stack (fault/processes/): a spec string
        # ("endurance_stuck_at", the default, or e.g.
        # "endurance_stuck_at+conductance_drift:nu=0.2") or a FaultSpec;
        # the stack owns the fault state's groups and the Fail transform
        self.fault_spec = FaultSpec.parse(fault_process)
        self.fault_process = None
        if (param.HasField("failure_pattern") and self._fault_keys
                and pattern.type == "gaussian"):
            self.fault_process = self.fault_spec.build(tiles=self.tile_spec)
            self._key, k_fault = prng.split(self._key)
            flat = self._flat(self.params)
            shapes = {k: tuple(flat[k].shape) for k in self._fault_keys}
            self.fault_state = self.fault_process.init_state(
                k_fault, shapes, pattern, device=self.device)
        elif self.fault_spec.canonical() != DEFAULT_PROCESS:
            # fault-free training under a process the caller asked for
            # would report physics that did not run
            raise ValueError(
                f"fault_process {self.fault_spec.canonical()!r} is "
                "configured but no fault engine is active — it needs "
                "failure_pattern { type: 'gaussian' } and at least one "
                "fault-target layer")
        self._check_tile_coverage()
        self.fc_pairs = self._fc_pairs()
        flat0 = self._flat(self.params)
        hidden_sizes = [int(flat0[w].shape[0]) for w, _ in self.fc_pairs[:-1]]
        self.strategies = fault_strategies.build_strategies(
            param, self.fc_pairs, prune_net_loader=self._load_prune_net,
            hidden_sizes=hidden_sizes)
        if (self.fault_process is not None
                and not self.fault_process.has_lifetimes
                and (self.strategies.prune_orders is not None
                     or self.strategies.genetic is not None)):
            # the remapping and genetic strategies read the lifetimes and
            # stuck values (strategy.cpp:36-45)
            raise ValueError(
                "the remap/genetic failure strategies read the "
                "lifetimes/stuck state of a clamp-family fault "
                "process, but the configured stack "
                f"{self.fault_spec.canonical()!r} has none")
        for on, what in ((self.strategies.remap_tracked,
                          "remapping with track_identity"),
                         (self.strategies.genetic, "the genetic strategy")):
            if on and self.fault_state is None:
                raise ValueError(f"{what} needs an active fault engine "
                                 "(failure_pattern { type: 'gaussian' })")
        if self.strategies.remap_tracked:
            # logical neuron -> physical slot per hidden group, identity
            # at the start (remap_fc_neurons_tracked)
            self.fault_state["remap_slots"] = {
                str(i): torch.arange(n, dtype=torch.int32, device=self.device)
                for i, n in enumerate(hidden_sizes)}
        if (param.HasField("rram_forward")
                and (param.rram_forward.sigma or param.rram_forward.adc_bits)
                and self.fault_state is None):
            raise ValueError(
                "rram_forward is configured but no fault engine is active "
                "— it requires failure_pattern { type: 'gaussian' } and at "
                "least one fault-target layer (InnerProduct, or Convolution "
                "with failure_pattern { conv_also: true })")
        if param.HasField("rram_forward") and \
                param.rram_forward.adc_bits == 1:
            raise ValueError("rram_forward.adc_bits = 1 gives a symmetric "
                             "quantizer zero levels; use adc_bits >= 2")
        if (param.HasField("rram_forward")
                and (param.rram_forward.sigma or param.rram_forward.adc_bits)
                and self.fault_process is not None
                and not self.fault_process.has_lifetimes):
            raise ValueError(
                "rram_forward reads the broken/stuck masks of a "
                "clamp-family fault process (endurance_stuck_at, "
                "read_disturb, permanent_fault_map), but the configured "
                f"stack {self.fault_spec.canonical()!r} has none")

        # the default feeds are raw unless asked to prefetch: on the card
        # a producer thread made host-bound steps slower (PERF.md §6)
        dev = self.device if prefetch else None
        self._default_train_feed = (None if train_feed is not None
                                    else build_feed(self.net, prefetch, dev))
        self.train_feed = train_feed or self._default_train_feed
        self.test_feeds = (list(test_feeds) if test_feeds is not None
                           else [build_feed(tn, prefetch, dev)
                                 for tn in self.test_nets])
        self._lr_fn = learning_rate_fn(param)
        self.pack_spec = None
        if fault_format == "packed" and self.fault_state is not None:
            stack = self.fault_process
            if not stack.supports_packed:
                raise ValueError(
                    "fault_format='packed' is not supported by fault "
                    f"process(es) {stack.unpackable()} of the configured "
                    f"stack {stack.canonical()!r} (no lifetime counters "
                    "to bank); build with fault_format='f32'")
            # the counters' quantum is the stack's (read_disturb: its
            # reads a step)
            self.pack_spec = fault_packed.make_pack_spec(
                self.fault_state, stack.write_quantum(self.fail_decrement),
                pattern=pattern)
            self.fault_state = fault_packed.pack_state(self.fault_state,
                                                       self.pack_spec)
        # telemetry (enable_metrics / enable_health)
        self.metrics_logger = None
        self._metrics_enabled = False
        self._mclock: Optional[_IntervalClock] = None
        self._seed_logged = False
        self._step_baked = False      # a step ran, or a sweep built one
        self._health_every = 0
        self._health_census = None
        self._health_ledger = None
        self._last_health_tick = None
        # the deep trace (observe/debug.py): the watchdog's policy makes
        # the step carry the sentinels without debug_info too
        self._watchdog = None           # None | "halt" | "snapshot"
        self.debug_spec = None          # NetDebugSpec once a step traces
        # a SweepRunner puts its checkpoint here, so the watchdog's
        # "snapshot" captures the sweep's state
        self._sweep_checkpoint = None
        self._step_opts = dict(hw_engine=hw_engine, dtype_policy=dtype_policy,
                               fault_format=fault_format,
                               pack_spec=self.pack_spec,
                               fused_epilogue=fused_epilogue)
        self._step_fn = self.make_train_step(**self._step_opts)
        self._snapshot_writer = None

    # ------------------------------------------------------------------
    def _fc_pairs(self):
        """[(weight key, bias key or None)] per fault-target FC layer, in
        failure_learnable_params order (net.cpp:485-493 fc_params_ids_)."""
        refs = self.net.failure_param_refs
        pairs = []
        for i in self.net.fc_params_ids:
            w = refs[i]
            bkey = None
            if i + 1 < len(refs) and refs[i + 1].layer_name == w.layer_name:
                bkey = fault_engine.param_key(refs[i + 1].layer_name,
                                              refs[i + 1].slot)
            pairs.append((fault_engine.param_key(w.layer_name, w.slot),
                          bkey))
        return pairs

    def _load_prune_net(self, net_file: str, model_file: str):
        """The genetic strategy's prune masks: the FC weights of
        `net_file` loaded from `model_file` (GeneticFailureStrategy
        ctor, strategy.hpp:145-180), as host arrays. A model that holds
        weights for none of the net's fault-target FC layers raises:
        the masks would be the fillers' random draw."""
        net = Net(read_net_param(net_file), proto.TEST, device="cpu")
        model = read_net_param(model_file)
        refs = [net.failure_param_refs[i] for i in net.fc_params_ids]
        trained = {lp.name for lp in model.layer if lp.blobs}
        if not trained & {r.layer_name for r in refs}:
            raise ValueError(
                f"prune_model_file {model_file!r} holds weights for none "
                f"of the fault-target FC layers of {net_file!r} "
                f"({[r.layer_name for r in refs]})")
        params = net.copy_trained_from(
            net.init(prng.PRNGKey(0)), model)
        return [params[r.layer_name][r.slot].numpy() for r in refs]

    def _remap_due_at(self, iteration: int) -> bool:
        """Whether remapping runs at `iteration` (strategy.cpp:91-93:
        Apply runs every iteration, so times_ == iteration + 1)."""
        return bool(self._remap_due_grid(iteration))

    def _remap_due_grid(self, t) -> np.ndarray:
        """`_remap_due_at` over an array of iteration clocks in one
        vectorised pass (the virtual-time sweep's (k, C) grid of lane
        clocks)."""
        s = self.strategies
        t = np.asarray(t, np.int64)
        if s.prune_orders is None or self.fault_state is None:
            return np.zeros(t.shape, dtype=bool)
        times = t + 1
        return (times >= s.remap_start) & (
            (times - s.remap_start) % s.remap_period == 0)

    def _check_tile_coverage(self):
        """A non-default tile spec needs a fault engine, and every conv
        fault target must have an im2col crossbar view: no grouped
        convolution."""
        ts = self.tile_spec
        if ts.is_default:
            return
        spec = ts.canonical()
        if self.fault_state is None:
            raise ValueError(
                f"tile_spec {spec!r} is configured but no fault engine is "
                "active — tiled crossbar mapping needs failure_pattern "
                "{ type: 'gaussian' } and at least one fault-target layer")
        flat = self._flat(self.params)
        for k in self._fault_keys:
            if flat[k].dim() <= 2:
                continue
            lname = k.rsplit("/", 1)[0]
            layer = self.net.layer_by_name[lname]
            if layer.group != 1:
                raise ValueError(
                    f"tile_spec {spec!r} cannot map fault-target layer "
                    f"{lname!r}: grouped convolution (group={layer.group}) "
                    "— each group is a separate im2col GEMM, so one tile "
                    "grid would straddle group boundaries; train it "
                    "untiled (tile_spec='1x1') or ungrouped")

    def _tiles_ctx(self) -> Optional[dict]:
        """{layer: (tr, tc) cells per tile} of every fault-target weight
        the spec splits into more than one tile: InnerProduct over its
        stored shape (the layer turns it to the (K, N) view), Convolution
        over its im2col view. None when nothing is tiled, so a 1x1 spec
        runs the untiled program."""
        ts = self.tile_spec
        if ts.is_default or self.fault_state is None:
            return None
        flat = self._flat(self.params)
        out = {}
        for k in self._fault_keys:
            shape = tuple(flat[k].shape)
            # FC weights and conv kernels; biases are one tile
            if (k in self._crossbar_keys or len(shape) > 2) \
                    and ts.n_tiles(shape) > 1:
                out[k.rsplit("/", 1)[0]] = ts.tile_dims(shape)
        return out or None

    def _flat(self, params) -> Dict[str, torch.Tensor]:
        return {fault_engine.param_key(r.layer_name, r.slot):
                params[r.layer_name][r.slot] for r in self._owner_refs}

    def _unflat(self, flat, like) -> dict:
        out = {ln: list(vals) for ln, vals in like.items()}
        for r in self._owner_refs:
            out[r.layer_name][r.slot] = flat[
                fault_engine.param_key(r.layer_name, r.slot)]
        return out

    # ------------------------------------------------------------------
    def make_train_step(self, hw_engine: str = "auto", dtype_policy=None,
                        fault_format: str = "f32", pack_spec=None,
                        fused_epilogue=None, lanes: int = 0,
                        conv_im2col=None, with_metrics=None,
                        with_debug=None):
        """Build step(params, history, fault_state, batch, it, rng,
        do_remap=None, record=True) -> (params', history', fault_state',
        loss, outputs), and with the metrics on a sixth value, the
        in-step metrics tree (`with_metrics`, default: whether
        `enable_metrics` ran): loss, lr, grad_norm (over iter_size),
        update_norm and, with a fault engine, `fault` (totals,
        per_param, writes_saved, per_process, per_tile under a tile
        spec), all device tensors, per lane under lanes. A step whose
        tree no record reads passes `record=False`: its tree then holds
        only `fault.writes_saved` (under a threshold strategy), which
        the records sum over their interval. `with_debug` (default:
        `debug_info` or an armed watchdog) adds the deep trace
        (observe/debug.py) as `metrics["debug"]`, every step and per lane
        under lanes: the forward, backward, update and fault-clamp
        mean-abs vectors, the all-params norms, the loss and the
        sentinels; the step then returns the sixth value with the
        metrics off too. Off, the step runs the same operations as
        without it. `rng` is the step's key, fold_in(solver
        key, it) (under lanes (C, 2), one per lane); it is the forward
        key Dropout and random DummyData draw from (sub-pass i of
        iter_size > 1 takes fold_in(rng, i)); fault key i reads
        with the noise key `noise_keys(rng)[i]`, a crossbar read with its
        randint seed. The solver's threshold and remapping strategies run
        inside it; remapping on the iterations `_remap_due_at(it)` names,
        or where `do_remap` says when it is given.

        `lanes` = C > 0 builds the same step over C config lanes (the
        sweep, parallel/sweep.py): params, history and fault state carry
        a leading C axis, the batch is shared, the loss is (C,), each
        lane has its own quantization grid and crossbar seed, and every
        kernel launches once for all lanes (Net.apply gives the layout).
        Per-lane clocks (the sweep's virtual time) are on where `clocks`
        is given, the (R, C) float32 device rows of
        `step.lane_clock_rows(it, do_remap)`: each lane's rate, Adam's
        correction at its clock + 1, its remap flag. `it` is then the
        (C,) host int64 clocks, `do_remap` their (C,) host flags, and the
        batch each lane's own (laned data tops).

        `hw_engine`: "cuda" reads crossbar weights through kernel B2 and
        runs the fused tail as kernel B1 (their wrappers: on CPU tensors
        the plain versions); "torch" calls the plain versions by name;
        "auto" is "cuda" on a CUDA device, else "torch". Either engine
        engages only when the crossbar read is armed (sigma > 0 or a
        quantizing `dtype_policy`: "ternary" = 2 bits, "int8" = 8).
        `fault_format` "packed" runs on the packed banks (with the
        `pack_spec` they were built with). `fused_epilogue`: None fuses
        when the crossbar read and the packed banks line up, True
        requires it, False keeps the unfused tail. `conv_im2col`
        (premat | tilewise | implicit) overrides the solver's; the step
        records what it asked for and what runs
        (`step.conv_im2col_requested/_resolved/_reason`)."""
        param = self.param
        if hw_engine not in HW_ENGINES:
            raise ValueError(f"unknown hw_engine {hw_engine!r} (expected "
                             f"one of {HW_ENGINES})")
        if dtype_policy not in DTYPE_POLICY_BITS:
            raise ValueError(f"unknown dtype_policy {dtype_policy!r} "
                             "(expected None, 'ternary', or 'int8')")
        if fault_format not in ("f32", "packed"):
            raise ValueError(f"unknown fault_format {fault_format!r} "
                             "(expected 'f32' or 'packed')")
        engine = hw_engine if hw_engine != "auto" else (
            "cuda" if self.device.type == "cuda" else "torch")
        has_fault = self.fault_state is not None
        # the fault-process stack runs Fail; a fault state installed
        # without one steps under the solver's spec (the reference's rule)
        process = self.fault_process
        if process is None and has_fault:
            process = self.fault_spec.build(tiles=self.tile_spec)
        q_bits = DTYPE_POLICY_BITS[dtype_policy]
        if q_bits and not has_fault:
            raise ValueError("dtype_policy quantizes the fault-target "
                             "crossbar cells and needs an active fault "
                             "engine (failure_pattern { type: 'gaussian' })")
        packed_on = fault_format == "packed"
        if packed_on and pack_spec is None:
            raise ValueError("fault_format='packed' needs the pack_spec the "
                             "banks were built with (make_pack_spec)")
        rf = param.rram_forward if param.HasField("rram_forward") else None
        hw_sigma = float(rf.sigma) if rf is not None and has_fault else 0.0
        adc_bits = int(rf.adc_bits) if rf is not None and has_fault else 0
        crossbar_on = bool(hw_sigma) or bool(q_bits)
        use_kernel = engine == "cuda"
        # weights are read through the crossbar kernel, biases and untiled
        # conv kernels through the plain quantize/perturb (the reference's
        # solver.py:723, :757-768, :890-899)
        tiles_ctx = self._tiles_ctx() if has_fault else None
        crossbar_keys = set(self._crossbar_keys) if crossbar_on else set()
        if crossbar_on and tiles_ctx:
            flat = self._flat(self.params)
            crossbar_keys |= {k for k in self._fault_keys
                              if k.rsplit("/", 1)[0] in tiles_ctx
                              and flat[k].dim() > 2}
        conv_mode, conv_resolved, conv_reason = self._resolve_conv_mode(
            conv_im2col, tiles_ctx, use_kernel and crossbar_on)
        fused_reason = None
        if fused_epilogue is False:
            fused_on, fused_reason = False, "disabled (fused_epilogue=False)"
        elif not crossbar_on:
            fused_on, fused_reason = False, (
                "crossbar read not armed (the epilogue is its kernel tail)")
        elif not packed_on:
            fused_on, fused_reason = False, (
                "needs the packed fault banks (fault_format='packed')")
        elif not process.supports_fused_epilogue:
            fused_on, fused_reason = False, \
                process.fused_unsupported_reason()
        else:
            fused_on = True
        if fused_epilogue and not fused_on:
            raise ValueError(f"fused_epilogue=True cannot engage: "
                             f"{fused_reason}")
        # kernel B1 (or its plain version) in the stack's mode
        fused_fn = functools.partial(
            fused_update_fail_leaves if use_kernel
            else fused_update_fail_leaves_plain,
            mode=process.fused_mode if fused_on else "write")
        metrics_on = (self._metrics_enabled if with_metrics is None
                      else bool(with_metrics))
        debug_on = (bool(param.debug_info) or self._watchdog is not None
                    if with_debug is None else bool(with_debug))
        spec = None
        if debug_on:
            from ..observe import debug as obs_debug
            if self.debug_spec is None:
                self.debug_spec = obs_debug.NetDebugSpec(
                    self.net, self._owner_refs, self._fault_keys)
            spec = self.debug_spec
            spec.check_lanes(lanes)
        tspec = self.tile_spec

        net = self.net
        owner_keys = [fault_engine.param_key(r.layer_name, r.slot)
                      for r in self._owner_refs]
        lr_mults = {k: r.lr_mult for k, r in zip(owner_keys, self._owner_refs)}
        decay_mults = {k: r.decay_mult
                       for k, r in zip(owner_keys, self._owner_refs)}
        fault_keys = list(self._fault_keys)
        # params a forward pass advances (BatchNorm's statistics)
        state_keys = [k for k, r in zip(owner_keys, self._owner_refs)
                      if net.layer_by_name[r.layer_name].updates_state]
        hp = U.Hyper(param)
        rule = U.UPDATE_RULES[self.type]
        lr_fn = self._lr_fn
        weight_decay = float(param.weight_decay)
        iter_size = max(int(param.iter_size), 1)
        clip = float(param.clip_gradients)
        reg_type = param.regularization_type
        if reg_type not in ("L1", "L2") and any(
                weight_decay * decay_mults[k] for k in owner_keys):
            raise ValueError(f"unknown regularization {reg_type!r}")
        decrement = self.fail_decrement
        threshold = self.strategies.threshold if fault_keys else None
        remap_on = self.strategies.prune_orders is not None and has_fault
        tracked = self.strategies.remap_tracked
        fc_pairs = list(self.fc_pairs)
        weight_keys = [w for w, _ in fc_pairs]
        prune_orders = ([torch.as_tensor(o, dtype=torch.long,
                                         device=self.device)
                         for o in self.strategies.prune_orders]
                        if remap_on else None)

        def life_view(fault_state):
            """The f32 lifetimes of the fault leaves: the mid-bin view of
            packed counters."""
            if packed_on:
                return {k: fault_packed.unpack_lifetimes(
                            q, pack_spec["decrement"])
                        for k, q in fault_state["life_q"].items()}
            # a decay-only stack carries no lifetimes: {} (no census)
            return fault_state.get("lifetimes", {})

        def apply_strategy(data, upd, fault_state, it, do_remap, rate,
                           remap_mask=None):
            """ApplyStrategy (solver.cpp:302), in the reference's order:
            threshold on the fault keys' updates, then remapping. Also
            returns the writes the threshold suppressed (metrics on).
            Under per-lane clocks `rate` is the (C,) rates, `do_remap`
            the (C,) host flags and `remap_mask` their device copy: when
            any lane is due, every lane is remapped and the result kept
            in the due lanes alone (the reference's vmapped cond)."""
            saved = None
            if threshold is not None:
                before = {k: upd[k] for k in fault_keys}
                after = fault_strategies.threshold_diffs(
                    before, rate, lr_mults, threshold)
                if metrics_on:
                    saved = obs_counters.write_traffic_saved(
                        before, after, fault_engine.EPSILON32,
                        lifetimes=(life_view(fault_state) or None)
                        if has_fault else None, lanes=lanes)
                upd = {**upd, **after}
            if remap_on and bool(np.any(self._remap_due_at(it)
                                        if do_remap is None else do_remap)):
                view = (fault_packed.unpacked_view(fault_state, pack_spec,
                                                   weight_keys)
                        if packed_on else fault_state)
                slots = None
                if tracked:
                    new_d, new_u, slots = \
                        fault_strategies.remap_fc_neurons_tracked(
                            data, upd, view, fc_pairs, prune_orders,
                            fault_state["remap_slots"])
                else:
                    new_d, new_u = fault_strategies.remap_fc_neurons(
                        data, upd, view, fc_pairs, prune_orders)
                if remap_mask is not None:
                    def due(new, old):
                        return new if new is old else torch.where(
                            _lane_view(remap_mask, new), new, old)
                    new_d = {k: due(v, data[k]) for k, v in new_d.items()}
                    new_u = {k: due(v, upd[k]) for k, v in new_u.items()}
                    if slots is not None:
                        slots = {g: due(v, fault_state["remap_slots"][g])
                                 for g, v in slots.items()}
                data, upd = new_d, new_u
                if slots is not None:
                    fault_state = {**fault_state, "remap_slots": slots}
            return data, upd, fault_state, saved

        def metrics_tree(loss, rate, grad_sumsq, upd, prev_life,
                         fault_state, saved):
            """The in-step telemetry (reference solver.py:1127-1180),
            device tensors only: nothing here waits for the card."""
            dev = loss.device
            shape = (lanes,) if lanes else ()
            metrics = {
                "loss": loss.float(),
                "lr": (rate.clone() if isinstance(rate, torch.Tensor)
                       else torch.full(shape, rate, dtype=torch.float32,
                                       device=dev)),
                # over a device fill of iter_size: a tensor made from a
                # host scalar would be a synchronizing copy
                "grad_norm": U._sqrt(grad_sumsq) / torch.full_like(
                    grad_sumsq, float(iter_size)),
                "update_norm": U._sqrt(
                    obs_counters.global_norm_sq(upd, lanes)),
            }
            if not has_fault:
                return metrics
            lv = life_view(fault_state)
            if lv:
                totals, per = fault_engine.fault_counters(prev_life, lv,
                                                          lanes)
            else:
                # no lifetimes (a decay-only stack): the census of none
                zero = torch.zeros(shape, dtype=torch.int64, device=dev)
                totals, per = {
                    "broken_total": zero, "newly_expired": zero,
                    "life_min": torch.full(shape, float("inf"),
                                           device=dev),
                    "life_mean": torch.zeros(shape, device=dev)}, {}
            totals["writes_saved"] = (
                saved if saved is not None
                else torch.zeros(shape, dtype=torch.int64, device=dev))
            metrics["fault"] = {**totals, "per_param": per}
            # each process's census columns (broken, drifted) under its
            # name
            pp = process.counters(fault_state, lv, lanes)
            if pp:
                metrics["fault"]["per_process"] = pp
            if not tspec.is_default:
                pt = {}
                for k in fault_keys:
                    if lv[k].dim() - (1 if lanes else 0) < 2:
                        continue
                    pt[k] = fault_mapping.per_tile_counters(
                        lv[k], broken_stuck(fault_state, k)[1], tspec,
                        lanes)
                if pt:
                    metrics["fault"]["per_tile"] = pt
            return metrics

        def broken_stuck(fault_state, k):
            if packed_on:
                return (fault_state["life_q"][k] <= 0,
                        fault_packed.unpack_stuck(
                            fault_state["stuck_bits"][k],
                            pack_spec["last_dim"][k]))
            return (fault_state["lifetimes"][k] <= 0,
                    fault_state["stuck"][k])

        # fault keys whose read draws: every crossbar read (its seed),
        # the host-noise reads only at sigma > 0
        noisy = [i for i, k in enumerate(fault_keys)
                 if k in crossbar_keys or hw_sigma]
        seeded = [i for i, k in enumerate(fault_keys) if k in crossbar_keys]
        step_noise = StepNoise(max(noisy) + 1 if crossbar_on and noisy
                               else 0, seeded, subs=iter_size)
        adam = rule is U.adam

        def lane_clock_rows(its, do_remap) -> np.ndarray:
            """(..., rows, C) float64 host rows of per-lane clocks `its`
            (..., C): each lane's float32 rate, Adam's correction at its
            clock + 1 (Adam only) and its remap flag `do_remap`
            (remapping only), from the host schedule at each distinct
            clock."""
            its = np.asarray(its, np.int64)
            uniq, inv = np.unique(its, return_inverse=True)
            inv = inv.reshape(its.shape)
            rows = [np.array([lr_fn(int(t)) for t in uniq], np.float32)[inv]]
            if adam:
                rows.append(np.array([U.adam_correction(hp, int(t) + 1)
                                      for t in uniq], np.float32)[inv])
            if remap_on:
                rows.append(np.asarray(do_remap, bool))
            return np.stack(rows, axis=-2).astype(np.float64)

        def forward_backward(params, fault_state, batch, rng,
                             laned_data=False):
            """One forward and backward pass: (loss, {owner key: grad},
            outputs, advanced statistics, debug), debug being (the
            forward trace vector, {site: cotangent}) or None.
            `laned_data`: the batch holds each lane's own samples."""
            leaves = {k: v.detach().requires_grad_()
                      for k, v in self._flat(params).items()}
            read = dict(leaves)
            crossbar = None
            if crossbar_on:
                crossbar = {}
                nkeys, seed_arr = step_noise(rng)
                seeds = (dict(zip(seeded, np.moveaxis(seed_arr, -1, 0)))
                         if seeded else {})
                for i, k in enumerate(fault_keys):
                    broken_k, stuck_k = broken_stuck(fault_state, k)
                    if k in crossbar_keys:
                        seed = (_lane_seeds(seeds[i], broken_k.device)
                                if lanes else int(seeds[i]))
                        crossbar[k.rsplit("/", 1)[0]] = (
                            broken_k, stuck_k, seed, hw_sigma, q_bits,
                            use_kernel)
                    else:
                        wk = read[k]
                        if q_bits:
                            wk = quantize_ste(wk, q_bits, lanes=lanes)
                        read[k] = perturb_weight(
                            wk, broken_k, stuck_k,
                            nkeys[..., i, :] if hw_sigma else None,
                            hw_sigma)
            read_params = self._unflat(read, params)
            probes = trace = None
            if debug_on:
                probes = spec.make_probes(lanes, self.device)
                trace = {}
            blobs, loss, new_params = net.apply(
                read_params, batch, rng=rng, adc_bits=adc_bits,
                crossbar=crossbar, lanes=lanes, tiles=tiles_ctx,
                conv_im2col=conv_resolved, with_updates=True,
                probes=probes, trace_sites=trace, laned_data=laned_data)
            # lanes are independent: d(sum of lane losses)/d(lane c's
            # params) is lane c's own gradient. The TRAIN graph never
            # reads BatchNorm's statistics: their gradient is zero, as
            # the reference's is
            sites = list(probes) if debug_on else []
            grads = torch.autograd.grad(
                loss.sum() if lanes else loss,
                [leaves[k] for k in owner_keys] + [probes[s] for s in sites],
                allow_unused=True)
            dbg = None
            if debug_on:
                pgrads = {s: torch.zeros_like(probes[s]) if g is None else g
                          for s, g in zip(sites, grads[len(owner_keys):])}
                dbg = (spec.forward_values(read_params, trace, lanes,
                                           self.device), pgrads)
                grads = grads[:len(owner_keys)]
            unused = [k for k, g in zip(owner_keys, grads)
                      if g is None and k not in state_keys]
            if unused:
                raise RuntimeError(f"no gradient reached {unused}: the "
                                   "forward pass does not read them")
            grads = [torch.zeros_like(leaves[k]) if g is None else g
                     for k, g in zip(owner_keys, grads)]
            outputs = {name: blobs[name].detach()
                       for name in net.output_names}
            advanced = self._flat(new_params)
            return loss.detach(), dict(zip(owner_keys, grads)), outputs, \
                {k: advanced[k] for k in state_keys}, dbg

        def step(params, history, fault_state, batch, it, rng,
                 do_remap=None, record=True, clocks=None):
            full = metrics_on and record
            # per-lane clocks: each lane on its own batch, rate and remap
            # cadence
            lane_time = clocks is not None
            # -- ForwardBackward x iter_size (solver.cpp:265-269) --
            if iter_size == 1:
                loss, g, outputs, stats, dbg = forward_backward(
                    params, fault_state, batch, rng, lane_time)
            else:
                # sub-pass i reads sub-batch i with fold_in(rng, i) and
                # the statistics sub-pass i - 1 advanced (the weights
                # stay the step's); the gradients and losses add up from
                # zeros, in order
                g = {k: torch.zeros_like(v)
                     for k, v in self._flat(params).items()}
                loss, stats, dbg = None, {}, None
                for i in range(iter_size):
                    sub_loss, sub_g, outputs, stats, sub_dbg = \
                        forward_backward(
                            self._unflat({**self._flat(params), **stats},
                                         params),
                            fault_state, {k: v[i] for k, v in batch.items()},
                            prng.fold_in(rng, i))
                    g = {k: g[k] + sub_g[k] for k in owner_keys}
                    if debug_on:
                        # the last sub-batch's forward; the cotangents
                        # add up like the gradients
                        dbg = sub_dbg if dbg is None else (sub_dbg[0], {
                            s: dbg[1][s] + v for s, v in sub_dbg[1].items()})
                    loss = (torch.zeros_like(sub_loss) if loss is None
                            else loss) + sub_loss
                loss = fault_engine._div(loss, iter_size)
            # BatchNorm's statistics already advanced (reference :994)
            data = {**{k: v.detach() for k, v in self._flat(params).items()},
                    **stats}
            if debug_on:
                g_dbg = g                   # the raw, pre-clip diffs
                norms_dbg = spec.all_param_norms(data, g_dbg, lanes)

            # -- ComputeUpdate (sgd_solver.cpp:102-117) --
            rate = clocks[0] if lane_time else lr_fn(it)
            grad_sumsq = (obs_counters.global_norm_sq(g, lanes)
                          if full else None)
            if clip >= 0:
                g = clip_gradients(g, clip, lanes)
            upd, new_hist = {}, {}
            for k in owner_keys:
                diff = g[k]
                if iter_size != 1:          # Normalize (sgd_solver.cpp:123)
                    diff = fault_engine._div(diff, iter_size)
                local_decay = weight_decay * decay_mults[k]
                if local_decay:             # Regularize (sgd_solver.cpp:149)
                    diff = diff + local_decay * (
                        data[k] if reg_type == "L2" else torch.sign(data[k]))
                if lane_time:
                    # float32 rate * lr_mult per lane; Adam reads each
                    # lane's correction in place of the step count
                    local_rate = _lane_view(
                        rate * float(np.float32(lr_mults[k])), diff)
                    t = _lane_view(clocks[1], diff) if adam else None
                else:
                    local_rate = float(np.float32(rate)
                                       * np.float32(lr_mults[k]))
                    t = it + 1
                upd[k], new_hist[k] = rule(diff, history[k], local_rate, hp,
                                           t)

            # -- ApplyStrategy (solver.cpp:302; strategy.cpp) --
            data, upd, fault_state, saved = apply_strategy(
                data, upd, fault_state, it, do_remap, rate,
                clocks[-1] > 0 if lane_time and remap_on else None)
            if debug_on:
                # UpdateDebugInfo (net.cpp:652-668): before the update,
                # with the data and diffs ApplyStrategy left
                upd_keys = spec.update_keys()
                upd_data_dbg = spec.values_for_keys(data, upd_keys, lanes,
                                                    self.device)
                upd_diff_dbg = spec.values_for_keys(upd, upd_keys, lanes,
                                                    self.device)

            # -- ApplyUpdate (sgd_solver.cpp:119); under the fused
            # epilogue the fault leaves' subtract moves into Fail --
            fused_keys = set(fault_keys) if fused_on else set()
            data = {k: v if k in fused_keys else v - upd[k]
                    for k, v in data.items()}

            # -- Fail (solver.cpp:305; failure_maker.cu:23-40) --
            prev_life = (life_view(fault_state)
                         if full and has_fault else None)
            if has_fault:
                if fused_on:
                    data, fault_state = fused_tail(fused_fn, fault_keys,
                                                   data, upd, fault_state)
                else:
                    fp = {k: data[k] for k in fault_keys}
                    fd = {k: upd[k] for k in fault_keys}
                    # the stack's processes in order (decay, then clamp)
                    if packed_on:
                        fp, fault_state = process.fail_packed(
                            fp, fault_state, fd, pack_spec)
                    else:
                        fp, fault_state = process.fail(
                            fp, fault_state, fd, decrement)
                    data.update(fp)
            out = (self._unflat(data, params), new_hist, fault_state, loss,
                   outputs)
            if not (metrics_on or debug_on):
                return out
            if not metrics_on:
                mets = {}
            elif not record:
                mets = ({"fault": {"writes_saved": saved}}
                        if saved is not None else {})
            else:
                mets = metrics_tree(loss, rate, grad_sumsq, upd, prev_life,
                                    fault_state, saved)
            if debug_on:
                dbg_bwd = spec.backward_values(dbg[1], g_dbg, lanes,
                                               self.device)
                fault_dbg = spec.values_for_keys(data, spec.fault, lanes,
                                                 self.device)
                mets = {**mets, "debug": {
                    "fwd": dbg[0], "bwd": dbg_bwd,
                    "upd_data": upd_data_dbg, "upd_diff": upd_diff_dbg,
                    "fault": fault_dbg, "norms": norms_dbg,
                    "loss": loss.float(),
                    "sentinel": obs_debug.sentinel_tree({
                        "forward": dbg[0], "backward": dbg_bwd,
                        "update": upd_diff_dbg, "fault": fault_dbg})}}
            return out + (mets,)

        step.noise = step_noise
        step.lane_clock_rows = lane_clock_rows
        step.with_metrics = metrics_on
        step.with_debug = debug_on
        step.hw_engine_resolved = engine if crossbar_on else None
        step.fused_epilogue_resolved = fused_on
        step.fused_epilogue_reason = None if fused_on else fused_reason
        step.fused_mode = process.fused_mode if fused_on else None
        step.conv_im2col_requested = conv_mode
        step.conv_im2col_resolved = conv_resolved
        step.conv_im2col_reason = conv_reason
        return step

    def _resolve_conv_mode(self, requested, tiles_ctx, use_kernel: bool):
        """(requested, resolved, reason) of the conv operand mode:
        make_train_step's argument, else the solver's, else
        RRAM_CONV_IM2COL, else "premat". Resolved is None when no tiled
        Convolution exists; "tilewise" on the kernel path runs as
        premat."""
        mode = requested if requested is not None else self.conv_im2col
        if mode is None:
            mode = os.environ.get("RRAM_CONV_IM2COL", "").strip().lower() \
                or None
        mode = str(mode).strip().lower() if mode else "premat"
        if mode not in CONV_OPERANDS:
            raise ValueError(f"conv_im2col / RRAM_CONV_IM2COL={mode!r}: "
                             "expected 'premat', 'tilewise' or 'implicit'")
        conv_tiled = [ln for ln in (tiles_ctx or {})
                      if self.net.layer_by_name[ln].type_name
                      == "Convolution"]
        if not conv_tiled:
            return mode, None, (None if mode == "premat" else (
                f"conv_im2col={mode!r} is inert: no tiled Convolution "
                "fault target in this net"))
        if use_kernel and mode == "tilewise":
            return mode, "premat", (
                "tilewise is a plain-path operand mode; the B2t kernel "
                "already streams the premat rows K-tile by K-tile — "
                "resolved to premat")
        if mode == "implicit":
            for ln in conv_tiled:
                layer = self.net.layer_by_name[ln]
                try:
                    conv_geom(layer.kernel, layer.stride, layer.pad,
                              layer.dilation)
                except ValueError as e:
                    return mode, "premat", (f"implicit im2col unsupported "
                                            f"— {ln}: {e}; resolved to "
                                            "premat")
            return mode, "implicit", (
                "backward materializes im2col patch rows (patches-based "
                "VJP, v1); forward gathers in-kernel")
        return mode, mode, None

    # ------------------------------------------------------------------
    def _next_batch(self) -> dict:
        """The step's batch on the device; under iter_size > 1 that many
        pulls stacked on a leading axis."""
        return stack_batches(self.train_feed, self.param.iter_size,
                             self.device)

    @property
    def custom_train_feed(self) -> bool:
        """Whether `train_feed` is another than the Solver's own default
        (given at construction or assigned since)."""
        return self.train_feed is not self._default_train_feed

    def close(self) -> None:
        """Stop the producer threads of the feeds this Solver holds."""
        for feed in [self._default_train_feed, self.train_feed,
                     *self.test_feeds]:
            getattr(feed, "close", lambda: None)()

    def step(self, iters: int):
        """Run `iters` training iterations (Solver::Step, solver.cpp:238);
        the loss stays on the device until display or the end. With
        metrics on, each display writes one record (the counters of the
        display's step, writes_saved summed over the interval); with
        health on, the census runs after the iterations its cadence
        names."""
        param = self.param
        start_iter = self.iter
        average_loss = max(param.average_loss, 1)
        self.losses = []
        genetic = self.strategies.genetic
        self._step_baked = True
        # with display 0 no record is ever due: nothing is accumulated
        track = self._metrics_enabled and bool(param.display)
        clock = self._mclock if track else None
        for _ in range(iters):
            if (param.test_interval and self.iter % param.test_interval == 0
                    and (self.iter > 0 or param.test_initialization)):
                t0 = time.perf_counter()
                self.test_all()
                if track:
                    clock.exclude(t0)
            if genetic is not None and genetic.due():
                self._apply_genetic(genetic)
            batch = self._next_batch()
            display = bool(param.display) and self.iter % param.display == 0
            out = self._step_fn(
                self.params, self.history, self.fault_state, batch,
                self.iter, self._step_fn.noise.step_key(self._key, self.iter),
                record=track and display)
            (self.params, self.history, self.fault_state, loss,
             self.last_outputs) = out[:5]
            metrics = out[5] if len(out) > 5 else {}
            self.last_loss = loss
            if len(self.losses) < average_loss:
                self.losses.append(loss)
            else:
                self.losses[(self.iter - start_iter) % average_loss] = loss
            if "debug" in metrics:
                # the debug lines print before the display block; a
                # watchdog stop takes effect at this loop's tail
                self._process_debug(metrics["debug"])
            if track:
                # a device scalar, summed at the next record
                clock.tick(1, metrics["fault"]["writes_saved"]
                           if "fault" in metrics else None)
            if display:
                self._materialize_smoothed_loss()
                print(f"Iteration {self.iter}, lr = {self._lr_fn(self.iter):g}",
                      flush=True)
                print(f"Iteration {self.iter}, loss = "
                      f"{self.smoothed_loss:g}", flush=True)
                self._print_outputs(self.last_outputs)
                if track:
                    now = time.perf_counter()
                    self._log_metrics_record(
                        metrics, self.last_outputs, clock.elapsed(now),
                        clock.n, writes_saved_acc=clock.ws)
                    clock.reset(now)
            self.iter += 1
            if self._health_every:
                self._maybe_health()
            if param.snapshot and self.iter % param.snapshot == 0:
                t0 = time.perf_counter()
                self.snapshot()
                if track:
                    clock.exclude(t0)
            if self._requested_action == "stop":
                break
        self._materialize_smoothed_loss()

    # ------------------------------------------------------------------
    # telemetry (observe/)

    def enable_metrics(self, *sinks, logger=None):
        """Attach metric sinks (observe/sink.py) and rebuild the step
        with the in-step counters; one record per display interval goes
        to every sink, the first with the run's seed. Call it before the
        first step() and before building a SweepRunner on this solver:
        after that it raises, as the reference's does once its step is
        built."""
        if self._step_baked:
            raise ValueError(
                "enable_metrics must be called before the train step is "
                "built (before the first step() and before constructing "
                "a SweepRunner)")
        from ..observe.sink import MetricsLogger
        self.metrics_logger = (logger if logger is not None
                               else MetricsLogger(list(sinks)))
        self._metrics_enabled = True
        self._mclock = _IntervalClock()
        self._step_fn = self.make_train_step(**self._step_opts)
        return self.metrics_logger

    def enable_health(self, every: int, threshold: Optional[float] = None):
        """Arm the wear census (observe/health.py): every `every`
        iterations a census of the fault state, apart from the step,
        writes a `health` record to the metric sinks and feeds
        `health_ledger`. Any time is fine (the step does not change);
        `every=0` disarms. Needs a fault engine."""
        every = int(every)
        if every < 0:
            raise ValueError(f"health_every must be >= 0, got {every}")
        if every and self.fault_state is None:
            raise ValueError(
                "enable_health needs an active fault engine "
                "(failure_pattern { type: 'gaussian' } and at least "
                "one fault-target layer)")
        from ..observe import health as obs_health
        self._health_every = every
        self._health_census = None
        if every:
            kw = ({"threshold": float(threshold)}
                  if threshold is not None else {})
            self._health_ledger = obs_health.HealthLedger(**kw)
            self._last_health_tick = None
        return self._health_ledger

    def enable_watchdog(self, policy: str = "halt"):
        """Arm the divergence watchdog: the step then carries the
        numeric sentinels (observe/debug.py) without debug_info too, and
        every iteration the host reads them. On a tripped sentinel or a
        non-finite loss it prints a diagnostic naming the first bad
        phase and layer or param, snapshots under "snapshot" (the
        sweep's checkpoint when a SweepRunner armed it), and stops the
        run. "none" leaves it off. Call it before the first step() and
        before building a SweepRunner on this solver, as
        enable_metrics."""
        if policy == "none":
            return
        if policy not in ("halt", "snapshot"):
            raise ValueError(
                f"unknown watchdog policy {policy!r} "
                "(expected halt, snapshot, or none)")
        if self._step_baked:
            raise ValueError(
                "enable_watchdog must be called before the train step "
                "is built (before the first step() and before "
                "constructing a SweepRunner)")
        self._watchdog = policy
        self._step_fn = self.make_train_step(**self._step_opts)

    def _process_debug(self, dbg, iteration: Optional[int] = None) -> bool:
        """One iteration's debug tree to the host, and what follows from
        it: the reference's lines printed and a `debug_trace` record
        logged (debug_info), a `sentinel` record on a trip, and the
        watchdog's policy. Returns True when the watchdog stopped the
        run. One transfer an iteration: the trace's own cost."""
        from ..observe import sink as obs_sink
        spec = self.debug_spec
        it = self.iter if iteration is None else iteration
        if self.param.debug_info:
            host = obs_counters.to_host(dbg)
        else:
            # the watchdog alone reads the sentinels and the loss
            host = obs_counters.to_host({"sentinel": dbg["sentinel"],
                                         "loss": dbg["loss"]})
        summ = spec.sentinel_summary(host)
        if self.param.debug_info:
            rec = spec.trace_record(it, host)
            for line in obs_sink.debug_trace_lines(rec):
                print(line, flush=True)
            if self.metrics_logger is not None:
                self.metrics_logger.log(rec)
        loss_bad = not np.isfinite(summ["loss"])
        if (summ["tripped"] or loss_bad) and self.metrics_logger is not None:
            self.metrics_logger.log(spec.sentinel_record(it, summ))
        if self._watchdog is None or not (summ["tripped"] or loss_bad):
            return False
        where = (f"{summ['phase']} phase, {summ['entry']}"
                 if summ["tripped"]
                 else f"loss = {summ['loss']} (non-finite)")
        flags = summ["flags"]
        print(f"Watchdog tripped at iteration {it}: {where} "
              f"(nan={flags['nan']}, inf={flags['inf']}, "
              f"overflow={flags['overflow']})", flush=True)
        if self._watchdog == "snapshot":
            if self._sweep_checkpoint is not None:
                path = self._sweep_checkpoint()
                print(f"Watchdog sweep checkpoint saved to {path}",
                      flush=True)
            else:
                path = self.snapshot()
                print(f"Watchdog snapshot saved to {path}", flush=True)
        print("Watchdog stopping optimization.", flush=True)
        self._requested_action = "stop"
        return True

    @property
    def health_ledger(self):
        return self._health_ledger

    def _maybe_health(self):
        """The census when `iter` crossed a health_every boundary since
        the last one (armed at the first call: the first census comes at
        the next boundary)."""
        every = self._health_every
        if not every or self.fault_state is None:
            return None
        tick = self.iter // every
        if self._last_health_tick is None:
            self._last_health_tick = tick
            return None
        if tick == self._last_health_tick:
            return None
        self._last_health_tick = tick
        from ..observe import health as obs_health
        from ..observe import sink as obs_sink
        stack = self.fault_process
        if self._health_census is None:
            self._health_census = obs_health.CensusProgram(
                stack, stacked=False, pack_spec=self.pack_spec)
        params = self._health_census(self.fault_state)
        rec = obs_sink.make_health_record(
            self.iter, params, process=stack.canonical(), every=every,
            decrement=stack.write_quantum(self.fail_decrement),
            life_edges=obs_health.LIFE_EDGES,
            age_edges=obs_health.AGE_EDGES,
            tiles=(None if self.tile_spec.is_default
                   else self.tile_spec.canonical()))
        if self.metrics_logger is not None:
            self.metrics_logger.log(rec)
        if self._health_ledger is not None:
            self._health_ledger.update(rec)
        return rec

    def _log_metrics_record(self, metrics, outputs, elapsed_s, n_iters,
                            iteration=None, writes_saved_acc=None):
        """One record from the step's counters, the outputs and the
        interval's summed writes_saved (int64 on the host), fetched in
        one transfer at the display boundary; written to every sink."""
        from ..observe import sink as obs_sink
        names = [n for n in self.net.output_names if n in (outputs or {})]
        host = obs_counters.to_host({
            "m": metrics or {}, "ws": list(writes_saved_acc or []),
            "o": {n: outputs[n].reshape(-1) for n in names}})
        mets = host["m"]
        if host["ws"] and "fault" in mets:
            mets["fault"]["writes_saved"] = int(sum(
                int(np.asarray(v, np.int64).sum()) for v in host["ws"]))
        outs = {n: v[0] if len(v) == 1 else v for n, v in host["o"].items()}
        rec = obs_sink.make_record(
            iteration=self.iter if iteration is None else iteration,
            metrics=mets, smoothed_loss=self.smoothed_loss, outputs=outs,
            elapsed_s=elapsed_s, n_iters=n_iters,
            seed=None if self._seed_logged else self.seed)
        self._seed_logged = True
        self.metrics_logger.log(rec)
        return rec

    def solve(self, resume_file: Optional[str] = None,
              fused_chunk: Optional[int] = None):
        """Solver::Solve (solver.cpp:328-375): restore `resume_file`
        when given, train to max_iter, write the last snapshot unless
        the step just wrote it (`snapshot_after_train`), display and
        test at the end as the reference does. `fused_chunk` (the
        reference's step_fused) is not ported and raises."""
        if fused_chunk:
            raise NotImplementedError(
                f"Solver.solve(fused_chunk={fused_chunk!r}): step_fused is "
                "not ported to the PyTorch/CUDA package; call solve() "
                "without it")
        param = self.param
        # refuse before training, not after it at the first snapshot
        if param.snapshot_after_train or (
                param.snapshot and param.max_iter >= param.snapshot):
            self._refuse_hdf5("solve()")
        print(f"Solving {self.net.name}", flush=True)
        if resume_file:
            self.restore(resume_file)
        self.step(param.max_iter - self.iter)
        if param.snapshot_after_train and (
                not param.snapshot or self.iter % param.snapshot != 0):
            self.snapshot()
        if param.display and self.iter % param.display == 0:
            print(f"Iteration {self.iter}, loss = {self.smoothed_loss:g}",
                  flush=True)
        if param.test_interval and self.iter % param.test_interval == 0:
            self.test_all()
        # queued background writes land (or raise) before the run is done
        self.wait_for_snapshots()
        print("Optimization Done.", flush=True)

    def _print_outputs(self, outputs):
        """The reference's display lines of the train net's outputs, one
        per value (solver.cpp:271-285): `    Train net output #j: name =
        v`, with ` (* w = w*v loss)` where the loss weight is nonzero."""
        for j, name in enumerate(self.net.output_names):
            w = self.net.loss_weights.get(name, 0.0)
            for v in outputs[name].reshape(-1).float().cpu().numpy():
                extra = f" (* {w:g} = {w * float(v):g} loss)" if w else ""
                print(f"    Train net output #{j}: {name} = {float(v):g}"
                      f"{extra}", flush=True)

    def _apply_genetic(self, genetic):
        """One genetic application between steps (the reference runs it
        mid-step, but the updates it would also permute are consumed by
        the same step's ApplyUpdate, so swapping the weights before the
        next step is the same): the FC params and their lifetimes to
        the host (from the unpacked view under packed banks), the
        search, the params back."""
        flat = self._flat(self.params)
        keys = [k for pair in self.fc_pairs for k in pair if k is not None]
        data = {k: flat[k].detach().cpu().numpy().copy() for k in keys}
        diffs = {k: np.zeros_like(v) for k, v in data.items()}
        weights = [w for w, _ in self.fc_pairs]
        state = (fault_packed.unpacked_view(self.fault_state, self.pack_spec,
                                            weights)
                 if self.pack_spec is not None else self.fault_state)
        genetic.apply(data, diffs, {k: state["lifetimes"][k].cpu().numpy()
                                    for k in weights})
        flat.update({k: torch.from_numpy(v).to(self.device)
                     for k, v in data.items()})
        self.params = self._unflat(flat, self.params)

    # ------------------------------------------------------------------
    # test nets (Solver::Test, solver.cpp:386-459)

    def _test_context(self) -> dict:
        """Net.apply options of a test forward: the chip's ADC and tiles
        (the same silicon in either phase), no crossbar masks, sigma 0
        (the read noise averages out over test_iter), and the conv
        operand mode as asked (argument, else RRAM_CONV_IM2COL)."""
        if self.fault_state is None:
            return {}
        ctx = {"adc_bits": (int(self.param.rram_forward.adc_bits)
                            if self.param.HasField("rram_forward") else 0)}
        tiles = self._tiles_ctx()
        if tiles is not None:
            ctx["tiles"] = tiles
            mode = self.conv_im2col or (os.environ.get(
                "RRAM_CONV_IM2COL", "").strip().lower() or None)
            if mode:
                ctx["conv_im2col"] = mode
        return ctx

    def test(self, idx: int = 0) -> dict:
        """Run test net `idx` over its test_iter batches and print the
        reference's lines (`Iteration N, Testing net (#i)`, `Test net
        output #j: name = v`); returns {output: its first mean value}."""
        net = self.test_nets[idx]
        feed = self.test_feeds[idx]
        ctx = self._test_context()
        test_iter = (self.param.test_iter[idx]
                     if idx < len(self.param.test_iter) else 1)
        totals: Dict[str, torch.Tensor] = {}
        loss_total = 0.0
        with torch.no_grad():
            for i in range(test_iter):
                batch = batch_to(feed(), self.device)
                # test batch i's forward key (reference solver.py:2114)
                rng = prng.fold_in(prng.fold_in(self._key, self.iter), i)
                blobs, loss = net.apply(self.params, batch, rng=rng, **ctx)
                if self.param.test_compute_loss:
                    loss_total += float(loss)
                for name in net.output_names:
                    v = blobs[name].reshape(-1).float()
                    totals[name] = totals[name] + v if name in totals else v
        print(f"Iteration {self.iter}, Testing net (#{idx})", flush=True)
        if self.param.test_compute_loss:
            print(f"Test loss: {loss_total / test_iter:g}", flush=True)
        scores = {}
        j = 0
        for name in net.output_names:
            # the mean on the host, as the reference divides in numpy
            mean = totals[name].cpu().numpy() / test_iter
            w = net.loss_weights.get(name, 0.0)
            for v in mean:
                extra = f" (* {w:g} = {w * float(v):g} loss)" if w else ""
                print(f"    Test net output #{j}: {name} = {float(v):g}"
                      f"{extra}", flush=True)
                j += 1
            scores[name] = float(mean[0])
        return scores

    def test_all(self) -> list:
        return [self.test(i) for i in range(len(self.test_nets))]

    def _materialize_smoothed_loss(self) -> float:
        if self.losses:
            self.smoothed_loss = float(torch.stack(self.losses).mean())
        return self.smoothed_loss

    def broken_fraction(self) -> float:
        if self.fault_state is None:
            return 0.0
        return fault_engine.broken_fraction(self.fault_state)

    # ------------------------------------------------------------------
    # snapshot / restore (solver.cpp:461-532, sgd_solver.cpp:250-356)

    def snapshot_filename(self, ext: str) -> str:
        return f"{self.param.snapshot_prefix}_iter_{self.iter}{ext}"

    def _owner_keys(self) -> list:
        return [fault_engine.param_key(r.layer_name, r.slot)
                for r in self._owner_refs]

    def _history_blob_list(self) -> list:
        """The history as host arrays in the reference's order: each
        slot's bank for every param, slot after slot."""
        return [self.history[k][s].detach().cpu().numpy()
                for s in U.HISTORY_SLOTS[self.type]
                for k in self._owner_keys()]

    def _set_history_from_list(self, blobs):
        slots, keys = U.HISTORY_SLOTS[self.type], self._owner_keys()
        if len(blobs) != len(slots) * len(keys):
            raise ValueError(
                f"Incorrect length of history blobs: {len(blobs)} != "
                f"{len(slots) * len(keys)}")
        blobs = iter(blobs)
        history = {k: dict(v) for k, v in self.history.items()}
        for s in slots:
            for k in keys:
                live = history[k][s]
                history[k][s] = torch.as_tensor(
                    np.asarray(next(blobs)).reshape(tuple(live.shape)),
                    dtype=live.dtype, device=live.device)
        self.history = history

    def enable_background_snapshots(self):
        """Write snapshots on a background thread (async_exec
        .BackgroundWriter): `snapshot()` then costs the step's thread the
        device fetch of params, history and fault state; the encoding
        and the write (a sibling temp file, then an atomic rename) run
        on the writer. `wait_for_snapshots()` is the barrier (`restore`
        and `solve` take it); a writer error re-raises at the next
        snapshot or wait."""
        if self._snapshot_writer is None:
            self._snapshot_writer = async_exec.BackgroundWriter()
        return self._snapshot_writer

    def wait_for_snapshots(self):
        """Block until every queued background snapshot write has landed
        (re-raises the first writer error); a no-op without the
        writer."""
        if self._snapshot_writer is not None:
            self._snapshot_writer.wait()

    def _put_snapshot_file(self, path: str, message):
        self._put_snapshot_write(
            path, lambda tmp, m=message: write_proto_binary(tmp, m))

    def _put_snapshot_write(self, path: str, write_fn):
        async_exec.write(path, write_fn, self._snapshot_writer)

    def _refuse_hdf5(self, what: str):
        if self.param.snapshot_format == proto.HDF5:
            require_h5py(what)

    def snapshot(self) -> str:
        """Write `<prefix>_iter_N.caffemodel`, `.solverstate` (or under
        HDF5 `.caffemodel.h5` and `.solverstate.h5`) and, with a fault
        engine, `.faultstate`; returns the model's name. The payloads
        are host messages and arrays built here."""
        self._refuse_hdf5(f"snapshot at iteration {self.iter}")
        os.makedirs(os.path.dirname(self.param.snapshot_prefix) or ".",
                    exist_ok=True)
        hdf5 = self.param.snapshot_format == proto.HDF5
        model_name = self.snapshot_filename(".caffemodel.h5" if hdf5
                                            else ".caffemodel")
        model = self.net.to_proto(self.params)
        it = self.iter
        cur = current_step_fn(self.param)(it)
        history = self._history_blob_list()
        if hdf5:
            self._put_snapshot_write(
                model_name, lambda tmp: write_net_hdf5(model, tmp))
            self._put_snapshot_write(
                self.snapshot_filename(".solverstate.h5"),
                lambda tmp: write_solver_state_hdf5(tmp, it, model_name, cur,
                                                    history))
        else:
            self._put_snapshot_file(model_name, model)
            state = proto.Message("SolverState")
            state.iter = it
            state.learned_net = model_name
            state.current_step = cur
            state.history = [array_to_blob(a) for a in history]
            self._put_snapshot_file(self.snapshot_filename(".solverstate"),
                                    state)
        fault = self.fault_state
        if fault is not None:
            # f32, as the reference's Solver holds it: packed banks as
            # their mid-bin view
            if self.pack_spec is not None:
                fault = fault_packed.unpack_state(fault, self.pack_spec)
            self._put_snapshot_file(self.snapshot_filename(".faultstate"),
                                    fault_engine.fault_state_to_proto(fault))
        print(f"Snapshotting to {model_name}", flush=True)
        return model_name

    def restore(self, state_file: str):
        """Resume from a `.solverstate` or `.solverstate.h5` (either
        package's): the iteration, the params from its `learned_net`,
        the history, and the fault state from the `.faultstate` beside
        it (`.h5`, then `.solverstate` stripped; re-packed with this
        solver's pack_spec under packed banks). Without that file the
        fault state stays this solver's fresh draw, with a warning on
        stderr."""
        self.wait_for_snapshots()
        if state_file.endswith(".h5"):
            it, learned_net, _, history = read_solver_state_hdf5(state_file)
        else:
            state = read_proto_binary(state_file, "SolverState")
            it, learned_net = state.iter, state.learned_net
            history = [blob_to_array(b) for b in state.history]
        self.iter = int(it)
        if learned_net:
            self.params = self.net.copy_trained_from(self.params,
                                                     learned_net)
        self._set_history_from_list(history)
        if self.fault_state is None:
            return
        fault_file = state_file
        if fault_file.endswith(".h5"):
            fault_file = fault_file[:-len(".h5")]
        if fault_file.endswith(".solverstate"):
            fault_file = fault_file[:-len(".solverstate")] + ".faultstate"
        if not os.path.exists(fault_file):
            # the construction-time draw stays: a stderr line always, a
            # `fault_redraw` record when sinks are attached
            from ..observe import sink as obs_sink
            rec = obs_sink.make_fault_redraw_record(
                self.iter, fault_file,
                "snapshot predates fault-state capture; fault state "
                "re-drawn from the failure_pattern (active fault "
                f"process: {self.fault_spec.canonical()})",
                tiles=(None if self.tile_spec.is_default
                       else self.tile_spec.canonical()))
            print("WARNING: " + obs_sink.fault_redraw_line(rec),
                  file=sys.stderr, flush=True)
            if self.metrics_logger is not None:
                self.metrics_logger.log(rec)
            return
        restored = fault_engine.fault_state_from_proto(
            read_proto_binary(fault_file, "NetParameter"), self.device)
        live = self.fault_state
        live_groups = set(live) - {"remap_slots"}
        if self.pack_spec is not None:
            live_groups = (live_groups - set(fault_packed.PACKED_GROUPS)) \
                | {"lifetimes", "stuck"}
        saved_groups = set(restored) - {"remap_slots"}
        if saved_groups != live_groups:
            raise ValueError(
                f"fault state in {fault_file} carries state groups "
                f"{sorted(saved_groups)} but this solver's fault process "
                f"{self.fault_spec.canonical()!r} expects "
                f"{sorted(live_groups)}; resume with the same "
                "fault_process the snapshot was taken under")
        saved = set(restored.get("lifetimes", {}))
        live_keys = (set(self._fault_keys) if "lifetimes" in live_groups
                     else set())
        if saved != live_keys:
            raise ValueError(
                f"fault state in {fault_file} covers params "
                f"{sorted(saved)} but this solver's fault targets are "
                f"{sorted(live_keys)}; resume with the same "
                "failure_pattern (including conv_also) the snapshot was "
                "taken under")
        if self.strategies.remap_tracked and "remap_slots" not in restored:
            # a snapshot without the tracked map restarts it at identity
            restored["remap_slots"] = {
                gid: torch.arange(len(v), dtype=torch.int32,
                                  device=self.device)
                for gid, v in live["remap_slots"].items()}
        if self.pack_spec is not None:
            restored = fault_packed.pack_state(restored, self.pack_spec,
                                               device=self.device)
        self.fault_state = restored
