"""SweepRunner: a Monte-Carlo sweep of C fault configs trained at once
(counterpart of the reference package's parallel/sweep.py SweepRunner).

    runner = SweepRunner(solver, n_configs=512, engine="cuda",
                         packed_state=True, dtype_policy="ternary",
                         pipeline_depth=2)
    losses, outputs = runner.step(iters, chunk=5)   # the last iteration's

Every config lane starts from the solver's params and SGD history and
draws its own fault state, its lifetimes re-anchored to the lane's
(mean, std), with the reference's keys: the C configs split from the
solver key folded with 0xFA117, and lane c's step key fold_in(fold_in(
solver key, it), c). One step is the solver's step body built with a config
axis (`Solver.make_train_step(lanes=C)`): the lanes share one batch per
iteration, kernel B2 reads every lane's InnerProduct weights in one
launch per layer, kernel B1 runs ApplyUpdate+Fail once per fault leaf,
and kernel B4 (RRAM_POOL_BWD=cuda) takes each MAX pooling backward over
all lanes' planes. BatchNorm's statistics are per lane ((C, ch),
scale_factor (C, 1)), advanced by the lane's own batch statistics and
carried by checkpoints like any other param. A lane whose loss goes
non-finite is quarantined:
its update, and every later one, is discarded while the other lanes
train on unchanged.

With `preload` and a Data layer that decodes deterministically, the
whole LMDB lives on the device and step t gathers records
(t*B + arange(B)) % N there, the host cursor's order; losses stay on
the device until a chunk of `chunk` iterations ends.

The solver's fault-process stack carries over: every lane draws its
state through it (process 0 on the config's key, process i on the key
folded with i), and the checkpoint pins its canonical spec (v5).

The solver's tile spec carries over: every lane draws each crossbar
tile on its own, and a tiled layer's read is one launch of kernel B2t
(InnerProduct, premat conv) or B3 (`conv_im2col="implicit"`) over all
lanes.

Durability: `checkpoint(path)` writes the whole resumable state (params,
history, fault banks, quarantine mask, iteration, solver key) as the
reference's v6 single-file `.npz`, `restore(path)` reads it back, or the
reference's v4 distributed directory, from either package, with the
reference's refusals; an f32 checkpoint restores into packed banks and
the reverse. `save_fault_states(path)` writes the fault state in the f32
layout. Both write through a temp file and an atomic rename, optionally
on a background thread (`wait_for_writes`, `close`). A continued run
equals the run that never stopped, bit for bit: the step's keys and
the device dataset's order depend on the iteration alone.

The solver's failure strategies run in every lane: threshold and
remapping (tracked or not) inside the laned step, each lane ranking and
permuting by its own fault state on the iterations the solver's
`_remap_due_at` names (one clock for all lanes; tracked remapping's
`remap_slots` start as the identity in every lane and are a fault-state
group, so checkpoints carry them); the genetic search on the host
between steps, one copy of the solver's `GeneticStrategy` a lane, each
seeded alike, before the iterations `_genetic_due_at` names (a chunk
ends there), and never in a quarantined lane. `iter_size` > 1 feeds stacked host
sub-batches (no device-resident dataset).

The pipeline (`pipeline_depth`, the reference's async dispatch): None
reads the results back only when `step()` returns; 0 does each chunk's
bookkeeping inline (the host waits for the chunk's copies, then writes
one record to the solver's metric sinks); >= 1 hands each chunk to an
`OrderedConsumer` thread of that queue depth. After every chunk the
dispatcher starts non-blocking copies of its losses, outputs and
metrics into pinned host buffers and records an event; the consumer
waits on the event (the GIL released) and reads the buffers, while the
dispatcher goes on enqueueing the next chunk's kernels. Every depth runs
the same kernels in the same order: results and records are equal bit
for bit. `stall_timeout_s` turns a consumer that stops making progress
into a `StallError` carrying an emergency checkpoint's path
(`<snapshot_prefix>_sweep_stall_iter_N.ckpt.npz`).

Telemetry: with `Solver.enable_metrics` before the runner is built, the
step carries per-lane counters and each chunk writes one record (depth
0 or more); `enable_tracing` records host spans (dispatch, submit_wait,
consume, drain, checkpoint, restore, save_faults) that drain into the
sinks at each step() return and export as a Chrome trace
(`write_trace`); `health_every` runs the wear census over the resident
banks every that many iterations (`health_summary`); `setup_record`
is the observe `setup` record (dataset decode, kernel build, pipeline
accounting, bytes per step).

`config_block` = B runs each iteration's lanes in C / B blocks: one
step built for B lanes, called on the lane slices of the resident
params, history, fault banks and quarantine mask with the slice of the
(C, 2) step keys (derived once for all C), on the one shared batch.
Each block's result is written back into its rows of the resident
tensors in place, so the peak is the resident state plus one block's
new state and activations; losses, outputs and every metrics leaf are
joined along the lane axis. Every lane's result is the unblocked run's,
bit for bit; the kernels launch once per block (B2b twice, B1b and B4
once a block on the untiled path). Without blocks the step's outputs
replace the resident tensors. `evaluate(batch)` is a per-config forward
of a test net over all C lanes at once.

Debug: with the solver's `debug_info` or watchdog (observe/debug.py)
the step carries every lane's trace and sentinels; a lane whose
sentinels trip is quarantined like a non-finite one, `sentinel_state()`
names each lane's first bad phase and layer, and an armed watchdog
checkpoints the sweep ("snapshot") or stops it until restore() ("halt")
at the next chunk boundary after a new quarantine.

Self-healing (`enable_self_healing`, the reference's layer) turns the
lanes into slots of a work queue. Each config has an iteration budget;
at every chunk boundary the dispatcher harvests configs that reached it (the
result into `config_report()`, `on_lane_complete(cfg, lane, result)`
called while the lane still holds the config's rows, the lane frozen
by its quarantine bit), reclaims the lanes of quarantined configs once
the bookkeeping has announced them (behind a consumer drain: the
attempt is voided and the config queued again after `backoff_iters *
attempt` iterations, or, with its `max_retries` spent, failed with the
first bad iteration, phase and layer), and re-seeds free lanes from the
queue in (config, attempt) order or the order of `set_refill_policy`.
A refill writes the lane's rows of the resident tensors in place (host
to device, behind a drain), so every other lane keeps its storage byte
for byte: a first retry from the config's slice of the last checkpoint
(`use_checkpoint`), otherwise fresh params and history and a fault draw
under fold_in(fold_in(fold_in(solver key, 0xFA117), config), attempt).
`submit_configs` queues more configs (refused under packed banks when
their spec would overflow the int16 counters); the sweep is done when
`healing_complete()`. Every event is a `retry` record and line, and a
`heal` span with `requeue`/`reseed`/`failed` instants on the trace.
Checkpoints carry the lane map, per-lane progress and the queue
(`healing`), and both packages restore each other's.

In shared time every lane follows the one iteration clock. With
`enable_self_healing(virtual_time=True)` (the sweep-as-a-service mode)
each lane runs its own clock, its occupant's progress `lane_done`: a
chunk's iteration j steps lane c at t = lane_done[c] + j, on records
(t*B + arange(B)) % N of the device dataset gathered per lane (each lane
its own batch, a laned data top), with the step key fold_in(fold_in(
solver key, t), config id), the LR schedule's float32 rate at t (a (C,)
rate through ComputeUpdate, the update rules and the threshold's
cutoff), Adam's correction at t + 1 and the remap cadence at t (every
lane remapped when any is due, kept in the due lanes). The offsets,
rates, corrections and flags of a chunk reach the card in one pinned,
non-blocking copy; the keys and their noise are derived on the host in
one vectorised pass. A config's result then depends only on its spec,
id, attempt, budget and the solver seed, whichever lane and wave it
lands in: the reproducibility contract of the reference's service. Idle
and frozen lanes step too, masked, their clocks inert. The mode needs
the device dataset and no `config_block`, and rides the checkpoint
(`virtual_time`); a runner in the other mode refuses the file.

The genetic search's state (`__genetics__`) is the reference's pickle of
one GeneticStrategy a lane; fault/genetic_state.py writes it under the
reference's class name and reads it back allowing numpy's names alone.

`precompile_chunk` = k > 0 overlaps the two halves of a cold start: once
the DB is found to open and hold records, the decode runs on a
`dataset-decode` thread, and meanwhile the constructor's thread builds
or loads every kernel library the resolved step launches (nvcc, the
library load and its kernels' module load: the port's counterpart of the
reference's ahead-of-time compile of the k-iteration chunk, which needs
no shapes here). It touches no lane's state: a runner built with it
equals one built without it, bit for bit.

`GroupPrefetcher` builds the next resident group's runner on a thread
while the current group runs (the multi-group driver,
examples/gaussian_failure/run_1000_sweep.py); on the card the build
issues its device work on a stream of its own.

Not ported yet, each refused by name: mesh, remat_segments,
compute_dtype, the multi-process forms (the stall and watchdog
agreement, the owned config block) and distributed checkpoints
(writing).
"""
from __future__ import annotations

import copy
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import async_exec, kernels, proto
from ..cache import SetupStats
from ..core import prng
from ..data.db import open_db
from ..data.feed import (batch_to, build_feed, can_materialize,
                         materialize_data_source)
from ..device import resolve_device
from ..fault import engine as fault_engine
from ..fault import fused as fault_fused
from ..fault import genetic_state
from ..fault import hw_aware
from ..fault import packed as fault_packed
from ..fault.processes import DEFAULT_PROCESS
from ..observe import counters as obs_counters
from ..ops import pool_backward
from ..solver import solver as solver_mod
from ..solver.solver import stack_batches

SWEEP_ENGINES = ("auto", "cuda", "torch")
CHECKPOINT_VERSION = 6  # the reference's; v1-v5 restore as it upgrades them
LEGACY_TILES = "1x1"    # the mapping of a checkpoint older than v6
SWEEP_FOLD = 0xFA117    # the reference's fold of the solver key for the draw
# constructor options of the reference runner this slice does not port,
# with the value that means "off"
UNPORTED_OPTIONS = {"mesh": None, "remat_segments": 0,
                    "compute_dtype": None}


def _not_ported(what: str):
    raise NotImplementedError(f"SweepRunner: {what} is not ported to the "
                              "PyTorch/CUDA package yet")


def _lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _join_lanes(parts: list):
    """Per-block trees of lane-first tensors joined along the lane
    axis (the step's metrics: every leaf carries the lanes first)."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join_lanes([p[k] for p in parts]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    return first


def _lane_of(tree, i: int):
    """Lane i of a host tree (nested dicts of per-lane lists)."""
    if isinstance(tree, dict):
        return {k: _lane_of(v, i) for k, v in tree.items()}
    return tree[i]


def _masked_new(mask: torch.Tensor, old: torch.Tensor, new: torch.Tensor):
    """where(lane masked, old, new), written into `new` (the step's own
    output): no second copy."""
    return torch.where(_lane_mask(mask, new), old, new, out=new)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that no later step can change: the device fetch of
    a card tensor, a copy of a CPU one."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _savez_writer(arrays: Dict[str, np.ndarray]):
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    return write


class _HealingState:
    """The self-healing layer's host bookkeeping (the reference's
    _HealingState, plain numpy and Python): the lane -> config map, the
    pending-config queue with at-least-once completion, per-config
    attempts and budgets, and the completed and failed ledgers. It rides
    the checkpoint as JSON."""

    def __init__(self, n: int, budget: int, max_retries: int,
                 backoff_iters: int, use_checkpoint: bool,
                 start_iter: int):
        self.budget = int(budget)
        self.max_retries = int(max_retries)
        self.backoff_iters = int(backoff_iters)
        self.use_checkpoint = bool(use_checkpoint)
        # config id occupying each lane; -1 = free
        self.lane_cfg = np.arange(n, dtype=np.int64)
        # iterations the lane's current occupant has completed
        self.lane_done = np.full(n, int(start_iter), dtype=np.int64)
        # 1-based attempt of the lane's current occupant
        self.lane_attempt = np.ones(n, dtype=np.int64)
        # pending work: [{"config", "attempt", "eligible_iter"}]
        self.pending: List[dict] = []
        # per-config budget overrides (live submissions)
        self.cfg_budget: Dict[int, int] = {}
        self.results: Dict[int, dict] = {}
        self.failures: Dict[int, dict] = {}
        # lanes the host froze (completed or idle): not a divergence,
        # left out of quarantine announcements and record fields
        self.benign: set = set()
        # id allocator for configs queued beyond the resident n
        self.next_config = n

    def requested(self) -> List[int]:
        """Every config id this sweep has been asked to complete."""
        ids = set(self.results) | set(self.failures)
        ids.update(int(c) for c in self.lane_cfg if c >= 0)
        ids.update(int(e["config"]) for e in self.pending)
        return sorted(ids)

    def complete(self) -> bool:
        return not self.pending and bool(np.all(self.lane_cfg < 0))

    def to_json(self) -> dict:
        return {
            "budget": self.budget, "max_retries": self.max_retries,
            "backoff_iters": self.backoff_iters,
            "use_checkpoint": self.use_checkpoint,
            "lane_cfg": [int(x) for x in self.lane_cfg],
            "lane_done": [int(x) for x in self.lane_done],
            "lane_attempt": [int(x) for x in self.lane_attempt],
            "pending": list(self.pending),
            "cfg_budget": {str(k): int(v)
                           for k, v in self.cfg_budget.items()},
            "results": {str(k): v for k, v in self.results.items()},
            "failures": {str(k): v for k, v in self.failures.items()},
            "benign": sorted(int(x) for x in self.benign),
            "next_config": int(self.next_config),
        }

    @classmethod
    def from_json(cls, d: dict) -> "_HealingState":
        h = cls(len(d["lane_cfg"]), d["budget"], d["max_retries"],
                d["backoff_iters"], d["use_checkpoint"], 0)
        h.lane_cfg = np.asarray(d["lane_cfg"], np.int64)
        h.lane_done = np.asarray(d["lane_done"], np.int64)
        h.lane_attempt = np.asarray(d["lane_attempt"], np.int64)
        h.pending = list(d["pending"])
        h.cfg_budget = {int(k): int(v)
                        for k, v in d.get("cfg_budget", {}).items()}
        h.results = {int(k): v for k, v in d["results"].items()}
        h.failures = {int(k): v for k, v in d["failures"].items()}
        h.benign = set(d["benign"])
        h.next_config = int(d["next_config"])
        return h


class SweepRunner:
    """C fault configs of one solver, trained together on `device` (the
    card by default; raises without one unless device="cpu", which
    must be the solver's device too).

    `engine`: "cuda" runs kernels B2/B1 (their wrappers take the plain
    versions on CPU tensors), "torch" the plain versions by name, "auto"
    is "cuda" on a CUDA device. `packed_state`, `dtype_policy`,
    `fused_epilogue` and `conv_im2col` are the solver's step options;
    `conv_im2col_requested/_resolved/_reason` record the conv operand
    mode that runs. `feed` is the host feed of every step; without one
    the runner feeds from the solver's `train_feed` where the solver was
    given or assigned one, else from a raw feed of its own over the
    solver's data layers, which starts at their first record (or from
    the device-resident dataset, below). `pipeline_depth`, `stall_timeout_s`,
    `health_every`, `config_block` and `precompile_chunk` as in the
    module docstring; `engine_fallback_reason` says why the requested
    engine launches no crossbar kernel (None when it does). A context
    manager: leaving it calls `close()`."""

    def __init__(self, solver, n_configs: int, means=None, stds=None,
                 preload: bool = True, engine: str = "auto",
                 packed_state: bool = False, dtype_policy=None,
                 fused_epilogue=None, device=None, conv_im2col=None,
                 pipeline_depth: Optional[int] = None,
                 stall_timeout_s: Optional[float] = None,
                 health_every: int = 0, config_block: int = 0,
                 precompile_chunk: int = 0, feed=None, **options):
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"SweepRunner got an unexpected option "
                                f"{name!r}")
            if value != UNPORTED_OPTIONS[name]:
                _not_ported(f"{name}={value!r}")
        if engine not in SWEEP_ENGINES:
            raise ValueError(f"unknown sweep engine {engine!r} (expected "
                             f"one of {SWEEP_ENGINES})")
        if n_configs < 1:
            raise ValueError(f"n_configs must be >= 1, got {n_configs}")
        # the feed the solver holds now: `_batch` refuses a later swap,
        # which this runner would not see
        self._solver_feed = solver.train_feed
        if feed is None and solver.custom_train_feed:
            feed = solver.train_feed
        self._given_feed = feed
        self.config_block = int(config_block or 0)
        block = int(n_configs)
        if 0 < self.config_block < n_configs:
            if n_configs % self.config_block:
                raise ValueError(
                    f"n_configs {n_configs} not divisible by "
                    f"config_block {self.config_block}")
            block = self.config_block
        # the lane slices each iteration runs one after another
        self._blocks = [slice(g, g + block)
                        for g in range(0, int(n_configs), block)]
        if solver.fault_state is None:
            raise ValueError("SweepRunner needs a solver with a "
                             "failure_pattern")
        self.device = resolve_device(device)
        if solver.device != self.device:
            raise ValueError(f"SweepRunner on {self.device} needs a solver "
                             f"on the same device (it is on "
                             f"{solver.device})")
        self.solver = solver
        self.n = int(n_configs)
        self.iter = 0
        self._means = None if means is None else np.asarray(means,
                                                            np.float64)
        self._stds = None if stds is None else np.asarray(stds, np.float64)
        # the self-healing layer (enable_self_healing); None = off
        self._healing: Optional[_HealingState] = None
        # the service's seams: the refill order, a callback fired with a
        # completed config's rows still in its lane
        self._refill_policy = None
        self.on_lane_complete = None
        self._virtual_time = False
        # (mean, std) of configs queued beyond the resident lanes
        self._cfg_specs: Dict[int, dict] = {}
        # the last checkpoint written or restored: a retry's recovery
        self._last_ckpt_path: Optional[str] = None
        # set by the bookkeeping when it announces a quarantine: the
        # dispatcher reclaims lanes at its next chunk boundary
        self._reclaim_flag = threading.Event()
        # lane -> {"iter", "where"} of an announced quarantine (read by
        # the dispatcher after a consumer drain)
        self._quar_diag: Dict[int, dict] = {}
        self.last_losses: Optional[np.ndarray] = None
        self.chunk_losses: Optional[np.ndarray] = None   # (k, C)
        # cold-start accounting (the observe `setup` record); made
        # before the dataset decode and the first kernel build
        self.setup = SetupStats()
        self.pipeline = async_exec.PipelineStats(depth=pipeline_depth or 0)
        self.setup.pipeline = self.pipeline
        self._pipeline_on = pipeline_depth is not None
        if pipeline_depth is not None and pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be None or >= 0, got "
                             f"{pipeline_depth!r}")
        self._consumer = (
            async_exec.OrderedConsumer(self._consume_chunk,
                                       depth=pipeline_depth,
                                       stall_timeout=stall_timeout_s)
            if pipeline_depth else None)
        self._last_host = None      # (losses, outputs) of the last chunk
        self._pending = None        # depth None: the last chunk's tensors
        self._record_t0 = None      # perf_counter at the last record
        self._inline_write_s = 0.0
        self._quar_seen: set = set()
        self._stop = False          # a stall or the watchdog stopped it
        # the watchdog event the bookkeeping notes for the dispatcher
        # (the consumer thread writes it, the dispatcher clears it)
        self._watchdog_event = None
        self._watchdog_lock = threading.Lock()
        self._eval_fns: dict = {}
        self._closed = False
        self.last_metrics: dict = {}
        # span tracing (enable_tracing): None = off, every site guarded
        self._tracer = None
        self._trace_dir = None
        # the wear census every `health_every` iterations
        self._health_every = int(health_every or 0)
        if self._health_every < 0:
            raise ValueError(f"health_every must be >= 0, got "
                             f"{health_every!r}")
        self._health_census = None
        self._health_ledger = None
        self._last_health_tick = None
        if self._health_every:
            from ..observe import health as obs_health
            self._health_ledger = obs_health.HealthLedger()
        requested = engine
        if engine == "auto":
            engine = "cuda" if self.device.type == "cuda" else "torch"
        self.engine = engine

        pattern = solver.param.failure_pattern
        flat = solver._flat(solver.params)
        shapes = {k: tuple(flat[k].shape) for k in solver._fault_keys}
        # the reference's sweep draw: the solver key folded with 0xFA117,
        # split over the C configs
        # through the solver's fault-process stack, whose tile spec each
        # draw follows
        stack = solver.fault_process
        state = fault_engine.stack_fault_states(
            prng.fold_in(solver._key, SWEEP_FOLD), shapes, pattern, self.n,
            means=means, stds=stds, process=stack, tiles=solver.tile_spec,
            device=self.device)
        if "remap_slots" in solver.fault_state:
            # tracked remapping: every lane starts at the solver's map
            state["remap_slots"] = {
                g: v.unsqueeze(0).repeat(self.n, 1)
                for g, v in solver.fault_state["remap_slots"].items()}
        self._pack_spec = None
        if packed_state:
            if not stack.supports_packed:
                raise ValueError(
                    "packed_state=True is not supported by fault "
                    f"process(es) {stack.unpackable()} of the configured "
                    f"stack {stack.canonical()!r} (no lifetime counters "
                    "to bank); build with packed_state=False")
            # counter dtype sized from every configured (mean, std); the
            # quantum is the stack's (read_disturb: its reads a step)
            self._pack_spec = fault_packed.make_pack_spec(
                state, stack.write_quantum(solver.fail_decrement),
                means=[float(pattern.mean)] if means is None else means,
                stds=[float(pattern.std)] if stds is None else stds)
            state = fault_packed.pack_state(state, self._pack_spec,
                                            device=self.device)
        self.fault_states = state

        def bcast(t):
            return t.unsqueeze(0).repeat((self.n,) + (1,) * t.dim())
        self.params = {ln: [None if t is None else bcast(t) for t in vals]
                       for ln, vals in solver.params.items()}
        self.history = {k: {s: bcast(v) for s, v in slots.items()}
                        for k, slots in solver.history.items()}
        self.quarantine = torch.zeros(self.n, dtype=torch.bool,
                                      device=self.device)
        self._bg_writer: Optional[async_exec.BackgroundWriter] = None
        # the genetic search: one copy of the solver's strategy a lane,
        # each with its own generator, seeded alike
        self._genetics = None
        if solver.strategies.genetic is not None:
            self._genetics = []
            for _ in range(self.n):
                g = copy.deepcopy(solver.strategies.genetic)
                g._rng = np.random.RandomState(g.seed)
                self._genetics.append(g)

        # the metrics choice is fixed from here on (enable_metrics raises)
        solver._step_baked = True
        self._step = solver.make_train_step(
            hw_engine=engine, dtype_policy=dtype_policy,
            fault_format="packed" if packed_state else "f32",
            pack_spec=self._pack_spec, fused_epilogue=fused_epilogue,
            lanes=block, conv_im2col=conv_im2col,
            with_metrics=solver._metrics_enabled)
        self._noise = self._step.noise
        if solver._watchdog is not None:
            # the Solver's "snapshot" policy captures the sweep's state
            solver._sweep_checkpoint = self._watchdog_checkpoint
        self._out_axis = self._output_axes(laned_data=False)
        self.engine_resolved = self._step.hw_engine_resolved
        self.engine_fallback_reason = None
        if engine == "cuda" and self.engine_resolved is None:
            self.engine_fallback_reason = (
                "no crossbar read to arm (rram_forward.sigma == 0 and no "
                "ADC-grid dtype_policy): kernel B2 has no weight to read")
        elif requested == "auto" and self.engine_resolved == "torch":
            self.engine_fallback_reason = (
                "auto engine runs the plain versions: the runner is on "
                f"{self.device}")
        if requested == "cuda" and self.engine_fallback_reason:
            print(f"SweepRunner: engine 'cuda' requested, "
                  f"{self.engine_fallback_reason}", file=sys.stderr,
                  flush=True)
        self.setup.engine_fallback_reason = self.engine_fallback_reason
        self.conv_im2col_requested = self._step.conv_im2col_requested
        self.conv_im2col_resolved = self._step.conv_im2col_resolved
        self.conv_im2col_reason = self._step.conv_im2col_reason
        self.fused_epilogue_resolved = self._step.fused_epilogue_resolved
        self.fused_epilogue_reason = self._step.fused_epilogue_reason

        self._dataset = None
        self._ds_batch = self._ds_n = 0
        if preload:
            self._preload(int(precompile_chunk or 0))
        # one feed for every host path; the default is raw and this
        # runner's own, as the reference's (parallel/sweep.py:668-680)
        if self._given_feed is not None:
            self._feed = self._given_feed
        elif self._dataset is None:
            self._feed = build_feed(solver.net, prefetch=False)
        else:
            self._feed = None

    def _output_axes(self, laned_data: bool) -> dict:
        """Each output's lane axis (a laned blob's axis 1, a per-config
        scalar's axis 0; None: the same for every lane)."""
        net = self.solver.net
        laned = net.laned_blobs(laned_data)
        return {n: (None if n not in laned
                    else 0 if net.blob_shapes[n] == () else 1)
                for n in net.output_names}

    # ------------------------------------------------------------------
    def _materializable_layer(self):
        """The single Data layer whose DB can live on the device, or
        None (a custom feed, another layer mix, random transforms)."""
        if self._given_feed is not None or self.solver.param.iter_size > 1:
            return None
        src = [ly for ly in self.solver.net.layers if ly.is_data_source]
        if len(src) != 1 or not can_materialize(src[0]):
            return None
        return src[0]

    def _preload(self, precompile_chunk: int = 0):
        """The device-resident dataset, when the Data layer decodes
        deterministically (module docstring). With `precompile_chunk` > 0
        and a DB that opens and holds records (`_probe_dataset`), the
        decode runs on a `dataset-decode` thread while this thread builds
        or loads the step's kernel libraries (`_step_libraries`). A decode error
        re-raises here. The upload runs on this thread, on its current
        stream."""
        layer = self._materializable_layer()
        if layer is None:
            return
        result: dict = {}

        def decode():
            try:
                with self.setup.timed_decode():
                    result["arrays"] = materialize_data_source(layer)
            except BaseException as e:
                result["error"] = e

        if precompile_chunk > 0 and self._probe_dataset(layer):
            t = threading.Thread(target=decode, name="dataset-decode")
            t.start()
            try:
                kernels.build_all(self._step_libraries())
            finally:
                t.join()
        else:
            decode()
        if "error" in result:
            raise result["error"]
        arrays = result.get("arrays")
        if arrays is None:
            return
        with self.setup.timed_decode():
            self._dataset = {k: torch.from_numpy(v).to(self.device)
                             for k, v in arrays.items()}
        self._ds_batch = int(layer.lp.data_param.batch_size)
        self._ds_n = next(iter(arrays.values())).shape[0]
        self._arange = torch.arange(self._ds_batch, device=self.device)

    @staticmethod
    def _probe_dataset(layer) -> bool:
        """Whether the precompile may run beside the decode: the DB
        opens and holds records (the reference's probe declines on no DB
        or an empty one; the decode then raises or finds nothing on this
        thread, as without the precompile)."""
        try:
            env = open_db(layer.lp.data_param.source)
        except Exception:
            return False
        try:
            return len(env) > 0
        finally:
            env.close()

    def _step_libraries(self) -> list:
        """The kernel libraries the resolved step launches: B2's source
        when the crossbar read runs on engine "cuda", B1's when the fused
        epilogue does too, B4's under RRAM_POOL_BWD=cuda with a MAX pool;
        none off the card."""
        if self.device.type != "cuda" or self.engine != "cuda":
            return []
        libs = []
        if self.engine_resolved == "cuda":
            libs.append(hw_aware.CROSSBAR_LIB)
        if self.fused_epilogue_resolved:
            libs.append(fault_fused.FUSED_LIB)
        if pool_backward.pool_bwd_engine() == "cuda" and any(
                getattr(ly, "method", None) == proto.POOL_MAX
                for ly in self.solver.net.layers):
            libs.append(pool_backward.POOL_BWD_LIB)
        return libs

    def _record_stream(self, stream):
        """Mark every resident card tensor as used on `stream`: a runner
        built on another stream (`GroupPrefetcher`) then frees none of
        them back to that stream's pool while `stream` may still read
        it."""
        tensors = list(self._state_arrays().values())
        tensors += list((self._dataset or {}).values())
        tensors.append(getattr(self, "_arange", None))
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)

    def _batch(self, it: int) -> dict:
        if self.solver.train_feed is not self._solver_feed:
            raise RuntimeError(
                "the solver's train_feed was replaced after this "
                "SweepRunner was built, which would not feed from it; pass "
                "the feed as SweepRunner(feed=...) or build the runner "
                "after the swap")
        if self._dataset is None:
            return stack_batches(self._feed, self.solver.param.iter_size,
                                 self.device)
        # the host cursor's wrap-around order; the offset is exact host
        # integer arithmetic
        start = (it * self._ds_batch) % self._ds_n
        idx = (self._arange + start) % self._ds_n
        return {k: a.index_select(0, idx) for k, a in self._dataset.items()}

    def _lane_batch(self, starts: torch.Tensor) -> dict:
        """Each lane's own batch under virtual time: lane c reads records
        (starts[c] + arange(B)) % N of the device dataset (`starts` (C,)
        on the device, exact host integers), gathered straight into the
        laned layout, (B, C*ch, ...) and labels (B, C)."""
        B = self._ds_batch
        idx = (starts.long()[None, :] + self._arange[:, None]) % self._ds_n
        out = {}
        for k, a in self._dataset.items():
            rows = a.index_select(0, idx.reshape(-1))
            rest = tuple(a.shape[1:])
            out[k] = rows.view((B, self.n * rest[0]) + rest[1:] if rest
                               else (B, self.n))
        return out

    def _lane_clocks(self, k: int):
        """The next k iterations' per-lane clocks under virtual time
        (the reference's dispatch): lane c's clock runs from its own
        progress, t[j, c] = lane_done[c] + j; the step keys fold in the
        lane's config id; the batch offsets (t * B) % N are exact host
        integers. The offsets, rates, Adam corrections and remap flags of
        the whole chunk reach the card in one pinned, non-blocking copy.
        Returns (t (k, C), keys (k, C, 2), remap flags (k, C), device
        rows (k, 1 + R, C) float64: the offsets, then the step's
        `lane_clock_rows`)."""
        h = self._healing
        t = h.lane_done.astype(np.int64)[None, :] + np.arange(
            k, dtype=np.int64)[:, None]
        remaps = self.solver._remap_due_grid(t)
        keys = self._noise.lane_step_keys(
            self.solver._key, t, np.maximum(h.lane_cfg, 0))
        starts = (t * self._ds_batch) % self._ds_n
        rows = np.concatenate([starts[:, None, :].astype(np.float64),
                               self._step.lane_clock_rows(t, remaps)], 1)
        return t, keys, remaps, solver_mod._to_device(rows, self.device)

    def step(self, iters: int = 1, chunk: int = 1):
        """Run `iters` sweep iterations, `chunk` of them a chunk (the
        unit the pipeline hands to its bookkeeping: one record, one
        read-back of the lanes' losses into `chunk_losses`). Returns the
        last iteration's (losses (C,), {output: (C, ...)}) as host
        arrays. A consumer failure is sticky and re-raises here; a
        consumer stall raises `StallError` with an emergency checkpoint
        (its `checkpoint_path`), and the sweep stops."""
        try:
            return self._step_impl(iters, chunk)
        except async_exec.StallError as e:
            raise self._on_stall(e) from None

    def _step_impl(self, iters: int, chunk: int):
        if self._stop:
            # a stall stopped the sweep until restore()
            return self._last_host if self._last_host is not None \
                else (None, None)
        if self._consumer is not None:
            self._consumer.check()
        # the entry pass: events noted in the last call's final drain or
        # restored from a checkpoint, before anything is dispatched
        if self._heal_pass():
            return self._last_host if self._last_host is not None \
                else (None, None)
        tr = self._tracer
        done = 0
        while done < iters:
            self._maybe_genetic()
            k = self._budget_chunk_cap(self._genetic_chunk_cap(
                min(max(chunk, 1), iters - done)))
            t0 = time.perf_counter() if tr is not None else 0.0
            clocks = self._lane_clocks(k) if self._virtual_time else None
            losses, outputs, mets = [], {}, {}
            for i in range(k):
                # a chunk's record reads its last iteration's tree
                loss, outputs, mets = self._iteration(
                    record=i == k - 1,
                    clock=None if clocks is None else
                    tuple(c[i] for c in clocks))
                losses.append(loss)
                self.iter += 1
            if tr is not None:
                # enqueueing the chunk's kernels (their device time is in
                # a profiler trace, observe/trace.py)
                tr.complete("dispatch", time.perf_counter() - t0,
                            iteration=self.iter, args={"k": k})
            self.last_metrics = mets
            self._after_dispatch(k, self.iter - 1, losses, outputs, mets)
            done += k
            self._maybe_health_boundary()
            if self._service_watchdog():
                break
            if self._heal_pass(k, losses):
                break
        return self._finish_step()

    def _iteration(self, record: bool, clock=None):
        """One sweep iteration, block after block over the lanes: the
        step on each lane slice of the resident state (one batch, the
        slice of the (C, 2) keys), its result committed into those rows.
        Under virtual time `clock` is this iteration's row of
        `_lane_clocks` (no blocks): each lane steps at its own clock, on
        its own batch. Returns (losses (C,), outputs, metrics) joined
        over the blocks."""
        if clock is not None:
            t, keys, remap, dev = clock
            out = self._step(self.params, self.history, self.fault_states,
                             self._lane_batch(dev[0]), t, keys,
                             do_remap=remap, record=record,
                             clocks=dev[1:].float())
            mets = out[5] if len(out) > 5 else {}
            self._commit(*out[:4], mets)
            return out[3], out[4], mets
        it = self.iter
        batch, keys = self._batch(it), self.lane_keys(it)
        if len(self._blocks) == 1:
            out = self._step(self.params, self.history, self.fault_states,
                             batch, it, keys, record=record)
            mets = out[5] if len(out) > 5 else {}
            self._commit(*out[:4], mets)
            return out[3], out[4], mets
        parts, bads = [], []
        with hw_aware.planned_lanes(self.n):
            for sl in self._blocks:
                state = obs_counters.tree_map(
                    lambda t, sl=sl: t[sl],
                    (self.params, self.history, self.fault_states))
                out = self._step(*state, batch, it, keys[sl],
                                 record=record)
                mets = out[5] if len(out) > 5 else {}
                bad = self._bad_lanes(self.quarantine[sl], out[3], mets)
                for old, new in zip(state, out[:3]):
                    self._write_back(old, new, bad)
                bads.append(bad)
                parts.append((out[3], out[4], mets))
        self.quarantine = torch.cat(bads)
        outputs = {}
        for name, axis in self._out_axis.items():
            vals = [p[1][name] for p in parts]
            outputs[name] = vals[0] if axis is None else torch.cat(vals, axis)
        return (torch.cat([p[0] for p in parts]), outputs,
                _join_lanes([p[2] for p in parts]))

    @staticmethod
    def _bad_lanes(quar, loss, mets) -> torch.Tensor:
        """The quarantine after a step (the reference's
        _make_quarantine_step): lanes quarantined before, lanes whose
        loss is non-finite and, with the debug trace on, lanes whose
        sentinels tripped in any phase."""
        bad = quar | ~torch.isfinite(loss)
        if "debug" in mets:
            bad = bad | (mets["debug"]["sentinel"]["first"] >= 0).any(-1)
        return bad

    @staticmethod
    def _write_back(old_tree, new_tree, bad):
        """A block's committed state into its rows of the resident
        tensors (`old_tree` holds the lane-slice views the step read):
        masked lanes keep their rows."""
        if isinstance(old_tree, dict):
            for k in old_tree:
                SweepRunner._write_back(old_tree[k], new_tree[k], bad)
            return
        if isinstance(old_tree, (list, tuple)):
            for o, n in zip(old_tree, new_tree):
                SweepRunner._write_back(o, n, bad)
            return
        if new_tree is None or new_tree is old_tree:
            return
        old_tree.copy_(_masked_new(bad, old_tree, new_tree))

    def _after_dispatch(self, k, last_it, losses, outputs, mets):
        """Hand one chunk's results to the bookkeeping: at depth None
        keep them for step()'s return; otherwise start their host copies
        (HostCopy: pinned buffers, an event) and submit them to the
        consumer (depth >= 1, `host_blocked` counts the submit's
        backpressure) or consume them inline (depth 0, `host_blocked`
        counts the whole wait and the sinks)."""
        self.pipeline.chunks += 1
        h = self._healing
        lane_map = [int(c) for c in h.lane_cfg] if h is not None else None
        benign = frozenset(h.benign) if h is not None else frozenset()
        if not self._pipeline_on:
            self._pending = (losses, outputs)
            if self.solver._watchdog is not None:
                # no bookkeeping at depth None: an armed watchdog reads
                # the (C,) mask and the sentinels each chunk
                host = obs_counters.HostCopy({
                    "quarantine": self.quarantine,
                    "debug": mets["debug"]}).wait()
                self._note_quarantine(host["quarantine"], last_it,
                                      host["debug"], lane_map, benign)
            return
        item = (k, last_it, obs_counters.HostCopy({
            "losses": torch.stack(losses), "outputs": outputs,
            "metrics": mets, "quarantine": self.quarantine}),
            lane_map, benign)
        tr = self._tracer
        if self._consumer is not None:
            blocked = self._consumer.submit(item)
            self.pipeline.host_blocked_s += blocked
            if tr is not None:
                tr.complete("submit_wait", blocked, iteration=last_it,
                            args={"k": k})
        else:
            t0 = time.perf_counter()
            self._consume_chunk(item)
            dt = time.perf_counter() - t0
            self.pipeline.host_blocked_s += dt
            if tr is not None:
                tr.complete("consume", dt, cat="host", iteration=last_it,
                            args={"k": k})

    def _set_last_host(self, losses: torch.Tensor, outputs: dict):
        """The host view of a chunk: (k, C) losses, the last iteration's
        outputs."""
        self.chunk_losses = losses.numpy()
        self.last_losses = self.chunk_losses[-1]
        self._last_host = (self.last_losses,
                           {n: v.numpy() for n, v in outputs.items()})

    def _consume_chunk(self, item):
        """One chunk's bookkeeping, in chunk order (inline at depth 0,
        on the consumer thread at depth >= 1): wait for its host copies,
        refresh the last-result view, note new quarantines and write
        one record to the solver's metric sinks."""
        k, last_it, copy_, lane_map, benign = item
        host = copy_.wait()
        self._set_last_host(host["losses"], host["outputs"])
        qids = self._note_quarantine(host["quarantine"], last_it,
                                     host["metrics"].get("debug"),
                                     lane_map, benign)
        logger = (self.solver.metrics_logger
                  if self.solver._metrics_enabled else None)
        # deep traces are not record fields
        mets = {k: v for k, v in host["metrics"].items() if k != "debug"}
        if logger is None or not mets:
            return
        from ..observe import sink as obs_sink
        mets = obs_counters.host_values(mets)
        outs = {}
        for name, v in self._last_host[1].items():
            arr = np.ravel(v)
            outs[name] = float(arr[0]) if arr.size == 1 else arr.tolist()
        now = time.perf_counter()
        elapsed = (now - self._record_t0
                   if self._record_t0 is not None else None)
        self._record_t0 = now
        rec = obs_sink.make_record(iteration=last_it, metrics=mets,
                                   outputs=outs, elapsed_s=elapsed,
                                   n_iters=k, quarantine=qids or None,
                                   lane_map=lane_map)
        self.pipeline.records += 1
        logger.log(rec)

    def _note_quarantine(self, quar: torch.Tensor, iteration: int,
                         debug: Optional[dict] = None, lane_map=None,
                         benign=frozenset()) -> list:
        """Announce lanes newly quarantined (once each), with the first
        bad phase and layer from the chunk's sentinels when the trace is
        on (`debug`, the step's debug tree), note the triage entry and
        wake the reclamation (self-healing), note a watchdog event for
        the dispatcher, and return the ids of every quarantined lane.
        Lanes the host froze (`benign`: completed or idle) did not
        diverge and are left out. `quar` and `debug` are host tensors;
        `lane_map` the config each lane held in the chunk."""
        ids = [int(i) for i in np.flatnonzero(quar.numpy())
               if int(i) not in benign]
        new = [i for i in ids if i not in self._quar_seen]
        if not new:
            return ids
        self._quar_seen.update(new)
        for i in new:
            if self._tracer is not None:
                self._tracer.instant(
                    "quarantine", cat="healing", iteration=int(iteration),
                    args={"lane": i, "config": (int(lane_map[i])
                                                if lane_map is not None
                                                else i)})
            where = self._quarantine_entry(i, debug)
            self._quar_diag[i] = {"iter": int(iteration), "where": where}
            who = (f"config {lane_map[i]} (lane {i})"
                   if lane_map is not None else f"config {i}")
            print(f"Sweep quarantine: {who} went non-finite at "
                  f"iteration {iteration}{where} — updates frozen, healthy "
                  "configs keep training", flush=True)
        if self._healing is not None:
            self._reclaim_flag.set()
        if self.solver._watchdog is not None:
            with self._watchdog_lock:
                if self._watchdog_event is None:
                    self._watchdog_event = {
                        "iter": int(iteration), "configs": new,
                        "policy": self.solver._watchdog}
                else:
                    # a not yet serviced event takes the new lanes too
                    self._watchdog_event["configs"].extend(new)
        return ids

    def _quarantine_entry(self, i: int, debug: Optional[dict]) -> str:
        """Lane i's first bad phase and layer from a chunk's host
        sentinels (" (phase, entry)"), or "" without the trace or when
        only the loss went bad."""
        if debug is None:
            return ""
        summ = self.solver.debug_spec.sentinel_summary(_lane_of(
            obs_counters.host_values({"sentinel": debug["sentinel"],
                                      "loss": debug["loss"]}), i))
        return f" ({summ['phase']} phase, {summ['entry']})" \
            if summ["tripped"] else ""

    def _watchdog_checkpoint(self) -> str:
        path = (f"{self.solver.param.snapshot_prefix}"
                f"_sweep_iter_{self.iter}.ckpt.npz")
        return self.checkpoint(path)

    def _service_watchdog(self) -> bool:
        """The armed watchdog's policy on a quarantine event the
        bookkeeping noted, on the dispatcher thread (checkpoint()
        drains the consumer, which the consumer cannot do itself):
        checkpoint the sweep ("snapshot") or stop it ("halt", sticky
        until restore()). Returns True when the sweep stops."""
        with self._watchdog_lock:
            ev, self._watchdog_event = self._watchdog_event, None
        if ev is None:
            return self._stop
        names = ", ".join(str(i) for i in ev["configs"])
        print(f"Sweep watchdog tripped at iteration {ev['iter']}: "
              f"config {names} quarantined", flush=True)
        if ev["policy"] == "snapshot":
            path = self._watchdog_checkpoint()
            print(f"Sweep watchdog checkpoint saved to {path}", flush=True)
        else:
            print("Sweep watchdog stopping the sweep.", flush=True)
            self._stop = True
        return self._stop

    def _finish_step(self):
        """step()'s barrier: drain the consumer (depth >= 1) or read the
        last chunk back (depth None), drain the spans, run a due census;
        returns the last iteration's host (losses, outputs)."""
        if self._pipeline_on:
            if self._consumer is not None:
                waited = self._consumer.drain()
                self.pipeline.drain_s += waited
                if self._tracer is not None:
                    self._tracer.complete("drain", waited,
                                          iteration=self.iter)
            self._service_watchdog()
        elif self._pending is not None:
            t0 = time.perf_counter()
            losses, outputs = self._pending
            self._pending = None
            host = obs_counters.HostCopy(
                {"losses": torch.stack(losses), "outputs": outputs}).wait()
            self._set_last_host(host["losses"], host["outputs"])
            self.pipeline.host_blocked_s += time.perf_counter() - t0
        self._drain_spans()
        self._maybe_health()
        return self._last_host

    def _drain_consumer(self):
        """The consumer barrier (no-op without a consumer)."""
        if self._consumer is not None:
            self.pipeline.drain_s += self._consumer.drain()

    def _on_stall(self, e: async_exec.StallError):
        """A chunk's bookkeeping stalled: write a best-effort checkpoint
        of the dispatcher's state without waiting on the stuck consumer,
        abandon the consumer and stop the sweep (until restore())."""
        path = (f"{self.solver.param.snapshot_prefix}"
                f"_sweep_stall_iter_{self.iter}.ckpt.npz")
        try:
            self.checkpoint(path, _drain=False)
            e.checkpoint_path = path
            print(f"Sweep stalled; emergency checkpoint saved to {path}",
                  flush=True)
        except Exception:
            pass
        if self._consumer is not None:
            self._consumer.abandon()
        self._stop = True
        return e

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # ------------------------------------------------------------------
    # telemetry: spans, the census, the setup record

    def enable_tracing(self, tracer=None, profile_dir: Optional[str] = None,
                       capacity: int = 0):
        """Arm the host span tracer (observe/spans.py): dispatch,
        submit_wait, consume and drain spans of every chunk across the
        dispatcher and consumer threads, and checkpoint, restore,
        save_faults and background write spans. Spans drain into the
        solver's metric sinks at every step() return; `profile_dir`
        sets where `write_trace()` (and `close()`) writes the Chrome
        trace. Returns the tracer."""
        from ..observe import spans as obs_spans
        if tracer is None:
            tracer = obs_spans.SpanTracer(
                capacity=capacity or obs_spans.DEFAULT_CAPACITY)
        self._tracer = tracer
        if threading.current_thread() is threading.main_thread():
            tracer.set_thread_role("dispatcher")
        if self._consumer is not None:
            self._consumer.tracer = tracer
            self._consumer.span_name = "consume"
        if self._bg_writer is not None:
            self._bg_writer.tracer = tracer
        if profile_dir is not None:
            self._trace_dir = profile_dir
        return tracer

    def _drain_spans(self):
        """Write the not-yet-drained span records to the metric sinks
        (dispatcher thread, after a consumer barrier)."""
        tr = self._tracer
        logger = (self.solver.metrics_logger
                  if self.solver._metrics_enabled else None)
        if tr is None or logger is None:
            return
        for rec in tr.drain_records():
            logger.log(rec)

    def write_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the tracer's Chrome trace to `path` (default
        `<profile_dir>/spans.p0.trace.json`); returns the path, None when
        tracing is off or no destination is known."""
        tr = self._tracer
        if tr is None:
            return None
        if path is None:
            if self._trace_dir is None:
                return None
            path = os.path.join(self._trace_dir,
                                f"spans.p{tr.process_index}.trace.json")
        return tr.write_chrome_trace(path)

    def _maybe_health_boundary(self):
        """Chunk-boundary census: when `iter` crossed a health_every
        boundary, drain the consumer first (the census record must not
        race its sink writes), then census."""
        every = self._health_every
        if not every:
            return
        tick = self.iter // every
        if self._last_health_tick is not None \
                and tick == self._last_health_tick:
            return
        self._drain_consumer()
        self._maybe_health()

    def _maybe_health(self):
        """The census at a drained barrier when `iter` crossed a
        health_every boundary since the last one (armed at the first
        call: nothing has worn at build or restore time)."""
        every = self._health_every
        if not every:
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
        solver = self.solver
        stack = solver.fault_process
        if self._health_census is None:
            self._health_census = obs_health.CensusProgram(
                stack, stacked=True, pack_spec=self._pack_spec)
        rec = obs_sink.make_health_record(
            self.iter, self._health_census(self.fault_states),
            process=stack.canonical(), every=every,
            decrement=stack.write_quantum(solver.fail_decrement),
            life_edges=obs_health.LIFE_EDGES,
            age_edges=obs_health.AGE_EDGES,
            tiles=(None if solver.tile_spec.is_default
                   else solver.tile_spec.canonical()),
            lane_map=([int(c) for c in self._healing.lane_cfg]
                      if self._healing is not None
                      else list(range(self.n))))
        self._health_ledger.update(rec)
        logger = (solver.metrics_logger
                  if solver._metrics_enabled else None)
        if logger is not None:
            logger.log(rec)
        return rec

    def health_summary(self):
        """HealthLedger.summary() of the censuses so far; None before the
        first, or with health_every 0."""
        if self._health_ledger is None:
            return None
        return self._health_ledger.summary()

    def setup_record(self, setup_s: Optional[float] = None) -> dict:
        """The observe `setup` record of this runner: dataset decode and
        kernel build seconds, the compile state, the pipeline
        accounting, bytes per step, the fault-bank format, the engine
        that ran and the conv operand mode; `setup_s` is the caller's
        total setup wall clock."""
        if self._consumer is not None:
            self.pipeline.consumer_s = self._consumer.consumer_s
        self.pipeline.snapshot_write_s = self._inline_write_s + (
            self._bg_writer.write_s if self._bg_writer is not None
            else 0.0)
        st = self.setup
        st.bytes_per_step = self.bytes_per_step_est()
        st.fault_format = "packed" if self._pack_spec is not None else "f32"
        st.fault_model = self.solver.fault_spec.to_model()
        st.engine = self.engine
        st.conv_im2col = self.conv_im2col_resolved
        st.conv_im2col_reason = self.conv_im2col_reason
        cpb = self.conv_patch_bytes_est()
        st.conv_patch_bytes = cpb if cpb else None
        return st.record(setup_s)

    def _genetic_due_at(self, iteration: int) -> bool:
        """Whether the genetic search runs before `iteration`, in every
        lane (one clock for all)."""
        g = self.solver.strategies.genetic
        return g is not None and g.due_at(iteration)

    def _active_lanes(self) -> list:
        """Lanes whose config is training (self-healing on): occupied
        and not frozen by the host."""
        h = self._healing
        return [lane for lane in range(self.n)
                if h.lane_cfg[lane] >= 0 and lane not in h.benign]

    def _genetic_chunk_cap(self, k: int) -> int:
        """Cut a chunk of k iterations short of the next iteration the
        genetic search is due at, so the search runs between chunks.
        Under self-healing each lane follows its own iteration count: a
        re-seeded config's schedule restarts with it."""
        if self._genetics is None:
            return k
        if self._healing is None:
            for j in range(1, k):
                if self._genetic_due_at(self.iter + j):
                    return j
            return k
        done = self._healing.lane_done
        lanes = self._active_lanes()
        for j in range(1, k):
            if any(self._genetic_due_at(int(done[lane]) + j)
                   for lane in lanes):
                return j
        return k

    def _maybe_genetic(self):
        if self._genetics is None:
            return
        if self._healing is None:
            if self._genetic_due_at(self.iter):
                self._apply_genetic()
            return
        done = self._healing.lane_done
        lanes = [lane for lane in self._active_lanes()
                 if self._genetic_due_at(int(done[lane]))]
        if lanes:
            self._apply_genetic(lanes)

    def _apply_genetic(self, lanes=None):
        """One genetic application in every lane (or in `lanes`, the
        self-healing per-lane schedule) that is not quarantined (a
        quarantined lane's params and generator stay as they are): the
        lanes' FC params and weight lifetimes (the mid-bin view of
        packed banks) to the host, each lane's search on its own slices
        with zero diffs, the params back."""
        s = self.solver
        flat = s._flat(self.params)
        keys = [k for pair in s.fc_pairs for k in pair if k is not None]
        data = {k: flat[k].detach().cpu().numpy().copy() for k in keys}
        weights = [w for w, _ in s.fc_pairs]
        state = (fault_packed.unpacked_view(self.fault_states,
                                            self._pack_spec, weights)
                 if self._pack_spec is not None else self.fault_states)
        lifetimes = {k: state["lifetimes"][k].detach().cpu().numpy()
                     for k in weights}
        quarantined = self.quarantine.cpu().numpy()
        for i, g in enumerate(self._genetics):
            if quarantined[i] or (lanes is not None and i not in lanes):
                continue
            lane = {k: v[i] for k, v in data.items()}     # views
            g.apply(lane, {k: np.zeros_like(v) for k, v in lane.items()},
                    {k: v[i] for k, v in lifetimes.items()})
        flat.update({k: torch.from_numpy(v).to(self.device)
                     for k, v in data.items()})
        self.params = s._unflat(flat, self.params)

    def lane_keys(self, it: int) -> np.ndarray:
        """(C, 2) step keys of iteration `it`: lane c's is
        fold_in(fold_in(solver key, it), c), as the reference's sweep
        derives them (with the step's noise, a block of iterations in one
        vectorised pass: Solver's StepNoise)."""
        return self._noise.step_key(self.solver._key, it, self.n,
                                    self._blocks[0].stop)

    def _commit(self, params, history, fault_states, loss, mets=None):
        """The per-lane quarantine of an unblocked iteration: a lane in
        `_bad_lanes` keeps its pre-step state; the step's outputs,
        masked in place, become the resident tensors."""
        bad = self._bad_lanes(self.quarantine, loss, mets or {})

        def keep(old, new):
            if new is old or new is None:
                return new
            return _masked_new(bad, old, new)
        self.params = {ln: [keep(o, v) for o, v in zip(self.params[ln],
                                                        vals)]
                       for ln, vals in params.items()}
        self.history = {k: {s: keep(self.history[k][s], v)
                            for s, v in slots.items()}
                        for k, slots in history.items()}
        self.fault_states = {g: {k: keep(self.fault_states[g][k], v)
                                 for k, v in grp.items()}
                             for g, grp in fault_states.items()}
        self.quarantine = bad

    # ------------------------------------------------------------------
    def quarantined(self) -> np.ndarray:
        """Ids of quarantined lanes, ascending."""
        return np.flatnonzero(self.quarantine.cpu().numpy())

    def sentinel_state(self) -> list:
        """Every lane's numeric-health summary of the last iteration
        (observe/debug.py): n_configs dicts {tripped, phase, entry,
        flags, loss}; [] until a step runs with the trace on (the
        solver's debug_info or watchdog set before the runner is
        built)."""
        m = self.last_metrics
        if not m or "debug" not in m:
            return []
        host = obs_counters.to_host(m["debug"])
        spec = self.solver.debug_spec
        return [spec.sentinel_summary(_lane_of(host, i))
                for i in range(self.n)]

    def evaluate(self, batch, net=None) -> Dict[str, np.ndarray]:
        """Every config's forward of a shared batch through `net` (the
        first test net, else the train net): the test forward of
        Solver.test (the training's ADC, the tile mapping, sigma 0, no
        crossbar masks) over all C lanes at once. Returns {output: (C,
        ...) array}; the evaluator is cached per net."""
        s = self.solver
        net = net or (s.test_nets[0] if s.test_nets else s.net)
        run = self._eval_fns.get(id(net))
        if run is None:
            ctx = s._test_context()
            laned = net.laned_blobs()

            def run(params, feed):
                with torch.no_grad():
                    blobs, _ = net.apply(params, feed, lanes=self.n, **ctx)
                return {name: net.lanes_first(name, blobs[name], self.n,
                                              name in laned)
                        for name in net.output_names}
            self._eval_fns[id(net)] = run
        feed = batch_to(batch, self.device)
        return {k: v.cpu().numpy() for k, v in run(self.params,
                                                    feed).items()}

    def broken_fractions(self) -> np.ndarray:
        """Per-lane share of broken cells over every fault leaf, (C,):
        the count times 1 / cells in float64, as the reference's jitted
        census computes it (XLA turns its division by a constant into a
        product with the reciprocal)."""
        lives = self.fault_states.get("life_q",
                                      self.fault_states.get("lifetimes"))
        if not lives:
            # a decay-only stack has no broken cells
            return np.zeros(self.n, np.float64)
        broken = sum((v <= 0).reshape(self.n, -1).sum(1)
                     for v in lives.values())
        total = sum(v[0].numel() for v in lives.values())
        return (broken.double() * (1.0 / max(total, 1))).cpu().numpy()

    def _state_tensors(self):
        for vals in self.params.values():
            yield from (t for t in vals if t is not None)
        for slots in self.history.values():
            yield from slots.values()
        for _, v in fault_engine.iter_state_leaves(self.fault_states):
            yield v
        yield self.quarantine

    def bytes_per_step_est(self) -> int:
        """Device-memory bytes one sweep iteration must move for its
        resident state: every state leaf (params, history, fault banks,
        the quarantine mask) read and written once, plus the batch
        gathered from the device dataset, plus the tiled convolutions'
        operands (`conv_patch_bytes_est`). Other activations are left
        out, as the reference leaves them out."""
        total = 2 * sum(t.numel() * t.element_size()
                        for t in self._state_tensors())
        if self._dataset is not None:
            total += self._ds_batch * sum(
                a[0].numel() * a.element_size()
                for a in self._dataset.values())
        return int(total + self.conv_patch_bytes_est())

    def conv_patch_bytes_est(self) -> int:
        """Bytes of the conv operands one step builds for its tiled
        Convolutions, by resolved mode (the reference's estimate): premat
        lanes*M*K*4 (the patch rows), tilewise lanes*M*min(bk, K)*4 (one
        K-tile slab), implicit lanes*N*C_in*Hp*Wp*4 (the padded flat
        activation the gather reads). Forward only: the implicit
        backward builds premat-shaped rows, counted nowhere, like every
        other activation."""
        solver = self.solver
        tiles_ctx = solver._tiles_ctx()
        mode = self.conv_im2col_resolved or "premat"
        total = 0
        for lname, tl in (tiles_ctx or {}).items():
            layer = solver.net.layer_by_name[lname]
            if layer.type_name != "Convolution":
                continue
            n, _, oh, ow = layer.top_shapes[0]
            m, kdim = n * oh * ow, int(np.prod(layer.weight_shape[1:]))
            if mode == "premat":
                total += m * kdim * 4
            elif mode == "tilewise":
                total += m * min(int(tl[0]), kdim) * 4
            else:
                _, c_in, h, w = solver.net.blob_shapes[layer.lp.bottom[0]]
                total += (n * c_in * (h + 2 * layer.pad[0])
                          * (w + 2 * layer.pad[1]) * 4)
        return int(total * self.n)

    def lane_state(self, i: int):
        """(params, history, fault_state) of lane i, copies without the
        config axis: the state a single-config Solver would hold."""
        params = {ln: [None if t is None else t[i].clone() for t in vals]
                  for ln, vals in self.params.items()}
        history = {k: {s: v[i].clone() for s, v in slots.items()}
                   for k, slots in self.history.items()}
        fault = {g: {k: v[i].clone() for k, v in grp.items()}
                 for g, grp in self.fault_states.items()}
        return params, history, fault

    # ------------------------------------------------------------------
    # self-healing: lane reclamation, retries, refills, the service hooks

    def enable_self_healing(self, budget: int, max_retries: int = 1,
                            backoff_iters: int = 0,
                            use_checkpoint: bool = True,
                            extra_configs=None, start_empty: bool = False,
                            virtual_time: bool = False):
        """Arm the self-healing layer (the reference's):
        every resident config becomes a work item with an iteration
        `budget` and at-least-once completion. At chunk boundaries the
        dispatcher harvests configs that completed their budget (the
        lane freezes), reclaims the lanes of quarantined configs (the
        attempt is voided; the config is queued again after
        `backoff_iters * attempt` iterations until `max_retries` retries
        are spent, then failed with the first bad iteration, phase and
        layer), and re-seeds free lanes from the queue: a first retry
        from the config's slice of the last checkpoint when there is one
        (`use_checkpoint`), else fresh params, history and a fault draw
        under a key folded from (config, attempt). Healthy lanes are
        untouched byte for byte. `extra_configs` ({"mean", "std"} specs)
        queue configs beyond the resident lanes; `start_empty=True`
        starts every lane idle, for work that arrives through
        `submit_configs`. `virtual_time=True` gives every lane its own
        iteration clock, its occupant's progress: the batch gather, the
        step keys (folded by config id, not lane index), the LR schedule,
        Adam's correction, the threshold's cutoff and the remap cadence
        all follow it, so a config's result depends only on (spec,
        config id, attempt, budget, solver seed), not on when it was
        seeded, which lane it landed in or what else shared the sweep.
        It needs the device-resident dataset and no config_block, and
        costs a C-wide batch gather a step."""
        if not self._pipeline_on:
            raise ValueError(
                "self-healing needs the chunk bookkeeping path: build "
                "the SweepRunner with pipeline_depth=0 (synchronous) or "
                ">= 1 (consumer thread), not None")
        if virtual_time:
            if self._dataset is None:
                raise ValueError(
                    "virtual_time=True needs the device-resident "
                    "dataset path (a materializable Data layer, "
                    "preload=True): per-lane iteration clocks gather "
                    "each lane's batch by its own index, which a "
                    "sequential host feed cursor cannot replay")
            if self.config_block:
                raise ValueError(
                    "virtual_time=True is incompatible with "
                    "config_block (the blocked lax.map packs a shared "
                    "batch across the block)")
        h = _HealingState(self.n, budget, max_retries, backoff_iters,
                          use_checkpoint, self.iter)
        if start_empty:
            # every lane idle and frozen until a submission seeds it
            h.lane_cfg[:] = -1
            h.benign = set(range(self.n))
        self._healing = h
        self._virtual_time = bool(virtual_time)
        self._out_axis = self._output_axes(laned_data=self._virtual_time)
        if start_empty:
            self._set_quarantine_bits(set_lanes=range(self.n))
        if extra_configs:
            self.submit_configs(extra_configs)
        return self

    def submit_configs(self, specs, budget: Optional[int] = None):
        """Queue {"mean", "std"} config specs into a self-healing sweep;
        free lanes take them at the next chunk boundary. `budget`
        overrides the sweep's iteration budget for these configs.
        Returns their config ids. Under packed banks a spec the int16
        counters could not hold raises (check_spec_bounds)."""
        h = self._healing
        if h is None:
            raise ValueError("submit_configs() needs "
                             "enable_self_healing() first")
        fp = self.solver.param.failure_pattern
        ids = []
        for spec in specs:
            cfg = h.next_config
            h.next_config += 1
            self._cfg_specs[cfg] = {
                "mean": float(spec.get("mean", fp.mean)),
                "std": float(spec.get("std", fp.std))}
            if self._pack_spec is not None:
                fault_packed.check_spec_bounds(
                    self._pack_spec, self._cfg_specs[cfg]["mean"],
                    self._cfg_specs[cfg]["std"])
            if budget is not None:
                if int(budget) <= 0:
                    raise ValueError("submit_configs budget must be "
                                     f"> 0, got {budget!r}")
                h.cfg_budget[cfg] = int(budget)
            h.pending.append({"config": cfg, "attempt": 1,
                              "eligible_iter": int(self.iter)})
            ids.append(cfg)
        return ids

    def set_refill_policy(self, policy):
        """The refill order: at each pass the eligible pending entries
        ({"config", "attempt", "eligible_iter"}) go through
        `policy(entries, lane_map)` (`lane_map` the occupancy, -1 for
        the free lanes about to be seeded) and are seeded in the order
        it returns; None restores (config, attempt) order."""
        self._refill_policy = policy

    def healing_complete(self) -> bool:
        """True when self-healing is armed and every requested config is
        completed or failed."""
        return self._healing is not None and self._healing.complete()

    def config_report(self) -> dict:
        """The completion ledger: every requested config id, the
        completed and failed records (attempts, final loss, broken share,
        diagnosis), the active lanes, the pending queue and the lane
        map."""
        h = self._healing
        if h is None:
            raise ValueError("config_report() needs "
                             "enable_self_healing() first")
        active = {}
        for lane in range(self.n):
            cfg = int(h.lane_cfg[lane])
            if cfg >= 0:
                active[cfg] = {"lane": lane,
                               "done": int(h.lane_done[lane]),
                               "attempt": int(h.lane_attempt[lane])}
        return {"requested": h.requested(),
                "completed": {int(k): dict(v)
                              for k, v in h.results.items()},
                "failed": {int(k): dict(v)
                           for k, v in h.failures.items()},
                "active": active,
                "pending": [dict(e) for e in h.pending],
                "lane_map": [int(c) for c in h.lane_cfg]}

    def _cfg_mean_std(self, cfg: int):
        """A config's (mean, std): its queued spec, else the runner's
        per-config arrays, else the pattern's."""
        spec = self._cfg_specs.get(cfg)
        if spec is not None:
            return float(spec["mean"]), float(spec["std"])
        fp = self.solver.param.failure_pattern
        mean = (float(self._means[cfg])
                if self._means is not None and cfg < len(self._means)
                else float(fp.mean))
        std = (float(self._stds[cfg])
               if self._stds is not None and cfg < len(self._stds)
               else float(fp.std))
        return mean, std

    def _fresh_genetic(self):
        g = copy.deepcopy(self.solver.strategies.genetic)
        g._rng = np.random.RandomState(g.seed)
        return g

    def _fresh_rows(self, cfg: int, attempt: int) -> Dict[str, np.ndarray]:
        """A fresh lane image for `cfg` under the `_state_arrays` names,
        as host arrays: the solver's initial params and history, and a
        fault draw under fold_in(fold_in(fold_in(solver key, 0xFA117),
        cfg), attempt) re-anchored to the config's (mean, std), packed
        under packed banks: each retry an independent sample of the
        spec."""
        s = self.solver
        rows: Dict[str, np.ndarray] = {}
        for layer, vals in s.params.items():
            for slot, v in enumerate(vals):
                if v is not None:
                    rows[f"params/{layer}/{slot}"] = _host_copy(v)
        for key, slots in s.history.items():
            for sname, v in slots.items():
                rows[f"history/{key}/{sname}"] = _host_copy(v)
        flat = s._flat(s.params)
        shapes = {k: tuple(flat[k].shape) for k in s._fault_keys}
        mean, std = self._cfg_mean_std(cfg)
        key = prng.fold_in(prng.fold_in(prng.fold_in(s._key, SWEEP_FOLD),
                                        cfg), attempt)
        # through the stack (its tile spec pinned at build)
        st = s.fault_process.draw_rescaled(
            key, shapes, s.param.failure_pattern, mean, std,
            device=self.device)
        if "remap_slots" in s.fault_state:
            # tracked remapping restarts at the identity map
            st["remap_slots"] = s.fault_state["remap_slots"]
        if self._pack_spec is not None:
            st = fault_packed.pack_state(st, self._pack_spec)
        for name, v in fault_engine.iter_state_leaves(st):
            rows[f"fault/{name}"] = _host_copy(v)
        return rows

    def _ckpt_lane_rows(self, cfg: int):
        """The config's last good slice of the last checkpoint, as
        (rows, lane_done, GeneticStrategy or None), or None when there
        is none (no checkpoint, the config not in it, or quarantined
        there). Either layout and either bank format."""
        path = self._last_ckpt_path
        if not path or not os.path.exists(path):
            return None
        try:
            self.wait_for_writes()
            data, meta, gen = self._load_checkpoint_data(path)
            if int(meta.get("version", 1)) < 2:
                return None          # v1 has no lane map to slice by
            lane_map = list(meta.get("lane_map") or [])
            if cfg not in lane_map:
                return None
            j = lane_map.index(cfg)
            if bool(np.asarray(data["quarantine"])[j]):
                return None          # not a good slice
            done = int(meta.get("lane_done",
                                [meta["iter"]] * len(lane_map))[j])
            genetic = None
            if self._genetics is not None:
                if gen is None:
                    return None
                genetic = genetic_state.loads(gen)[j]
            rows = {name: arr[j] for name, arr in data.items()
                    if name != "quarantine"}
            ck_fmt = meta.get("fault_format", "f32")
            ck_spec = meta.get("pack_spec")
            my_fmt = "packed" if self._pack_spec is not None else "f32"
            if ck_fmt != my_fmt or (ck_fmt == "packed"
                                    and ck_spec != self._pack_spec):
                bare = {n[len("fault/"):]: rows.pop(n)
                        for n in [n for n in rows
                                  if n.startswith("fault/")]}
                if ck_fmt == "packed":
                    bare = fault_packed.convert_flat(
                        bare, to_packed=False, spec=ck_spec)
                if my_fmt == "packed":
                    bare = fault_packed.convert_flat(
                        bare, to_packed=True, spec=self._pack_spec)
                rows.update({f"fault/{n}": a for n, a in bare.items()})
            if set(rows) != set(self._state_arrays()) - {"quarantine"}:
                return None
            return rows, done, genetic
        except Exception as e:       # best effort: the fresh path
            print(f"Sweep retry: config {cfg}'s slice of {path} is "
                  f"unreadable ({type(e).__name__}: {e}); recovering "
                  "fresh", file=sys.stderr, flush=True)
            return None

    def _recovery_rows(self, cfg: int, attempt: int):
        """Escalating recovery: a first retry from the config's
        checkpointed slice when there is one, otherwise (and for later
        retries and first seedings) fresh. Returns (rows, start_done,
        GeneticStrategy or None, recovery name)."""
        if self._healing.use_checkpoint and attempt == 2:
            got = self._ckpt_lane_rows(cfg)
            if got is not None:
                rows, done, genetic = got
                return rows, done, genetic, "checkpoint"
        return self._fresh_rows(cfg, attempt), 0, None, "fresh"

    @staticmethod
    def _edit_leaf_rows(stacked: torch.Tensor, rows: Dict[int, object]):
        """`stacked` (lanes first) with the given lanes' rows replaced in
        place, every other lane's storage untouched; returns `stacked`.
        A row may be a host array or a callable `fn(current row as a host
        array) -> new row` (the driver's NaN-injection hook)."""
        for lane, row in rows.items():
            dst = stacked[int(lane)]
            if callable(row):
                row = row(_host_copy(dst))
            row = np.ascontiguousarray(row)
            if tuple(row.shape) != tuple(dst.shape):
                raise ValueError(f"lane {lane}: row of shape "
                                 f"{tuple(row.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(row).to(stacked.dtype))
        return stacked

    def _write_lanes(self, updates: Dict[int, Dict[str, np.ndarray]]):
        """Each refilled lane's rows copied from the host into the
        resident tensors in place: untouched lanes keep their storage,
        byte for byte."""
        cur = self._state_arrays()
        for lane, rows in updates.items():
            for name, row in rows.items():
                t = cur[name]
                if tuple(row.shape) != tuple(t.shape[1:]):
                    raise ValueError(
                        f"lane refill: leaf {name!r} row has shape "
                        f"{tuple(row.shape)}, expected "
                        f"{tuple(t.shape[1:])}")
                t[int(lane)].copy_(torch.from_numpy(
                    np.ascontiguousarray(row)).to(t.dtype))

    def _set_quarantine_bits(self, set_lanes=(), clear_lanes=()):
        """The host's edit of the quarantine mask: freeze completed or
        idle lanes, release refilled ones (a new mask tensor: a pending
        host copy may still read the old one)."""
        m = self.quarantine.clone()
        lanes = sorted(set(set_lanes))
        if lanes:
            m[torch.tensor(lanes, device=m.device)] = True
        lanes = sorted(set(clear_lanes))
        if lanes:
            m[torch.tensor(lanes, device=m.device)] = False
        self.quarantine = m

    def _cfg_budget_of(self, cfg: int) -> int:
        """A config's iteration budget: its submission's, else the
        sweep's."""
        h = self._healing
        return int(h.cfg_budget.get(int(cfg), h.budget))

    def _budget_chunk_cap(self, k: int) -> int:
        """Cut a chunk so no active config runs past its budget (a
        completing lane freezes exactly at the boundary)."""
        h = self._healing
        if h is None:
            return k
        rem = [self._cfg_budget_of(h.lane_cfg[lane]) - int(h.lane_done[lane])
               for lane in self._active_lanes()]
        rem = [r for r in rem if r > 0]
        if rem:
            k = min(k, min(rem))
        return max(k, 1)

    def _emit_retry(self, rec: dict):
        """A retry record: its line printed, a healing instant on the
        trace, the record to the metric sinks."""
        from ..observe import sink as obs_sink
        print(obs_sink.retry_line(rec), flush=True)
        if self._tracer is not None:
            self._tracer.instant(
                rec["event"], cat="healing", iteration=rec["iter"],
                args={"config": rec["config"], "lane": rec["lane"],
                      "attempt": rec["attempt"]})
        if self.solver._metrics_enabled \
                and self.solver.metrics_logger is not None:
            self.solver.metrics_logger.log(rec)

    def _heal_pass(self, k: int = 0, losses=None) -> bool:
        """One chunk boundary of the self-healing dispatcher: advance
        each active lane by the `k` iterations just dispatched, harvest
        configs that completed their budget, reclaim quarantined lanes
        when the bookkeeping flagged one (behind a consumer drain: void
        the attempt, queue the config again or fail it), fast-forward
        the clock when nothing trains but work is queued, and re-seed
        free lanes from the queue (behind a drain). `losses` are the
        chunk's per-iteration (C,) tensors. Returns True when every
        requested config is completed or failed."""
        from ..observe import sink as obs_sink
        h = self._healing
        if h is None:
            return False
        t_heal = time.perf_counter() if self._tracer is not None else 0.0
        refilled, newly_benign = [], []
        if k:
            occupied = h.lane_cfg >= 0
            if h.benign:
                occupied &= ~np.isin(np.arange(self.n), list(h.benign))
            h.lane_done[occupied] += k

        # completion harvest
        done_lanes = [lane for lane in self._active_lanes()
                      if h.lane_done[lane]
                      >= self._cfg_budget_of(h.lane_cfg[lane])]
        if done_lanes:
            mask = self.quarantine.cpu().numpy()
            bf = self.broken_fractions()
            lvals = (losses[-1].detach().cpu().numpy()
                     if losses is not None else None)
            for lane in done_lanes:
                if mask[lane]:
                    continue   # diverged in its last chunk: reclaimed below
                cfg = int(h.lane_cfg[lane])
                h.results[cfg] = {
                    "status": "completed",
                    "attempts": int(h.lane_attempt[lane]),
                    "iter": int(self.iter), "lane": int(lane),
                    "loss": (float(lvals[lane])
                             if lvals is not None else None),
                    "broken": float(bf[lane])}
                if self.on_lane_complete is not None:
                    # the lane still holds the config's rows here
                    self.on_lane_complete(cfg, lane, h.results[cfg])
                h.lane_cfg[lane] = -1
                h.benign.add(lane)
                newly_benign.append(lane)

        # failure reclamation
        if self._reclaim_flag.is_set():
            # every dispatched chunk's announcement lands first
            self._drain_consumer()
            self._reclaim_flag.clear()
            mask = self.quarantine.cpu().numpy()
            for lane in np.flatnonzero(mask):
                lane = int(lane)
                if lane in h.benign or h.lane_cfg[lane] < 0:
                    continue
                cfg = int(h.lane_cfg[lane])
                attempt = int(h.lane_attempt[lane])
                diag = self._quar_diag.pop(lane, {})
                bad_iter = int(diag.get("iter", self.iter))
                diagnosis = (f"non-finite loss at iteration "
                             f"{bad_iter}{diag.get('where', '')}")
                if attempt < 1 + h.max_retries:
                    eligible = self.iter + h.backoff_iters * attempt
                    h.pending.append({"config": cfg,
                                      "attempt": attempt + 1,
                                      "eligible_iter": int(eligible)})
                    self._emit_retry(obs_sink.make_retry_record(
                        self.iter, cfg, lane, attempt, "requeue",
                        eligible_iter=int(eligible)))
                else:
                    h.failures[cfg] = {
                        "status": "failed", "attempts": attempt,
                        "iter": bad_iter, "lane": lane,
                        "diagnosis": diagnosis}
                    self._emit_retry(obs_sink.make_retry_record(
                        self.iter, cfg, lane, attempt, "failed",
                        diagnosis=diagnosis))
                h.lane_cfg[lane] = -1   # the mask bit keeps it frozen

        # fast-forward: nothing trains but work is queued
        if h.pending and not np.any(h.lane_cfg >= 0):
            min_el = min(int(e["eligible_iter"]) for e in h.pending)
            if min_el > self.iter:
                self.iter = min_el

        # refill free lanes from the queue
        free = [lane for lane in range(self.n) if h.lane_cfg[lane] < 0]
        eligible = sorted(
            (e for e in h.pending if e["eligible_iter"] <= self.iter),
            key=lambda e: (e["config"], e["attempt"]))
        if free and eligible and self._refill_policy is not None:
            eligible = list(self._refill_policy(
                eligible, [int(c) for c in h.lane_cfg]))
        if free and eligible:
            # behind a drain: a chunk queued before the refill carries
            # the freed lane's mask bit and would mark the new occupant
            # as announced
            self._drain_consumer()
            updates = {}
            for lane in free:
                if not eligible:
                    break
                e = eligible.pop(0)
                h.pending.remove(e)
                cfg, attempt = int(e["config"]), int(e["attempt"])
                rows, done0, genetic, recovery = self._recovery_rows(
                    cfg, attempt)
                updates[lane] = rows
                h.lane_cfg[lane] = cfg
                h.lane_done[lane] = done0
                h.lane_attempt[lane] = attempt
                h.benign.discard(lane)
                self._quar_seen.discard(lane)
                if self._genetics is not None:
                    self._genetics[lane] = (genetic if genetic is not None
                                            else self._fresh_genetic())
                refilled.append(lane)
                self._emit_retry(obs_sink.make_retry_record(
                    self.iter, cfg, lane, attempt, "reseed",
                    recovery=recovery))
            if updates:
                self._write_lanes(updates)

        complete = h.complete()
        if not complete and (refilled or newly_benign):
            self._set_quarantine_bits(set_lanes=newly_benign,
                                      clear_lanes=refilled)
        if self._tracer is not None:
            self._tracer.complete(
                "heal", time.perf_counter() - t_heal, cat="healing",
                iteration=self.iter,
                args={"refilled": len(refilled),
                      "harvested": len(newly_benign)})
        return complete

    # ------------------------------------------------------------------
    # durability: checkpoint / restore and the fault state files

    def _write(self, path: str, arrays: Dict[str, np.ndarray],
               background: bool) -> float:
        """One atomic .npz write of host arrays, on the background
        writer or inline; returns the inline seconds."""
        if background and self._bg_writer is None:
            self._bg_writer = async_exec.BackgroundWriter()
            self._bg_writer.tracer = self._tracer
        t0 = time.perf_counter()
        async_exec.write(path, _savez_writer(arrays),
                         self._bg_writer if background else None)
        return 0.0 if background else time.perf_counter() - t0

    def save_fault_states(self, path: str, background: bool = True) -> str:
        """Write the config-stacked fault state to `path` as an .npz
        ({"group/key": (C, ...) array}), always in the f32 layout
        (lifetimes, stuck values; packed banks as their mid-bin view,
        which keeps the broken census exact). The caller's thread pays
        the device fetch; the write runs on the background writer
        (`background=False` writes inline, as atomically)."""
        flat = {name: _host_copy(v) for name, v in
                fault_engine.iter_state_leaves(self.fault_states)}
        if self._pack_spec is not None:
            flat = fault_packed.convert_flat(flat, to_packed=False,
                                             spec=self._pack_spec)
        dt = self._write(path, flat, background)
        self._inline_write_s += dt
        if self._tracer is not None and not background:
            self._tracer.complete("save_faults", dt, iteration=self.iter,
                                  args={"path": os.path.basename(path)})
        return path

    def _state_arrays(self) -> Dict[str, torch.Tensor]:
        """Every resumable leaf under its checkpoint name: the params
        (shared slots skipped), the history, the fault state and the
        quarantine mask. The name set is the restore contract."""
        out = {}
        for layer, vals in self.params.items():
            for slot, v in enumerate(vals):
                if v is not None:
                    out[f"params/{layer}/{slot}"] = v
        for key, slots in self.history.items():
            for sname, v in slots.items():
                out[f"history/{key}/{sname}"] = v
        for name, v in fault_engine.iter_state_leaves(self.fault_states):
            out[f"fault/{name}"] = v
        out["quarantine"] = self.quarantine
        return out

    def _set_state_arrays(self, arrays: Dict[str, torch.Tensor]):
        """The inverse of `_state_arrays` (key sets already checked)."""
        self.params = {
            layer: [arrays.get(f"params/{layer}/{slot}", v)
                    for slot, v in enumerate(vals)]
            for layer, vals in self.params.items()}
        self.history = {
            key: {s: arrays[f"history/{key}/{s}"] for s in slots}
            for key, slots in self.history.items()}
        self.fault_states = {
            group: {k: arrays[f"fault/{group}/{k}"] for k in tree}
            for group, tree in self.fault_states.items()}
        self.quarantine = arrays["quarantine"]

    def _process_canonical(self) -> str:
        """The canonical fault-process spec the runner trains under (the
        v5 pin `restore` compares)."""
        return self.solver.fault_spec.canonical()

    def _tile_canonical(self) -> str:
        """The tile mapping the runner trains under (the v6 pin)."""
        return self.solver.tile_spec.canonical()

    def _ckpt_meta(self) -> dict:
        """The checkpoint's meta block, every key the reference writes:
        the virtual-time mode, the announced quarantines, the lane map and
        each lane's progress (the identity and `iter` without
        self-healing), and the self-healing block (with the queued
        configs' specs and the triage notes not yet reclaimed)."""
        h = self._healing
        meta = {"version": CHECKPOINT_VERSION, "iter": int(self.iter),
                "n_configs": int(self.n),
                "fault_format": ("packed" if self._pack_spec is not None
                                 else "f32"),
                "pack_spec": self._pack_spec,
                "fault_process": self._process_canonical(),
                "tile_spec": self._tile_canonical(),
                "key": [int(x) for x in np.asarray(self.solver._key).ravel()],
                "seed": int(self.solver.seed),
                "virtual_time": bool(self._virtual_time),
                "quarantined": sorted(self._quar_seen),
                "lane_map": ([int(c) for c in h.lane_cfg] if h is not None
                             else list(range(self.n))),
                "lane_done": ([int(x) for x in h.lane_done]
                              if h is not None
                              else [int(self.iter)] * self.n)}
        if h is not None:
            meta["healing"] = h.to_json()
            meta["healing"]["cfg_specs"] = {
                str(k): v for k, v in self._cfg_specs.items()}
            # a copy first: on the stall path the consumer may still
            # own the dict
            meta["healing"]["quar_diag"] = {
                str(k): v for k, v in dict(self._quar_diag).items()}
        return meta

    def checkpoint(self, path: str, background: bool = False,
                   distributed: Optional[bool] = None,
                   _drain: bool = True) -> str:
        """Write the whole resumable sweep state to `path`, one .npz
        (the reference's v6 layout: every `_state_arrays` leaf and
        `__meta__`, the meta as JSON bytes, and `__genetics__`, the
        lanes' genetic search state in the reference's pickle
        (fault/genetic_state.py)). The device fetch runs here;
        the write goes through a temp file and an atomic rename, on the
        background writer with `background=True`. A runner built with
        the same configuration continues from it bit for bit
        (`restore`). The pipeline is drained to a chunk boundary and
        queued writes land first; `_drain=False` (the stall path) skips
        every barrier that could wait on a stuck thread."""
        if distributed:
            _not_ported("checkpoint(distributed=True) (the v4 directory "
                        "layout is read by restore, not written)")
        t_ckpt = time.perf_counter()
        if _drain:
            self._drain_consumer()
            self.wait_for_writes()
            self.solver.wait_for_snapshots()
        arrays = {name: _host_copy(v)
                  for name, v in self._state_arrays().items()}
        arrays["__meta__"] = np.frombuffer(
            json.dumps(self._ckpt_meta()).encode(), np.uint8)
        if self._genetics is not None:
            arrays["__genetics__"] = np.frombuffer(
                genetic_state.dumps(self._genetics), np.uint8)
        if os.path.isdir(path):
            # a distributed checkpoint under this name: replaced
            import shutil
            shutil.rmtree(path)
        self.pipeline.checkpoint_write_s += self._write(path, arrays,
                                                        background)
        if self._tracer is not None:
            self._tracer.complete("checkpoint", time.perf_counter() - t_ckpt,
                                  iteration=self.iter,
                                  args={"path": os.path.basename(path)})
        # a retry's escalating recovery re-seeds from this file
        self._last_ckpt_path = path
        return path

    @staticmethod
    def _load_checkpoint_data(path: str):
        """(arrays, meta, genetics bytes or None) of either layout: the
        single .npz file, or the v4 distributed directory, whose shards'
        row blocks are put back together into whole arrays here."""
        if os.path.isdir(path):
            mpath = os.path.join(path, "manifest.json")
            if not os.path.exists(mpath):
                raise ValueError(
                    f"{path} is not a committed distributed checkpoint "
                    "(missing manifest.json — the write was interrupted "
                    "before the commit record landed)")
            with open(mpath) as f:
                manifest = json.load(f)
            pieces: Dict[str, list] = {}
            for sh in manifest["shards"]:
                lo = int(sh["rows"][0])
                with np.load(os.path.join(path, sh["file"])) as z:
                    for name in z.files:
                        pieces.setdefault(name, []).append((lo, z[name]))
            data = {}
            for name, blocks in pieces.items():
                blocks.sort(key=lambda b: b[0])
                off = 0
                for b_lo, b_arr in blocks:
                    if b_lo != off:
                        raise ValueError(
                            f"distributed checkpoint {path}: leaf {name!r} "
                            f"rows are not a contiguous partition (gap at "
                            f"row {off})")
                    off += b_arr.shape[0]
                data[name] = np.concatenate([b[1] for b in blocks], axis=0)
            gen = None
            gp = os.path.join(path, "global.npz")
            if os.path.exists(gp):
                with np.load(gp) as z:
                    for name in z.files:
                        if name == "__genetics__":
                            gen = z[name]
                        else:
                            data[name] = z[name]
            return data, manifest["meta"], gen
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        raw = data.pop("__meta__", None)
        if raw is None:
            raise ValueError(f"{path} is not a SweepRunner checkpoint "
                             "(missing __meta__)")
        meta = json.loads(bytes(bytearray(raw)).decode())
        return data, meta, data.pop("__genetics__", None)

    def restore(self, path: str):
        """Load a checkpoint of either package into this runner, which
        must have the same configuration (its config_block may differ):
        the configs, fault process, tile spec, solver key, virtual-time
        mode, genetic state exactly when the runner's lanes run the
        genetic search, self-healing armed when the file carries its
        state, the same leaves and shapes; each mismatch raises before
        anything changes. A healing runner takes the file's lane map,
        queue and ledgers back, or, from a file without them, the
        identity map with its own queued extra configs kept; a
        quarantined lane not yet reclaimed is reclaimed at the next
        boundary. Fault leaves convert between the f32 and packed formats
        (`fault_packed.convert_flat`); every leaf lands contiguous, in
        the live leaf's dtype, on the runner's device."""
        t_restore = time.perf_counter()
        self._drain_consumer()
        self.wait_for_writes()
        self.solver.wait_for_snapshots()
        data, meta, gen = self._load_checkpoint_data(path)
        found = meta.get("version")
        if found not in (1, 2, 3, 4, 5, CHECKPOINT_VERSION):
            raise ValueError(
                f"checkpoint {path} has format version {found!r} but this "
                f"build expects version {CHECKPOINT_VERSION} (v1-v5 "
                "checkpoints are upgraded in place)")
        if int(meta["n_configs"]) != self.n:
            raise ValueError(
                f"checkpoint {path} holds {meta['n_configs']} configs but "
                f"this runner was built with {self.n}")
        # the v5 pin: a checkpoint without one (v4 and older) is the
        # endurance default's and restores into an endurance runner alone
        ck_proc = meta.get("fault_process", DEFAULT_PROCESS)
        my_proc = self._process_canonical()
        if str(ck_proc) != my_proc:
            raise ValueError(
                f"checkpoint {path} was trained under fault process "
                f"{ck_proc!r} but this runner runs {my_proc!r}; "
                "restoring across fault physics would replay the wrong "
                "transition timeline — resume with the same "
                "fault_process spec the checkpoint was written under")
        ck_tiles, my_tiles = meta.get("tile_spec", LEGACY_TILES), \
            self._tile_canonical()
        if str(ck_tiles) != my_tiles:
            raise ValueError(
                f"checkpoint {path} was trained under tile spec "
                f"{ck_tiles!r} but this runner maps crossbars as "
                f"{my_tiles!r}; resume with the same tile_spec the "
                "checkpoint was written under (pre-v6 checkpoints are the "
                "untiled '1x1' mapping)")
        key = [int(x) for x in np.asarray(self.solver._key).ravel()]
        if list(meta["key"]) != key:
            raise ValueError(
                f"checkpoint {path} was taken under a different solver RNG "
                f"key (seed {meta.get('seed')}); resume with the same "
                "random_seed the checkpoint was written under")
        if bool(meta.get("virtual_time", False)) != self._virtual_time:
            raise ValueError(
                f"checkpoint {path} was written with virtual_time="
                f"{bool(meta.get('virtual_time', False))} but this "
                f"runner has virtual_time={self._virtual_time}; the "
                "per-lane clock changes the batch/RNG timeline, so "
                "resume with the same enable_self_healing mode")
        if (gen is None) != (self._genetics is None):
            raise ValueError(
                f"checkpoint {path} and this runner disagree on the "
                "genetic strategy (one has episodic search state, the "
                "other does not); resume with the same solver strategy "
                "configuration")
        genetics = genetic_state.loads(gen) if gen is not None else None
        heal_meta = meta.get("healing")
        if heal_meta is not None and self._healing is None:
            raise ValueError(
                f"checkpoint {path} carries self-healing state (lane "
                "map / retry queue) but this runner has it disabled; "
                "call enable_self_healing(...) before restore()")
        ck_fmt = meta.get("fault_format", "f32")
        my_fmt = "packed" if self._pack_spec is not None else "f32"
        ck_spec = meta.get("pack_spec")
        if ck_fmt != my_fmt or (ck_fmt == "packed"
                                and ck_spec != self._pack_spec):
            fault = {name[len("fault/"):]: arr for name, arr in data.items()
                     if name.startswith("fault/")}
            if ck_fmt == "packed":
                fault = fault_packed.convert_flat(fault, to_packed=False,
                                                  spec=ck_spec)
            if my_fmt == "packed":
                fault = fault_packed.convert_flat(fault, to_packed=True,
                                                  spec=self._pack_spec)
            data = {name: arr for name, arr in data.items()
                    if not name.startswith("fault/")}
            data.update({f"fault/{name}": arr for name, arr in fault.items()})
        current = self._state_arrays()
        saved, live = set(data), set(current)
        if saved != live:
            raise ValueError(
                f"checkpoint {path} state keys do not match this runner: "
                f"missing {sorted(live - saved)}, unexpected "
                f"{sorted(saved - live)}")
        placed = {}
        for name, arr in data.items():
            cur = current[name]
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(
                    f"checkpoint {path}: leaf {name!r} has shape "
                    f"{tuple(arr.shape)}, expected {tuple(cur.shape)}")
            placed[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=cur.device, dtype=cur.dtype)
        self._set_state_arrays(placed)
        self.iter = int(meta["iter"])
        self.last_losses = self.chunk_losses = None
        self.last_metrics = {}
        self._last_host = self._pending = self._record_t0 = None
        self._quar_seen = {int(i) for i in meta.get("quarantined", [])}
        if genetics is not None:
            self._genetics = genetics
        self._restore_healing(meta, heal_meta)
        self._last_ckpt_path = path
        with self._watchdog_lock:
            self._watchdog_event = None
        # the next census comes at the next boundary after the restore
        self._last_health_tick = None
        self._stop = False
        if self._tracer is not None:
            self._tracer.complete("restore", time.perf_counter() - t_restore,
                                  iteration=self.iter,
                                  args={"path": os.path.basename(path)})
        return self

    def _restore_healing(self, meta: dict, heal_meta: Optional[dict]):
        """The self-healing state after a restore: the file's (v2 and
        later), or the identity map with every lane mid-first-attempt
        from a file without it (the runner's queued extra configs kept);
        the reclamation re-armed for a quarantined lane not yet
        reclaimed."""
        self._quar_diag.clear()
        self._reclaim_flag.clear()
        if self._healing is None:
            return
        if heal_meta is not None:
            self._healing = _HealingState.from_json(heal_meta)
            self._cfg_specs = {int(k): v for k, v in
                               heal_meta.get("cfg_specs", {}).items()}
        else:
            h = self._healing
            h.lane_cfg = np.asarray(
                meta.get("lane_map", list(range(self.n))), np.int64)
            h.lane_done = np.asarray(
                meta.get("lane_done", [self.iter] * self.n), np.int64)
            h.lane_attempt = np.ones(self.n, np.int64)
            # configs queued beyond the resident lanes were requested
            # of this runner: keep them
            h.pending = [dict(e, attempt=1, eligible_iter=int(self.iter))
                         for e in h.pending if int(e["config"]) >= self.n]
            h.results, h.failures = {}, {}
            h.benign = set()
        h = self._healing
        self._quar_diag.update({int(k): v for k, v in
                                (heal_meta or {}).get("quar_diag",
                                                      {}).items()})
        mask = self.quarantine.cpu().numpy()
        if any(bool(mask[lane]) and h.lane_cfg[lane] >= 0
               and lane not in h.benign for lane in range(self.n)):
            self._reclaim_flag.set()

    def wait_for_writes(self):
        """Barrier for background writes (re-raises the first writer
        error)."""
        if self._bg_writer is not None:
            self._bg_writer.wait()

    def close(self):
        """Drain the consumer, land the queued writes, drain the spans
        and write the Chrome trace (with a profile_dir), then stop the
        consumer and writer threads (a sticky error re-raises here);
        later calls do nothing."""
        if self._closed:
            return
        self._closed = True
        writer, self._bg_writer = self._bg_writer, None
        try:
            self._drain_consumer()
            if writer is not None:
                writer.wait()
            self._drain_spans()
            self.write_trace()
        finally:
            if self._consumer is not None:
                self._consumer.close()
            if writer is not None:
                writer.close()


class GroupPrefetcher:
    """Builds the next resident group of a multi-group sweep while the
    current group runs (the reference's GroupPrefetcher; the driver
    examples/gaussian_failure/run_1000_sweep.py). `start(build_fn,
    *args)` runs `build_fn(*args)` (returning a runner) on a daemon
    `group-prefetch` thread, one build in flight at a time; `take()`
    joins it, returns the runner, re-raises a build error, and credits
    max(build - wait, 0) seconds, the build's seconds that `take()` did
    not wait for, to the runner's `pipeline.setup_overlap_s` (the
    reference's measure: wall time saved only where the build did not
    compete with the running group; on the card its draws share the
    SMs). `cancel()` joins and
    closes an abandoned build's runner (its errors dropped); leaving the
    context manager cancels. With `tracer` set, each build is a
    `group_build` span (cat "setup") on the thread's track.

    On the card the build issues its device work (the key chain's draws,
    the state's placement, the dataset upload) on a CUDA stream of its
    own, which the thread synchronizes before it ends: the running
    group's kernels on the main stream do not queue behind it, and
    `take()` hands over a runner whose tensors are ready. `take()` marks
    the runner's resident tensors as used on the caller's stream, so the
    caching allocator does not hand their blocks back to the build
    stream while the main stream may still read them."""

    def __init__(self):
        self._thread = None
        self._box: dict = {}
        self.last_build_s = 0.0   # the last build's own wall seconds
        self.last_wait_s = 0.0    # how long take() still blocked on it
        self.tracer = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.cancel()
        return False

    def start(self, build_fn, *args):
        """Start `build_fn(*args)` on the prefetch thread."""
        if self._thread is not None:
            raise RuntimeError("a group prefetch is already in flight; "
                               "take() it first")
        box = self._box = {}
        tracer = self.tracer

        def run():
            t0 = time.perf_counter()
            try:
                if torch.cuda.is_available():
                    stream = torch.cuda.Stream()
                    with torch.cuda.stream(stream):
                        box["result"] = build_fn(*args)
                    stream.synchronize()
                else:
                    box["result"] = build_fn(*args)
            except BaseException as e:
                box["error"] = e
            finally:
                box["seconds"] = time.perf_counter() - t0
                if tracer is not None:
                    tracer.complete("group_build", box["seconds"],
                                    cat="setup")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="group-prefetch")
        self._thread.start()

    def take(self):
        """Join the build and return its runner (a build error re-raises
        here), recording `last_build_s` and `last_wait_s`."""
        if self._thread is None:
            raise RuntimeError("no group prefetch in flight")
        t0 = time.perf_counter()
        self._thread.join()
        self.last_wait_s = time.perf_counter() - t0
        self._thread = None
        box = self._box
        self.last_build_s = box.get("seconds", 0.0)
        if "error" in box:
            raise box["error"]
        runner = box["result"]
        if torch.cuda.is_available() and hasattr(runner, "_record_stream"):
            runner._record_stream(torch.cuda.current_stream())
        pipe = getattr(runner, "pipeline", None)
        if pipe is not None:
            pipe.setup_overlap_s += max(self.last_build_s
                                        - self.last_wait_s, 0.0)
        return runner

    def cancel(self):
        """Abandon the build in flight: join the thread and close the
        runner it made (its consumer and writer threads); a build error
        is dropped. Nothing in flight: nothing to do."""
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        runner = self._box.get("result")
        if runner is not None:
            try:
                runner.close()
            except Exception:
                pass


def sequential_sweep(solver_param, configs, iters, eval_iters: int = 0,
                     device=None):
    """One full Solver per fault config, run one after another (the
    reference's sequential_sweep, parallel/sweep.py:3487): the cross-check
    that uses no config axis, and the driver for grids whose configs
    differ in structure (the stuck-value draw, a strategy). Each config
    is one `caffe train` process of the fork's per-grid scripts, minus
    the process boundary.

    `configs` is a list of dicts applied onto a copy of `solver_param`
    (through `proto.encode`/`decode`) before each run: "mean"/"std"
    override failure_pattern, "seed" sets random_seed, "prob" p sets
    failure_prob to neg = pos = p and zero = 100 - 2p, "threshold" adds
    a threshold strategy; any other key is set as a SolverParameter
    field. Runs on the card unless `device="cpu"`.

    Returns a list of per-config records: {"config", "loss" (the final
    smoothed loss), "broken" (with a fault engine), "scores" (test net
    0's outputs, when `eval_iters` and a test net)}.
    """
    device = resolve_device(device)
    results = []
    for cfg in configs:
        param = proto.decode(proto.encode(solver_param), "SolverParameter")
        for k, v in cfg.items():
            if k == "mean":
                param.failure_pattern.mean = float(v)
            elif k == "std":
                param.failure_pattern.std = float(v)
            elif k == "seed":
                param.random_seed = int(v)
            elif k == "prob":
                fp = param.failure_pattern.failure_prob
                fp.neg = fp.pos = int(v)
                fp.zero = 100 - 2 * int(v)
            elif k == "threshold":
                sp = proto.Message("FailureStrategyParameter")
                sp.type = "threshold"
                sp.threshold = float(v)
                param.failure_strategy.append(sp)
            else:
                setattr(param, k, v)
        solver = solver_mod.Solver(param, device=device)
        solver.step(iters)
        rec = {"config": dict(cfg),
               "loss": solver._materialize_smoothed_loss()}
        if solver.fault_state is not None:
            rec["broken"] = float(solver.broken_fraction())
        if eval_iters and solver.test_nets:
            rec["scores"] = solver.test(0)
        results.append(rec)
    return results
