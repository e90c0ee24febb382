"""The JSONL metrics record schema (the port's copy of the reference
package's observe/schema.py, kept whole: the port's records must
validate under both, so the two copies stay equal).

One record per display interval, one JSON object per line. The schema is
deliberately dependency-free (no torch/numpy imports) so a bare
interpreter can load this module by file path and validate logs without
pulling in the framework.

The port's `setup` record adds one field the schema does not declare
(undeclared fields pass): `engine`, the engine that ran ("cuda" or
"torch").

Top-level record::

    {"schema_version": 1, "iter": 100, "wall_time": 1722700000.1,
     "loss": 0.83, "smoothed_loss": 0.85, "lr": 0.01,
     "step_latency_s": 0.0121, "iters_per_s": 82.6,
     "seed": 1701,                       # first record of a run only
     "grad_norm": 2.1, "update_norm": 0.2,
     "outputs": {"loss": 0.83, "accuracy": 0.71},
     "quarantine": [2, 7],               # sweep records only, see below
     "fault": {"broken_total": 120, "newly_expired": 7,
               "life_min": -35.0, "life_mean": 9.1e7,
               "writes_saved": 4096,
               "per_param": {"fc1/0": {"broken": 100, "newly_expired": 5,
                                       "life_min": -35.0,
                                       "life_mean": 8.9e7}},
               "per_process": {"endurance_stuck_at": {"broken": 120},
                               "conductance_drift": {
                                   "drifted": 9000, "age_mean": 41.2}},
               "per_tile": {"fc1/0": {          # tiled mapping only
                   "grid": [2, 2],              # tile rows x cols
                   "broken_frac": [0.1, 0.0, 0.2, 0.05],
                   "life_min": [-35.0, 12.0, -3.0, 88.0],
                   "stuck_neg": [3, 0, 5, 1],   # broken cells reading
                   "stuck_zero": [9, 0, 11, 4], # -1 / 0 / +1 per tile
                   "stuck_pos": [2, 0, 4, 1]}}}}

`fault` is present only when the solver runs a fault engine; `seed` only
on the first record a Solver writes — so once per run segment: a
resumed run (JSONL append mode) logs its own seed on ITS first record,
which is the seed that replays the post-resume iterations; everything
else every record. Under a Monte-Carlo
sweep the scalar counter fields become per-config lists — `validate_record`
accepts both shapes — and `quarantine` (sweep records only, present only
when non-empty) lists the config indices whose updates the per-config
NaN/Inf quarantine has frozen: those lanes stopped training at the listed
membership's onset while the rest of the group continued.

Further record types are keyed by a `"type"` field (records without one
are the metrics record above): `setup` — one per process cold start,
the decode/compile breakdown plus per-cache hit/miss (documented inline
below) — `retry`, `request`, `worker` (fleet-service worker lifecycle,
serve/fleet/), `alert` (watchtower rule transitions), `chaos`
(deterministic failure injections, serve/fleet/chaos.py),
`fault_redraw`, `span` (host-side time spans from
observe/spans.py, documented inline below), and two that carry the
`debug_info` deep traces:

``debug_trace`` — one per iteration while `debug_info: true`, the
structured twin of the reference's ForwardDebugInfo / BackwardDebugInfo
/ UpdateDebugInfo glog lines (net.cpp:618-668)::

    {"schema_version": 1, "type": "debug_trace", "iter": 3,
     "wall_time": 1722700000.1,
     "forward":  [{"layer": "fc1", "kind": "top",   "blob": "fc1",
                   "value": 0.41}, ...],          # kind: top | param
     "backward": [{"layer": "fc1", "kind": "param", "blob": "0",
                   "value": 0.003}, ...],         # kind: bottom | param
     "update":   [{"layer": "fc1", "param": "0", "data": 0.39,
                   "diff": 0.0002}, ...],
     "params_l1": [12.3, 0.4], "params_l2": [5.0, 0.1]}

``sentinel`` — emitted when an in-jit numeric health sentinel trips
(NaN / Inf / overflow in a phase's trace vector) or the watchdog sees a
non-finite loss (phase "loss")::

    {"schema_version": 1, "type": "sentinel", "iter": 3,
     "wall_time": 1722700000.1, "phase": "forward",
     "entry": "layer fc1, top blob fc1",
     "nan": true, "inf": false, "overflow": false, "loss": NaN}

Trace values may legitimately be NaN/Inf (that is what they diagnose);
Python's json module reads and writes those literals.

Semantics worth knowing: `step_latency_s`/`iters_per_s` cover the
TRAINING time of the interval since the previous record (test-net
evaluation and snapshot writes are excluded; the first interval includes
jit compile). `fault.writes_saved` is the interval TOTAL of
threshold-suppressed writes, so summing it across records gives the
run's whole write-budget saving; the other fault counters are
instantaneous state at the record's iteration.
"""
from __future__ import annotations

SCHEMA_VERSION = 1

_NUM = (int, float)          # JSON numbers; bools are excluded explicitly

# field -> (accepted types, required)
TOP_LEVEL = {
    "schema_version": (int, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "loss": (_NUM, True),
    "lr": (_NUM, True),
    "step_latency_s": (_NUM, True),
    "iters_per_s": (_NUM, True),
    "smoothed_loss": (_NUM, False),
    "seed": (int, False),
    "grad_norm": (_NUM, False),
    "update_norm": (_NUM, False),
    "outputs": (dict, False),
    "quarantine": (int, False),   # non-empty list of lane indices
    "lane_map": (int, False),     # self-healing sweeps: config id per
                                  # lane (-1 = idle lane), see below
    "fault": (dict, False),
}

FAULT_FIELDS = {
    "broken_total": (int, True),
    "newly_expired": (int, True),
    "life_min": (_NUM, True),
    "life_mean": (_NUM, True),
    "writes_saved": (int, True),
    "per_param": (dict, False),
    # per-process census contributions (fault/processes/): counter name
    # -> number (or per-config list) keyed by the process that produced
    # it, e.g. {"endurance_stuck_at": {"broken": 120},
    # "conductance_drift": {"drifted": 9000, "age_mean": 41.2}}
    "per_process": (dict, False),
    # tile-resolved census (fault/mapping.py per_tile_counters, only
    # under a non-default tile spec): per >=2-D fault target, the tile
    # grid plus per-tile vectors in tile-major order — broken-cell
    # fraction, min remaining lifetime, and the broken-cell stuck
    # histogram (counts reading -1/0/+1). Conv fault targets census
    # over their im2col (K, N) view and carry its dims as "view".
    # Under a sweep every vector gains a leading
    # per-config axis (lists of lists).
    "per_tile": (dict, False),
}

PER_PARAM_FIELDS = {
    "broken": (int, True),
    "newly_expired": (int, True),
    "life_min": (_NUM, True),
    "life_mean": (_NUM, True),
}

PER_TILE_FIELDS = {
    "grid": (list, True),
    # conv fault targets only: the im2col (K, N) crossbar view dims
    # the grid partitions (absent for FC weights, whose grid covers
    # the stored matrix)
    "view": (list, False),
    "broken_frac": (list, True),
    "life_min": (list, True),
    "stuck_neg": (list, True),
    "stuck_zero": (list, True),
    "stuck_pos": (list, True),
}

# --- debug_trace records (the structured debug_info trace) ---

DEBUG_TRACE_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "forward": (list, True),
    "backward": (list, True),
    "update": (list, True),
    "params_l1": (list, True),
    "params_l2": (list, True),
}

DEBUG_BLOB_FIELDS = {
    "layer": (str, True),
    "kind": (str, True),
    "blob": (str, True),
    "value": (_NUM, True),
}

# legal `kind` values per trace list
DEBUG_KINDS = {"forward": ("top", "param"),
               "backward": ("bottom", "param")}

DEBUG_UPDATE_FIELDS = {
    "layer": (str, True),
    "param": (str, True),
    "data": (_NUM, True),
    "diff": (_NUM, True),
}

# --- setup records (cold-start breakdown, one per process start) ---
#
# {"schema_version": 1, "type": "setup", "wall_time": 1722700000.1,
#  "decode_seconds": 121.4, "compile_seconds": 14.9,
#  "setup_seconds": 136.6,                       # caller's total wall
#  "cache": {"compile": "hit", "dataset": "miss"},
#  "cache_dir": "/var/cache/rram-tpu",
#  "bytes_per_step_est": 1234567890,             # sweep runs only
#  "fault_state_format": "packed",               # "f32" | "packed"
#  "pipeline": {"depth": 2, "chunks": 100, "records": 100,
#               "host_blocked_seconds": 0.021,
#               "consumer_seconds": 3.4, "drain_seconds": 0.8,
#               "snapshot_write_seconds": 1.2,
#               "checkpoint_write_seconds": 0.4,
#               "setup_overlap_seconds": 12.1}}
#
# decode/compile may OVERLAP (SweepRunner precompile_chunk), so the two
# phase fields need not sum to setup_seconds. Cache states: "hit" =
# every lookup served from disk, "miss" = none, "partial" = mixed
# (compile cache only), "disabled" = no cache dir configured,
# "unused" = cache configured but this run had no such work (e.g. an
# Input-fed bench performs no dataset decode).
#
# `bytes_per_step_est` (optional, sweep runs) is the runner's
# estimated HBM bytes moved per sweep iteration (resident state read +
# write, plus the dataset batch gather; activations excluded) and
# `fault_state_format` the fault-bank layout behind it ("f32" = the
# reference's float leaves, "packed" = the bit-packed counter banks of
# fault/packed.py) — the fields the HBM-floor trajectory (BENCH r06+)
# tracks. `config_shards` (optional, pod-scale sweeps) is how many
# mesh shards the config axis spans — when > 1 the resident state is
# spread over that many chips and `bytes_per_step_est` is the PER-CHIP
# share. `engine_fallback_reason` (optional, non-empty) is the
# loud-fallback contract: why an engine="pallas" request resolved to
# the jax engine (dp/tp mesh axes, no crossbar read to fuse,
# non-divisible config axis, non-TPU auto resolution, ...) — omitted
# entirely when the requested engine ran.
#
# `pipeline` (optional) is the async-execution-layer accounting
# (async_exec.PipelineStats): `depth` 0 = synchronous bookkeeping,
# >= 1 = bounded-queue consumer thread; `host_blocked_seconds` is the
# dispatcher's total blocked time across `chunks` dispatches (inline
# fetch+sink time when sync, submit backpressure when pipelined);
# `consumer_seconds` the concurrent consumer work; `drain_seconds`
# barrier waits; `snapshot_write_seconds` serialize+rename time moved
# off the hot loop; `checkpoint_write_seconds` inline sweep-checkpoint
# writes (the durability layer's per-group overhead);
# `setup_overlap_seconds` next-resident-group setup that ran
# concurrently with the previous group's execution.

SETUP_CACHE_STATES = ("hit", "miss", "partial", "disabled", "unused")

FAULT_STATE_FORMATS = ("f32", "packed")

SETUP_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "wall_time": (_NUM, True),
    "decode_seconds": (_NUM, True),
    "compile_seconds": (_NUM, True),
    "setup_seconds": (_NUM, False),
    "cache": (dict, True),
    "cache_dir": (str, False),
    "pipeline": (dict, False),
    "bytes_per_step_est": (int, False),
    "fault_state_format": (str, False),
    "config_shards": (int, False),
    "fault_model": (dict, False),
    "engine_fallback_reason": (str, False),
    # the tiles-bypass loud-warning trail (same contract as
    # engine_fallback_reason): the layer names a non-default tile
    # spec did NOT cover — convolution layers bypass the crossbar
    # tile mapping today — so a tiled log can never silently claim
    # conv weights sat on tiled crossbars. Non-empty list of layer
    # names; omitted entirely when every fault target is tiled.
    "tiles_bypassed": (str, False),
    # conv im2col operand-mode trail: the RESOLVED mode a
    # tiled-conv sweep traced ("premat" | "tilewise" | "implicit"),
    # the recorded resolution reason (why a requested mode fell back,
    # or — for implicit — that the backward still materializes patch
    # rows), and the patch-operand share of bytes_per_step_est in
    # bytes (SweepRunner.conv_patch_bytes_est). All three omitted
    # when the run has no tiled conv layer.
    "conv_im2col": (str, False),
    "conv_im2col_reason": (str, False),
    "conv_patch_bytes": (int, False),
}

CONV_IM2COL_MODES = ("premat", "tilewise", "implicit")

# `fault_model` (optional, fault-engine runs) names the fault-process
# stack the run trains under (fault/processes/): `spec` is the
# canonical process-spec string ("endurance_stuck_at",
# "conductance_drift:nu=0.2+endurance_stuck_at", ...) and `processes`
# the per-process explicit parameter dicts (numbers or strings),
# present only when any process was parameterized.
FAULT_MODEL_FIELDS = {
    "spec": (str, True),
    "processes": (dict, False),
}

SETUP_CACHE_FIELDS = {
    "compile": (str, True),
    "dataset": (str, True),
}

PIPELINE_FIELDS = {
    "depth": (int, True),
    "chunks": (int, True),
    "host_blocked_seconds": (_NUM, True),
    "records": (int, False),
    "consumer_seconds": (_NUM, False),
    "drain_seconds": (_NUM, False),
    "snapshot_write_seconds": (_NUM, False),
    "checkpoint_write_seconds": (_NUM, False),
    "setup_overlap_seconds": (_NUM, False),
}

# --- retry records (self-healing sweep lane reclamation events) ---
#
# One per lane-reclamation event in a self-healing sweep
# (SweepRunner.enable_self_healing): a quarantined config's attempt is
# voided and the config re-enqueued ("requeue"), a freed lane is
# re-seeded with a queued config ("reseed", with `recovery` naming the
# escalation level used — "checkpoint" restored the config's last good
# checkpointed slice, "fresh" re-initialized with a fresh RNG key), or
# a config exhausts its retry budget ("failed", with the triage
# `diagnosis` carrying the watchdog's first-bad-phase/layer attribution
# when tracing was armed)::
#
#     {"schema_version": 1, "type": "retry", "iter": 150,
#      "wall_time": 1722700000.1, "config": 7, "lane": 3, "attempt": 2,
#      "event": "reseed", "recovery": "fresh"}
#
# A metrics record in a self-healing sweep additionally carries
# `lane_map` — the config id occupying each vectorized lane when the
# chunk was dispatched (-1 = idle lane, queue exhausted) — so the
# per-config loss vectors stay attributable after a refill.

RETRY_EVENTS = ("requeue", "reseed", "failed")
RETRY_RECOVERIES = ("checkpoint", "fresh")

RETRY_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "config": (int, True),
    "lane": (int, True),
    "attempt": (int, True),
    "event": (str, True),
    "recovery": (str, False),       # reseed events only
    "eligible_iter": (int, False),  # requeue events: backoff target
    "diagnosis": (str, False),      # failed events: triage attribution
}

# --- request records (sweep-as-a-service lifecycle) ---
#
# One per lifecycle transition of a fault-sweep request submitted to a
# resident SweepService (serve/): emitted into the service-wide metrics
# stream AND the request's own `requests/<id>.jsonl` stream, so a
# tenant can tail their request without reading anyone else's.
# Events: "submitted" (spooled), "admitted" (queued into the live lane
# work queue; `projected_s` is the admission controller's backlog
# projection), "rejected" (admission control refused it — `reason`
# names why, `projected_s` the projection that exceeded the SLO
# window), "started" (first config seeded into a lane; `queue_s` is
# the submit->first-lane wait), "config_done" (one config reached a
# terminal state; `config` is its global id, `status`
# completed|failed), "completed"/"failed" (every config terminal;
# `latency_s` is the submit->terminal wall clock — the turnaround the
# SLO is about, and what `summarize` digests), "preempted" (service
# drained with the request in flight, state checkpointed), "resumed"
# (a restarted service picked the request back up)::
#
#     {"schema_version": 1, "type": "request", "iter": 120,
#      "wall_time": 1722700000.1, "request": "r-0007", "tenant": "alice",
#      "event": "completed", "configs": 4, "done": 4, "latency_s": 93.2}

REQUEST_EVENTS = ("submitted", "admitted", "rejected", "started",
                  "config_done", "completed", "failed", "preempted",
                  "resumed")

REQUEST_STATUSES = ("completed", "failed")

REQUEST_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "request": (str, True),
    "tenant": (str, True),
    "event": (str, True),
    "configs": (int, False),       # configs in the request
    "done": (int, False),          # terminal configs so far
    "config": (int, False),        # config_done: global config id
    "status": (str, False),        # config_done: completed | failed
    "latency_s": (_NUM, False),    # terminal: submit -> terminal secs
    "queue_s": (_NUM, False),      # started: submit -> first lane secs
    "projected_s": (_NUM, False),  # admitted/rejected: backlog
                                   # projection vs the SLO window
    "reason": (str, False),        # rejected / failed: why
}

# --- worker records (fleet-service worker lifecycle, serve/fleet/) ---
#
# One per fleet-worker lifecycle event: the FleetController emits
# registered/assigned/requeued/swap_requested/dead/drain_requested/
# spawned into the fleet-wide `fleet.jsonl` stream, and each worker
# emits its own `swap` (with the measured hot-swap latency and the
# persistent-compile-cache counter delta that proves the swap hit
# disk instead of recompiling) and `heartbeat` records into its own
# service metrics stream. `pinned` is the worker's compiled program
# set — canonical fault-process spec, dtype_policy ("f32" when none),
# net name, canonical tile-mapping spec, and a mesh descriptor —
# what the router matches requests against::
#
#     {"schema_version": 1, "type": "worker", "iter": 40,
#      "wall_time": 1722700000.1, "worker": "w0", "event": "swap",
#      "pinned": {"process": "conductance_drift:nu=0.2",
#                 "dtype_policy": "f32", "net": "quick",
#                 "tiles": "1x1", "mesh": "single"},
#      "swap_s": 1.9, "cache_hits": 12, "cache_misses": 0}

WORKER_EVENTS = ("registered", "heartbeat", "assigned", "requeued",
                 "swap_requested", "swap", "swap_refused", "dead",
                 "removed", "spawned", "drain_requested")

WORKER_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "worker": (str, True),
    "event": (str, True),
    "request": (str, False),        # assigned / requeued: which request
    "pinned": (dict, False),        # the compiled program set (strings)
    "lanes": (int, False),
    "occupied_lanes": (int, False),
    "pending_configs": (int, False),
    "swap_s": (_NUM, False),        # swap: measured hot-swap latency
    "resident": (bool, False),      # swap: True = the target program
                                    # set was PARKED in memory and
                                    # re-activated (zero compiles);
                                    # False = fresh build
    "cache_hits": (int, False),     # swap: compile-cache counter delta
    "cache_misses": (int, False),
    "reason": (str, False),         # dead / requeued: why
}

# --- alert records (fleet watchtower rule engine) ---
#
# Emitted by the FleetController's declarative rule engine
# (serve/fleet/alerts.py) on STATE TRANSITIONS only: one record when a
# rule crosses its threshold and holds for `for_beats` consecutive
# beats ("firing"), one when it holds clear for the resolve hysteresis
# ("resolved") — never one per beat, so a flapping metric at the
# threshold produces no record storm. `metric` names the fleet rollup
# gauge the rule watches, `value` the observation that crossed, and
# `threshold`/`for_beats` echo the rule so the record is
# self-describing without the rule file::
#
#     {"schema_version": 1, "type": "alert", "iter": 310,
#      "wall_time": 1722700000.1, "alert": "slo_burn",
#      "event": "firing", "metric": "rram_slo_burn_rate",
#      "value": 1.8, "threshold": 1.0, "for_beats": 3,
#      "severity": "page", "worker": "w1",
#      "reason": "tenant _total burn 1.8 > 1.0 for 3 beats"}

ALERT_EVENTS = ("firing", "resolved")

ALERT_SEVERITIES = ("info", "warn", "page")

ALERT_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),            # controller beat counter
    "wall_time": (_NUM, True),
    "alert": (str, True),           # rule name (e.g. "slo_burn")
    "event": (str, True),           # firing | resolved
    "metric": (str, False),         # rollup metric the rule watches
    "value": (_NUM, False),         # observation at the transition
    "threshold": (_NUM, False),     # rule threshold
    "for_beats": (int, False),      # firing hysteresis (beats held)
    "severity": (str, False),       # info | warn | page
    "worker": (str, False),         # worker-scoped rules (death, swap)
    "reason": (str, False),         # human-readable one-liner
}

# --- chaos records (deterministic failure injection) ---
#
# Emitted by the fleet chaos plane (serve/fleet/chaos.py) at the
# moment each seeded injection is applied, so a trace reads as "what
# was done to the fleet" next to the `worker`/`alert` records showing
# how the fleet survived it. `iter` is the plan's own monotonic beat
# clock (it keeps counting across controller restarts), `seed` the
# plan seed that makes the schedule reproducible, `target` the victim
# (a worker id, or the torn file's path), `stage` the beat stage a
# controller kill struck at, `offset` the byte offset a torn/truncated
# write stopped at, and `beats` a stall's duration::
#
#     {"schema_version": 1, "type": "chaos", "iter": 12,
#      "wall_time": 1722700000.1, "event": "controller_kill",
#      "seed": 7, "stage": "route", "offset": 113,
#      "reason": "SIGKILL mid-beat between claim and copy"}

CHAOS_EVENTS = ("worker_kill", "controller_kill", "torn_write",
                "socket_drop", "socket_timeout", "heartbeat_stall")

CHAOS_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),            # chaos-plan beat clock
    "wall_time": (_NUM, True),
    "event": (str, True),           # one of CHAOS_EVENTS
    "seed": (int, False),           # plan seed (schedule reproducer)
    "target": (str, False),         # victim worker id / torn file path
    "stage": (str, False),          # controller_kill: beat stage hit
    "offset": (int, False),         # torn write / commit byte offset
    "beats": (int, False),          # heartbeat_stall: beats stalled
    "reason": (str, False),         # human-readable one-liner
}

# --- fault_redraw records (restore fallback announcement) ---
#
# Emitted by Solver.restore when a snapshot PREDATES fault-state
# capture (no .faultstate file next to the .solverstate): the run
# continues with the freshly drawn lifetimes/stuck values from
# construction — the reference's silent re-draw semantics
# (failure_maker.cpp never snapshots fail_iterations_) — and this
# record is the loud trail of that divergence from the
# checkpoint-exact contract::
#
#     {"schema_version": 1, "type": "fault_redraw", "iter": 4000,
#      "wall_time": 1722700000.1,
#      "snapshot": "/runs/q_iter_4000.faultstate",
#      "reason": "snapshot predates fault-state capture (active fault "
#                "process: endurance_stuck_at)",
#      "tiles": "2x2"}
#
# `tiles` (optional) is the active canonical tile-mapping spec: a
# redraw under a non-default grid re-rolls per-(param, tile)
# INDEPENDENT draws — a different experiment from an untiled redraw —
# so the trail names the grid alongside the process stack.

FAULT_REDRAW_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "snapshot": (str, True),    # the .faultstate path that was missing
    "reason": (str, True),
    "tiles": (str, False),      # active canonical tile spec
}

# --- health records (crossbar wear census, observe/health.py) ---
#
# One per `health_every` iterations while the wear telemetry is armed
# (Solver.enable_health / SweepRunner(health_every=)): the per-(param,
# tile) device-health census a SEPARATE small jitted program computes
# over the resident fault state — the train step is untouched, so an
# armed run stays byte-identical on losses and fault state
# (CI-guarded). `params` maps each fault-target key to its per-tile
# stats in tile-major order: `life_hist` counts cells per fixed
# log-spaced remaining-lifetime bin (`life_edges`; bin 0 = (-inf, 0]
# = broken, last bin = beyond the top edge), `broken_frac`/`life_mean`
# /`stuck_neg|zero|pos` the clamp family's wear composition, and
# `age_hist`/`age_mean`/`age_max` (over `age_edges`) the drift-age
# distribution when conductance_drift is in the stack. Under a sweep
# every stat gains a leading per-config axis and `lane_map` attributes
# each column to its config id (same contract as the metrics record),
# so censuses survive self-healing refills. `every` is the census
# cadence, `decrement` the stack's write quantum (what the ledger
# divides lifetime by to get iterations), `process` the canonical
# stack spec, `tiles` the canonical tile-mapping spec::
#
#     {"schema_version": 1, "type": "health", "iter": 400,
#      "wall_time": 1722700000.1, "every": 200, "decrement": 100.0,
#      "process": "endurance_stuck_at", "tiles": "2x2",
#      "life_edges": [100.0, 1000.0, ...], "age_edges": [10.0, ...],
#      "params": {"fc1/0": {"grid": [2, 2], "cells": [64, 64, 64, 64],
#                 "life_hist": [[3, 0, 1, 60, 0, 0, 0, 0, 0], ...],
#                 "broken_frac": [0.05, 0.0, 0.0, 0.0],
#                 "life_mean": [812.5, 900.0, 912.0, 904.1],
#                 "stuck_neg": [1, 0, 0, 0], "stuck_zero": [2, 0, 0, 0],
#                 "stuck_pos": [0, 0, 0, 0]}}}

#: per-param census stats and their nesting depth floor/ceiling:
#: vectors are [T] (single run) or [C][T] (sweep); histograms [T][B]
#: or [C][T][B]. `grid`/`cells` are host geometry — never config-
#: stacked.
HEALTH_STAT_DEPTHS = {
    "life_hist": (2, 3), "broken_frac": (1, 2), "life_mean": (1, 2),
    "stuck_neg": (1, 2), "stuck_zero": (1, 2), "stuck_pos": (1, 2),
    "age_hist": (2, 3), "age_mean": (1, 2), "age_max": (1, 2),
}

HEALTH_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "every": (int, True),
    "decrement": (_NUM, True),
    "process": (str, True),      # canonical fault-process stack spec
    "life_edges": (_NUM, True),  # non-empty list of bin edges
    "tiles": (str, False),       # canonical tile spec (non-default)
    "age_edges": (_NUM, False),  # present when drift is in the stack
    "lane_map": (int, False),    # sweep: config id per lane (-1 idle)
    "params": (dict, True),
}

# --- span records (host-side time spans, observe/spans.py) ---
#
# One per completed tracer span or instant event (SpanTracer
# drain_records): the host-side timing substrate of the sweep/service
# lifecycle — per-chunk dispatch/consume/drain, heal passes,
# checkpoint/snapshot writes, prefetched group builds, serve beats,
# and request lifetimes (linked by `id`). `kind` is "span" (has a
# real duration) or "instant" (a point event: reseed, quarantine, a
# request lifecycle transition — dur_s is 0). `thread` is the thread
# ROLE the event was recorded on (dispatcher / chunk-consumer /
# snapshot-writer / group-prefetch / ...), `process` the JAX process
# index — together the (pid, tid) of the Perfetto export. `wall_time`
# here is the span's START (the tracer's wall-anchored monotonic
# base), unlike the other record types' emission time::
#
#     {"schema_version": 1, "type": "span", "iter": 120,
#      "wall_time": 1722700000.1, "name": "dispatch", "cat": "sweep",
#      "kind": "span", "dur_s": 0.0123, "thread": "dispatcher",
#      "process": 0, "args": {"k": 10}}

SPAN_KINDS = ("span", "instant")

SPAN_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "name": (str, True),
    "cat": (str, True),
    "kind": (str, True),
    "dur_s": (_NUM, True),
    "thread": (str, True),
    "process": (int, True),
    "id": (str, False),       # links events of one entity (request id)
    "args": (dict, False),    # small JSON-scalar annotations
}

# --- sentinel records (tripped numeric-health flags) ---

SENTINEL_PHASES = ("forward", "backward", "update", "fault", "loss")

SENTINEL_FIELDS = {
    "schema_version": (int, True),
    "type": (str, True),
    "iter": (int, True),
    "wall_time": (_NUM, True),
    "phase": (str, True),
    "entry": (str, False),     # absent for phase="loss" explosions
    "nan": (bool, True),
    "inf": (bool, True),
    "overflow": (bool, True),
    "loss": (_NUM, False),
}


def _check_value(val, types):
    """A value matches when it is of the accepted type(s), or a
    NON-EMPTY list of them (a sweep record carries per-config vectors;
    an empty vector is always an emission bug, not data)."""
    if isinstance(val, bool):           # bool is an int subclass in JSON
        return types is bool            # accepted only where asked for
    if isinstance(val, types):
        return True
    if isinstance(val, list):
        return bool(val) and all(
            not isinstance(v, bool) and isinstance(v, types)
            for v in val)
    return False


def _check_fields(rec, fields, where):
    errs = []
    for key, (types, required) in fields.items():
        if key not in rec:
            if required:
                errs.append(f"{where}: missing required field {key!r}")
            continue
        if not _check_value(rec[key], types):
            errs.append(f"{where}: field {key!r} has invalid type "
                        f"{type(rec[key]).__name__}")
    return errs


def _check_iter(rec, where) -> list:
    if isinstance(rec.get("iter"), int) and rec["iter"] < 0:
        return [f"{where}: iter must be >= 0"]
    return []


def _validate_debug_trace(rec) -> list:
    errs = _check_fields(rec, DEBUG_TRACE_FIELDS, "debug_trace")
    errs += _check_iter(rec, "debug_trace")
    for phase in ("forward", "backward"):
        entries = rec.get(phase)
        if not isinstance(entries, list):
            continue
        for i, e in enumerate(entries):
            if not isinstance(e, dict):
                errs.append(f"debug_trace.{phase}[{i}]: not an object")
                continue
            errs += _check_fields(e, DEBUG_BLOB_FIELDS,
                                  f"debug_trace.{phase}[{i}]")
            kind = e.get("kind")
            if isinstance(kind, str) and kind not in DEBUG_KINDS[phase]:
                errs.append(f"debug_trace.{phase}[{i}]: unknown kind "
                            f"{kind!r} (expected one of "
                            f"{DEBUG_KINDS[phase]})")
    entries = rec.get("update")
    if isinstance(entries, list):
        for i, e in enumerate(entries):
            if not isinstance(e, dict):
                errs.append(f"debug_trace.update[{i}]: not an object")
                continue
            errs += _check_fields(e, DEBUG_UPDATE_FIELDS,
                                  f"debug_trace.update[{i}]")
    for key in ("params_l1", "params_l2"):
        pair = rec.get(key)
        if isinstance(pair, list) and (
                len(pair) != 2 or not all(
                    not isinstance(v, bool) and isinstance(v, _NUM)
                    for v in pair)):
            errs.append(f"debug_trace.{key}: expected [data, diff] "
                        "number pair")
    return errs


def _validate_setup(rec) -> list:
    errs = _check_fields(rec, SETUP_FIELDS, "setup")
    cache = rec.get("cache")
    if isinstance(cache, dict):
        errs += _check_fields(cache, SETUP_CACHE_FIELDS, "setup.cache")
        for key in SETUP_CACHE_FIELDS:
            val = cache.get(key)
            if isinstance(val, str) and val not in SETUP_CACHE_STATES:
                errs.append(f"setup.cache.{key}: unknown state {val!r} "
                            f"(expected one of {SETUP_CACHE_STATES})")
    for key in ("decode_seconds", "compile_seconds", "setup_seconds",
                "bytes_per_step_est", "conv_patch_bytes"):
        val = rec.get(key)
        if isinstance(val, _NUM) and not isinstance(val, bool) \
                and val < 0:
            errs.append(f"setup.{key}: must be >= 0")
    fmt = rec.get("fault_state_format")
    if isinstance(fmt, str) and fmt not in FAULT_STATE_FORMATS:
        errs.append(f"setup.fault_state_format: unknown format {fmt!r} "
                    f"(expected one of {FAULT_STATE_FORMATS})")
    shards = rec.get("config_shards")
    if isinstance(shards, int) and not isinstance(shards, bool) \
            and shards < 1:
        errs.append("setup.config_shards: must be >= 1")
    fb = rec.get("engine_fallback_reason")
    if isinstance(fb, str) and not fb:
        errs.append("setup.engine_fallback_reason: must be non-empty "
                    "(omit the field when no fallback happened)")
    cmode = rec.get("conv_im2col")
    if isinstance(cmode, str) and cmode not in CONV_IM2COL_MODES:
        errs.append(f"setup.conv_im2col: unknown mode {cmode!r} "
                    f"(expected one of {CONV_IM2COL_MODES})")
    creason = rec.get("conv_im2col_reason")
    if isinstance(creason, str) and not creason:
        errs.append("setup.conv_im2col_reason: must be non-empty "
                    "(omit the field when there is nothing to say)")
    fm = rec.get("fault_model")
    if isinstance(fm, dict):
        errs += _check_fields(fm, FAULT_MODEL_FIELDS,
                              "setup.fault_model")
        spec = fm.get("spec")
        if isinstance(spec, str) and not spec:
            errs.append("setup.fault_model.spec: must be non-empty")
        procs = fm.get("processes")
        if isinstance(procs, dict):
            for pname, params in procs.items():
                if not isinstance(params, dict):
                    errs.append(f"setup.fault_model.processes"
                                f"[{pname!r}]: not an object")
                    continue
                for k, v in params.items():
                    if isinstance(v, bool) \
                            or not isinstance(v, _NUM + (str,)):
                        errs.append(
                            f"setup.fault_model.processes[{pname!r}]."
                            f"{k}: not a number or string")
    pipe = rec.get("pipeline")
    if isinstance(pipe, dict):
        errs += _check_fields(pipe, PIPELINE_FIELDS, "setup.pipeline")
        for key, (types, _) in PIPELINE_FIELDS.items():
            val = pipe.get(key)
            if isinstance(val, _NUM) and not isinstance(val, bool) \
                    and val < 0:
                errs.append(f"setup.pipeline.{key}: must be >= 0")
    return errs


def _validate_retry(rec) -> list:
    errs = _check_fields(rec, RETRY_FIELDS, "retry")
    errs += _check_iter(rec, "retry")
    event = rec.get("event")
    if isinstance(event, str) and event not in RETRY_EVENTS:
        errs.append(f"retry: unknown event {event!r} "
                    f"(expected one of {RETRY_EVENTS})")
    recovery = rec.get("recovery")
    if isinstance(recovery, str) and recovery not in RETRY_RECOVERIES:
        errs.append(f"retry: unknown recovery {recovery!r} "
                    f"(expected one of {RETRY_RECOVERIES})")
    for key, lo in (("config", 0), ("lane", 0), ("attempt", 1)):
        val = rec.get(key)
        if isinstance(val, int) and not isinstance(val, bool) \
                and val < lo:
            errs.append(f"retry: {key} must be >= {lo}")
    return errs


def _validate_request(rec) -> list:
    errs = _check_fields(rec, REQUEST_FIELDS, "request")
    errs += _check_iter(rec, "request")
    event = rec.get("event")
    if isinstance(event, str) and event not in REQUEST_EVENTS:
        errs.append(f"request: unknown event {event!r} "
                    f"(expected one of {REQUEST_EVENTS})")
    status = rec.get("status")
    if isinstance(status, str) and status not in REQUEST_STATUSES:
        errs.append(f"request: unknown status {status!r} "
                    f"(expected one of {REQUEST_STATUSES})")
    for key in ("request", "tenant"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"request: {key} must be non-empty")
    for key, lo in (("configs", 1), ("done", 0), ("config", 0)):
        val = rec.get(key)
        if isinstance(val, int) and not isinstance(val, bool) \
                and val < lo:
            errs.append(f"request: {key} must be >= {lo}")
    for key in ("latency_s", "queue_s", "projected_s"):
        val = rec.get(key)
        if isinstance(val, _NUM) and not isinstance(val, bool) \
                and val < 0:
            errs.append(f"request: {key} must be >= 0")
    return errs


def _validate_worker(rec) -> list:
    errs = _check_fields(rec, WORKER_FIELDS, "worker")
    errs += _check_iter(rec, "worker")
    event = rec.get("event")
    if isinstance(event, str) and event not in WORKER_EVENTS:
        errs.append(f"worker: unknown event {event!r} "
                    f"(expected one of {WORKER_EVENTS})")
    for key in ("worker", "request", "reason"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"worker: {key} must be non-empty")
    for key in ("lanes", "occupied_lanes", "pending_configs",
                "cache_hits", "cache_misses"):
        val = rec.get(key)
        if isinstance(val, int) and not isinstance(val, bool) \
                and val < 0:
            errs.append(f"worker: {key} must be >= 0")
    swap_s = rec.get("swap_s")
    if isinstance(swap_s, _NUM) and not isinstance(swap_s, bool) \
            and swap_s < 0:
        errs.append("worker: swap_s must be >= 0")
    pinned = rec.get("pinned")
    if isinstance(pinned, dict):
        for k, v in pinned.items():
            if not isinstance(v, str) or not v:
                errs.append(f"worker: pinned[{k!r}] must be a "
                            "non-empty string")
    return errs


def _validate_alert(rec) -> list:
    errs = _check_fields(rec, ALERT_FIELDS, "alert")
    errs += _check_iter(rec, "alert")
    event = rec.get("event")
    if isinstance(event, str) and event not in ALERT_EVENTS:
        errs.append(f"alert: unknown event {event!r} "
                    f"(expected one of {ALERT_EVENTS})")
    severity = rec.get("severity")
    if isinstance(severity, str) and severity not in ALERT_SEVERITIES:
        errs.append(f"alert: unknown severity {severity!r} "
                    f"(expected one of {ALERT_SEVERITIES})")
    for key in ("alert", "metric", "worker", "reason"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"alert: {key} must be non-empty")
    for_beats = rec.get("for_beats")
    if isinstance(for_beats, int) and not isinstance(for_beats, bool) \
            and for_beats < 1:
        errs.append("alert: for_beats must be >= 1")
    return errs


def _validate_chaos(rec) -> list:
    errs = _check_fields(rec, CHAOS_FIELDS, "chaos")
    errs += _check_iter(rec, "chaos")
    event = rec.get("event")
    if isinstance(event, str) and event not in CHAOS_EVENTS:
        errs.append(f"chaos: unknown event {event!r} "
                    f"(expected one of {CHAOS_EVENTS})")
    for key in ("target", "stage", "reason"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"chaos: {key} must be non-empty")
    for key, lo in (("seed", 0), ("offset", 0), ("beats", 1)):
        val = rec.get(key)
        if isinstance(val, int) and not isinstance(val, bool) \
                and val < lo:
            errs.append(f"chaos: {key} must be >= {lo}")
    return errs


def _validate_fault_redraw(rec) -> list:
    errs = _check_fields(rec, FAULT_REDRAW_FIELDS, "fault_redraw")
    errs += _check_iter(rec, "fault_redraw")
    for key in ("snapshot", "reason"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"fault_redraw: {key} must be non-empty")
    return errs


def _nested_numbers(val, lo: int, hi: int) -> bool:
    """A health stat: a NON-EMPTY list nested between `lo` and `hi`
    levels deep whose leaves are all numbers (the census never emits
    an empty tile/config axis — that is an emission bug, not data).
    Sibling elements must agree on being lists or leaves."""
    if hi == 0:
        return not isinstance(val, bool) and isinstance(val, _NUM)
    if not isinstance(val, list) or not val:
        return (lo <= 0 and not isinstance(val, bool)
                and isinstance(val, _NUM))
    if any(isinstance(v, list) for v in val):
        return all(isinstance(v, list)
                   and _nested_numbers(v, lo - 1, hi - 1)
                   for v in val)
    return lo <= 1 and all(not isinstance(v, bool)
                           and isinstance(v, _NUM) for v in val)


def _validate_health(rec) -> list:
    errs = _check_fields(rec, HEALTH_FIELDS, "health")
    errs += _check_iter(rec, "health")
    every = rec.get("every")
    if isinstance(every, int) and not isinstance(every, bool) \
            and every < 1:
        errs.append("health: every must be >= 1")
    dec = rec.get("decrement")
    if isinstance(dec, _NUM) and not isinstance(dec, bool) and dec <= 0:
        errs.append("health: decrement must be > 0")
    for key in ("process", "tiles"):
        val = rec.get(key)
        if isinstance(val, str) and not val:
            errs.append(f"health: {key} must be non-empty")
    for key in ("life_edges", "age_edges"):
        val = rec.get(key)
        if val is not None and not _nested_numbers(val, 1, 1):
            errs.append(f"health: {key} must be a non-empty list of "
                        "numbers")
    lmap = rec.get("lane_map")
    if lmap is not None:
        vals = lmap if isinstance(lmap, list) else [lmap]
        if any(isinstance(v, int) and not isinstance(v, bool)
               and v < -1 for v in vals):
            errs.append("health: lane_map config ids must be >= -1")
    params = rec.get("params")
    if isinstance(params, dict):
        if not params:
            errs.append("health: params must be non-empty")
        for name, entry in params.items():
            where = f"health.params[{name!r}]"
            if not isinstance(entry, dict):
                errs.append(f"{where}: not an object")
                continue
            grid = entry.get("grid")
            if not (isinstance(grid, list) and len(grid) == 2
                    and all(isinstance(g, int)
                            and not isinstance(g, bool) and g >= 1
                            for g in grid)):
                errs.append(f"{where}.grid: expected [rows, cols] "
                            ">= 1 each")
            cells = entry.get("cells")
            if not (isinstance(cells, list) and cells
                    and all(isinstance(c, int)
                            and not isinstance(c, bool) and c >= 1
                            for c in cells)):
                errs.append(f"{where}.cells: expected a non-empty "
                            "list of cell counts >= 1")
            stats = 0
            for key, val in entry.items():
                if key in ("grid", "cells"):
                    continue
                depths = HEALTH_STAT_DEPTHS.get(key)
                if depths is None:
                    errs.append(f"{where}.{key}: unknown census stat")
                    continue
                stats += 1
                if not _nested_numbers(val, *depths):
                    errs.append(
                        f"{where}.{key}: expected numbers nested "
                        f"{depths[0]}-{depths[1]} lists deep")
            if not stats:
                errs.append(f"{where}: carries no census stat")
    return errs


def _validate_span(rec) -> list:
    errs = _check_fields(rec, SPAN_FIELDS, "span")
    errs += _check_iter(rec, "span")
    kind = rec.get("kind")
    if isinstance(kind, str) and kind not in SPAN_KINDS:
        errs.append(f"span: unknown kind {kind!r} "
                    f"(expected one of {SPAN_KINDS})")
    for key in ("name", "cat", "thread", "id"):
        val = rec.get(key)
        if isinstance(val, str) and not val and (key != "id"
                                                 or "id" in rec):
            errs.append(f"span: {key} must be non-empty")
    dur = rec.get("dur_s")
    if isinstance(dur, _NUM) and not isinstance(dur, bool) and dur < 0:
        errs.append("span: dur_s must be >= 0")
    if isinstance(kind, str) and kind == "instant" \
            and isinstance(dur, _NUM) and not isinstance(dur, bool) \
            and dur != 0:
        errs.append("span: an instant event must have dur_s == 0")
    proc = rec.get("process")
    if isinstance(proc, int) and not isinstance(proc, bool) and proc < 0:
        errs.append("span: process must be >= 0")
    args = rec.get("args")
    if isinstance(args, dict):
        for k, v in args.items():
            if v is not None and not isinstance(v, (str, bool)) \
                    and not isinstance(v, _NUM):
                errs.append(f"span: args[{k!r}] must be a JSON scalar")
    return errs


def _validate_sentinel(rec) -> list:
    errs = _check_fields(rec, SENTINEL_FIELDS, "sentinel")
    errs += _check_iter(rec, "sentinel")
    phase = rec.get("phase")
    if isinstance(phase, str) and phase not in SENTINEL_PHASES:
        errs.append(f"sentinel: unknown phase {phase!r} "
                    f"(expected one of {SENTINEL_PHASES})")
    return errs


def _check_version(rec) -> list:
    if rec.get("schema_version") not in (None, SCHEMA_VERSION):
        return [f"record: schema_version {rec['schema_version']!r} "
                f"!= {SCHEMA_VERSION}"]
    return []


def validate_record(rec) -> list:
    """Return a list of schema violations (empty = valid)."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    rtype = rec.get("type")
    if rtype == "debug_trace":
        return _check_version(rec) + _validate_debug_trace(rec)
    if rtype == "sentinel":
        return _check_version(rec) + _validate_sentinel(rec)
    if rtype == "setup":
        return _check_version(rec) + _validate_setup(rec)
    if rtype == "retry":
        return _check_version(rec) + _validate_retry(rec)
    if rtype == "request":
        return _check_version(rec) + _validate_request(rec)
    if rtype == "fault_redraw":
        return _check_version(rec) + _validate_fault_redraw(rec)
    if rtype == "worker":
        return _check_version(rec) + _validate_worker(rec)
    if rtype == "alert":
        return _check_version(rec) + _validate_alert(rec)
    if rtype == "chaos":
        return _check_version(rec) + _validate_chaos(rec)
    if rtype == "health":
        return _check_version(rec) + _validate_health(rec)
    if rtype == "span":
        return _check_version(rec) + _validate_span(rec)
    if rtype is not None:
        return [f"record: unknown record type {rtype!r}"]
    errs = _check_fields(rec, TOP_LEVEL, "record")
    errs += _check_version(rec)
    errs += _check_iter(rec, "record")
    outs = rec.get("outputs")
    if isinstance(outs, dict):
        for name, v in outs.items():
            if not _check_value(v, _NUM):
                errs.append(f"outputs[{name!r}]: not a number (or list)")
    quar = rec.get("quarantine")
    if quar is not None:
        vals = quar if isinstance(quar, list) else [quar]
        if any(isinstance(v, int) and not isinstance(v, bool) and v < 0
               for v in vals):
            errs.append("quarantine: config indices must be >= 0")
    lmap = rec.get("lane_map")
    if lmap is not None:
        vals = lmap if isinstance(lmap, list) else [lmap]
        if any(isinstance(v, int) and not isinstance(v, bool) and v < -1
               for v in vals):
            errs.append("lane_map: config ids must be >= -1 "
                        "(-1 marks an idle lane)")
    fault = rec.get("fault")
    if isinstance(fault, dict):
        errs += _check_fields(fault, FAULT_FIELDS, "fault")
        per = fault.get("per_param")
        if isinstance(per, dict):
            for key, entry in per.items():
                if not isinstance(entry, dict):
                    errs.append(f"fault.per_param[{key!r}]: not an object")
                    continue
                errs += _check_fields(entry, PER_PARAM_FIELDS,
                                      f"fault.per_param[{key!r}]")
        pp = fault.get("per_process")
        if isinstance(pp, dict):
            for pname, entry in pp.items():
                if not isinstance(entry, dict) or not entry:
                    errs.append(f"fault.per_process[{pname!r}]: not a "
                                "non-empty object of counters")
                    continue
                for cname, v in entry.items():
                    if not _check_value(v, _NUM):
                        errs.append(
                            f"fault.per_process[{pname!r}].{cname}: "
                            "not a number (or per-config list)")
        pt = fault.get("per_tile")
        if isinstance(pt, dict):
            for key, entry in pt.items():
                if not isinstance(entry, dict):
                    errs.append(f"fault.per_tile[{key!r}]: not an "
                                "object")
                    continue
                errs += _check_fields(entry, PER_TILE_FIELDS,
                                      f"fault.per_tile[{key!r}]")
    return errs
