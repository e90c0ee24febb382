"""Host-side metric sinks: a JSONL writer and a Caffe-format text
emitter (counterpart of the reference package's observe/sink.py).

The logger is a plain registry: `MetricsLogger([sink, ...]).log(record)`
fans a record out to every sink. Records are built with `make_record`,
`make_setup_record`, `make_health_record`, `make_retry_record` and
`make_fault_redraw_record` (schema.py documents the shapes) and are
plain dicts of Python scalars, so any sink is a few lines.

`CaffeLogSink` emits glog-prefixed lines with the shapes the reference
solver printed ("Iteration N, lr = X", "Iteration N, loss = X", "    Train
net output #j: name = v", after a timestamped "Solving <net>" banner), so
the Caffe log tools scrape it unchanged; `setup`, `span`, `health`,
`retry`, `fault_redraw` and `sentinel` records become one line each, and a
`debug_trace` record the reference's `debug_info` lines
(`debug_trace_lines`).
"""
from __future__ import annotations

import atexit
import datetime
import json
import os
import time
import weakref
from typing import Optional

from .schema import SCHEMA_VERSION


def make_record(iteration: int, metrics: Optional[dict] = None,
                smoothed_loss: Optional[float] = None,
                outputs: Optional[dict] = None,
                elapsed_s: Optional[float] = None, n_iters: int = 1,
                seed: Optional[int] = None,
                quarantine=None, lane_map=None) -> dict:
    """Assemble one schema-versioned record from the host copy of the
    step's metrics and host timing. `elapsed_s` spans the `n_iters`
    iterations since the previous record (the first interval includes
    the kernels' build: the wall time the user waited). `quarantine`
    (sweep records, only when non-empty) lists the lanes whose updates
    the quarantine has frozen; `lane_map` the config each lane holds."""
    metrics = dict(metrics or {})
    fault = metrics.pop("fault", None)
    rec = {
        "schema_version": SCHEMA_VERSION,
        "iter": int(iteration),
        "wall_time": time.time(),
        "loss": metrics.pop("loss", smoothed_loss),
        "lr": metrics.pop("lr", 0.0),
        "step_latency_s": (elapsed_s / max(n_iters, 1)
                           if elapsed_s is not None else 0.0),
        "iters_per_s": (max(n_iters, 1) / elapsed_s
                        if elapsed_s else 0.0),
    }
    if smoothed_loss is not None:
        rec["smoothed_loss"] = float(smoothed_loss)
    if seed is not None:
        rec["seed"] = int(seed)
    for key in ("grad_norm", "update_norm"):
        if key in metrics:
            rec[key] = metrics.pop(key)
    if outputs:
        rec["outputs"] = dict(outputs)
    if quarantine:
        rec["quarantine"] = [int(i) for i in quarantine]
    if lane_map is not None:
        rec["lane_map"] = [int(i) for i in lane_map]
    if fault is not None:
        rec["fault"] = fault
    return rec


def make_health_record(iteration: int, params: dict, process: str,
                       every: int, decrement: float,
                       life_edges, age_edges=None,
                       tiles: Optional[str] = None,
                       lane_map=None) -> dict:
    """One crossbar wear census (schema.py HEALTH_FIELDS): `params` is
    the census payload ({param: {"grid", "cells", per-tile stats}}),
    `process` the fault process's canonical spec, `every` the census
    cadence, `decrement` its write quantum, `life_edges`/`age_edges`
    the fixed bin layouts, `tiles` the canonical tile spec (omitted
    for the default 1x1), `lane_map` the sweep's config per lane."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "type": "health",
        "iter": int(iteration),
        "wall_time": time.time(),
        "every": int(every),
        "decrement": float(decrement),
        "process": str(process),
        "life_edges": [float(e) for e in life_edges],
        "params": params,
    }
    if age_edges is not None:
        rec["age_edges"] = [float(e) for e in age_edges]
    if tiles is not None:
        rec["tiles"] = str(tiles)
    if lane_map is not None:
        rec["lane_map"] = [int(i) for i in lane_map]
    return rec


def make_retry_record(iteration: int, config: int, lane: int,
                      attempt: int, event: str,
                      recovery: Optional[str] = None,
                      eligible_iter: Optional[int] = None,
                      diagnosis: Optional[str] = None) -> dict:
    """One self-healing lane event (schema.py RETRY_FIELDS): `event` is
    "requeue" (attempt voided, config back on the queue), "reseed" (lane
    refilled; `recovery` "checkpoint" or "fresh") or "failed" (retries
    exhausted; `diagnosis` names the first bad iteration, phase and
    layer)."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "type": "retry",
        "iter": int(iteration),
        "wall_time": time.time(),
        "config": int(config),
        "lane": int(lane),
        "attempt": int(attempt),
        "event": str(event),
    }
    if recovery is not None:
        rec["recovery"] = str(recovery)
    if eligible_iter is not None:
        rec["eligible_iter"] = int(eligible_iter)
    if diagnosis is not None:
        rec["diagnosis"] = str(diagnosis)
    return rec


def retry_line(record: dict) -> str:
    """One-line text form of a `retry` record."""
    event = record.get("event")
    head = (f"Sweep retry: config {record.get('config')} "
            f"(lane {record.get('lane')}, attempt "
            f"{record.get('attempt')})")
    it = record.get("iter")
    if event == "requeue":
        tail = f" re-queued after quarantine at iteration {it}"
        if "eligible_iter" in record:
            tail += f"; eligible at iteration {record['eligible_iter']}"
    elif event == "reseed":
        tail = (f" re-seeded at iteration {it} "
                f"({record.get('recovery', 'fresh')} recovery)")
    else:
        tail = f" permanently failed at iteration {it}"
        if record.get("diagnosis"):
            tail += f": {record['diagnosis']}"
    return head + tail


def make_fault_redraw_record(iteration: int, snapshot: str,
                             reason: str,
                             tiles: Optional[str] = None) -> dict:
    """The restore-fallback announcement (schema.py
    FAULT_REDRAW_FIELDS): a snapshot with no fault-state file resumed
    with the construction-time fresh draw. `tiles` is the active
    canonical tile spec (a redraw under a non-default grid re-rolls
    every tile's draw)."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "type": "fault_redraw",
        "iter": int(iteration),
        "wall_time": time.time(),
        "snapshot": str(snapshot),
        "reason": str(reason),
    }
    if tiles is not None:
        rec["tiles"] = str(tiles)
    return rec


def fault_redraw_line(record: dict) -> str:
    """One-line text form of a `fault_redraw` record."""
    tiles = ""
    if record.get("tiles"):
        tiles = f" under tile mapping {record['tiles']}"
    return (f"Fault state RE-DRAWN at iteration {record.get('iter')}"
            f"{tiles}: {record.get('reason')} (expected "
            f"{record.get('snapshot')}); resumed degradation will NOT "
            "match the pre-snapshot trajectory")


def _flat_max(v):
    """Max leaf of a nested census stat (number or nested lists)."""
    if isinstance(v, list):
        vals = [_flat_max(x) for x in v]
        return max(vals) if vals else 0.0
    return v


def health_line(record: dict) -> str:
    """One-line text form of a `health` record: the worst tile's
    broken fraction across every param — the census headline a text
    log can carry without the histograms."""
    params = record.get("params") or {}
    worst, where = 0.0, "?"
    for name, st in params.items():
        bf = _flat_max(st.get("broken_frac", 0.0)) \
            if isinstance(st, dict) else 0.0
        if bf >= worst:
            worst, where = bf, name
    tiles = f", tiles {record['tiles']}" if record.get("tiles") else ""
    return (f"Health census at iteration {record.get('iter')}: "
            f"{len(params)} param(s){tiles}, worst tile broken "
            f"fraction {worst:g} ({where})")


def make_setup_record(decode_s: float, compile_s: float,
                      compile_status: str, dataset_status: str,
                      setup_s: Optional[float] = None,
                      pipeline: Optional[dict] = None,
                      bytes_per_step_est: Optional[int] = None,
                      fault_state_format: Optional[str] = None,
                      fault_model: Optional[dict] = None,
                      engine: Optional[str] = None,
                      engine_fallback_reason: Optional[str] = None,
                      conv_im2col: Optional[str] = None,
                      conv_im2col_reason: Optional[str] = None,
                      conv_patch_bytes: Optional[int] = None) -> dict:
    """One `setup` record per runner (schema.py): the decode/compile
    split of the setup wall clock and each cache's state. `setup_s` is
    the caller's total setup wall time. `pipeline` is
    async_exec.PipelineStats.record(); `bytes_per_step_est` and
    `fault_state_format` ("f32" | "packed") the resident-state traffic
    fields; `fault_model` the fault process ({"spec": ...}); `engine`
    the engine that ran ("cuda" | "torch", a field the schema leaves
    undeclared) and `engine_fallback_reason` why the requested engine
    launches no crossbar kernel; `conv_im2col`, `conv_im2col_reason` and
    `conv_patch_bytes` the resolved conv operand mode of a tiled-conv
    sweep."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "type": "setup",
        "wall_time": time.time(),
        "decode_seconds": round(float(decode_s), 4),
        "compile_seconds": round(float(compile_s), 4),
        "cache": {"compile": compile_status, "dataset": dataset_status},
    }
    if setup_s is not None:
        rec["setup_seconds"] = round(float(setup_s), 4)
    if pipeline:
        rec["pipeline"] = dict(pipeline)
    if bytes_per_step_est is not None:
        rec["bytes_per_step_est"] = int(bytes_per_step_est)
    if fault_state_format is not None:
        rec["fault_state_format"] = str(fault_state_format)
    if fault_model is not None:
        rec["fault_model"] = dict(fault_model)
    if engine is not None:
        rec["engine"] = str(engine)
    if engine_fallback_reason:
        rec["engine_fallback_reason"] = str(engine_fallback_reason)
    if conv_im2col is not None:
        rec["conv_im2col"] = str(conv_im2col)
    if conv_im2col_reason is not None:
        rec["conv_im2col_reason"] = str(conv_im2col_reason)
    if conv_patch_bytes is not None:
        rec["conv_patch_bytes"] = int(conv_patch_bytes)
    return rec


def setup_line(record: dict) -> str:
    """One-line text form of a `setup` record."""
    cache = record.get("cache", {})
    extra = (f", total {record['setup_seconds']:g} s"
             if "setup_seconds" in record else "")
    pipe = record.get("pipeline")
    ptail = ""
    if pipe:
        ptail = (f"; pipeline depth {pipe.get('depth', 0)}: host blocked "
                 f"{pipe.get('host_blocked_seconds', 0):g} s over "
                 f"{pipe.get('chunks', 0)} chunks")
    fm = record.get("fault_model")
    ftail = ""
    if isinstance(fm, dict) and fm.get("spec"):
        ftail = f"; fault model {fm['spec']}"
    bypassed = record.get("tiles_bypassed")
    if bypassed:
        ftail += ("; tiles bypassed: "
                  + ", ".join(str(n) for n in bypassed))
    return (f"Setup: decode {record.get('decode_seconds', 0):g} s, "
            f"compile {record.get('compile_seconds', 0):g} s{extra} "
            f"(compile cache {cache.get('compile', '?')}, "
            f"dataset cache {cache.get('dataset', '?')})" + ptail
            + ftail)


class MetricsLogger:
    """Sink registry. Every `log(record)` fans out to all sinks; sinks
    are closed (flushed) by `close` — call it when the run ends."""

    def __init__(self, sinks=()):
        self.sinks = list(sinks)

    def add(self, sink):
        self.sinks.append(sink)
        return sink

    def log(self, record: dict):
        for s in self.sinks:
            s.write(record)

    def close(self):
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close:
                close()


def _register_atexit_flush(sink):
    """Crash-post-mortem guard for the buffered file sinks: an
    unhandled exception unwinds past every `close()` call, and up to
    `flush_every - 1` tail records — the beats right before the crash,
    exactly the ones a post-mortem needs — would die in the userspace
    buffer. `atexit` handlers run on interpreter exit even after an
    unhandled exception, so each sink registers a weakly-bound flush
    (a weakref: the registry must not keep closed sinks alive for the
    process lifetime) and unregisters it on `close()`. Returns the
    callback so `close()` can unregister."""
    ref = weakref.ref(sink)

    def _flush_at_exit():
        s = ref()
        if s is None:
            return
        try:
            s.flush()
        except Exception:
            pass   # the interpreter is dying; best effort only

    atexit.register(_flush_at_exit)
    return _flush_at_exit


class _FlushPolicy:
    """Buffered-write policy shared by the file sinks: flush after
    `flush_every` records, or once `flush_secs` seconds have passed
    since the last flush — whichever comes first. A per-record flush
    stalls the consumer thread of the async sweep pipeline on filesystem
    latency, so buffering is the default; `unbuffered=True` restores
    flush-per-record (the `tail -f` debugging escape hatch). `close`
    always flushes regardless of policy."""

    def __init__(self, unbuffered: bool = False, flush_every: int = 64,
                 flush_secs: float = 5.0):
        self.unbuffered = bool(unbuffered)
        self.flush_every = max(int(flush_every), 1)
        self.flush_secs = float(flush_secs)
        self._pending = 0
        self._last = time.monotonic()

    def due(self) -> bool:
        """Count one record; True when the sink should flush now."""
        if self.unbuffered:
            return True
        self._pending += 1
        now = time.monotonic()
        if (self._pending >= self.flush_every
                or now - self._last >= self.flush_secs):
            return True
        return False

    def flushed(self):
        self._pending = 0
        self._last = time.monotonic()


class JsonlSink:
    """One JSON object per line per display interval (schema.py).
    `append=True` continues an existing log (a resumed run must not
    truncate the degradation trajectory already captured). Writes are
    buffered per `_FlushPolicy` (flush every `flush_every` records or
    `flush_secs` seconds; `unbuffered=True` for flush-per-record)."""

    def __init__(self, path: str, append: bool = False,
                 unbuffered: bool = False, flush_every: int = 64,
                 flush_secs: float = 5.0):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._policy = _FlushPolicy(unbuffered, flush_every, flush_secs)
        if not append:
            # truncate, then reopen in APPEND mode: every write lands
            # at the file's current end, so several sinks alternating
            # on one stream never overwrite each other's records
            open(path, "w").close()
        self._f = open(path, "a")
        self._atexit_cb = _register_atexit_flush(self)

    def write(self, record: dict):
        self._f.write(json.dumps(record) + "\n")
        if self._policy.due():
            self._f.flush()
            self._policy.flushed()

    def flush(self):
        if not self._f.closed:
            self._f.flush()
            self._policy.flushed()

    def close(self):
        atexit.unregister(self._atexit_cb)
        if not self._f.closed:
            self._f.close()


def _scalar(v):
    """The Caffe line shape is inherently scalar; a sweep record's
    per-config vector (schema-legal) is emitted as its mean."""
    if isinstance(v, list):
        return sum(v) / len(v) if v else 0.0
    return v


def _span_line(record: dict) -> str:
    from .spans import span_line
    return span_line(record)


def debug_trace_lines(record: dict) -> list:
    """The reference's `debug_info` lines of a `debug_trace` record
    (net.cpp:618-668 ForwardDebugInfo / BackwardDebugInfo /
    UpdateDebugInfo and Net::Backward's all-params totals): the solver
    prints them, `CaffeLogSink` writes them glog-prefixed."""
    lines = []
    for e in record.get("forward", ()):
        kind = "top blob" if e["kind"] == "top" else "param blob"
        lines.append(f"    [Forward] Layer {e['layer']}, {kind} "
                     f"{e['blob']} data: {e['value']:g}")
    for e in record.get("backward", ()):
        kind = "bottom blob" if e["kind"] == "bottom" else "param blob"
        lines.append(f"    [Backward] Layer {e['layer']}, {kind} "
                     f"{e['blob']} diff: {e['value']:g}")
    l1 = record.get("params_l1", (0.0, 0.0))
    l2 = record.get("params_l2", (0.0, 0.0))
    lines.append(f"    [Backward] All net params (data, diff): "
                 f"L1 norm = ({l1[0]:g}, {l1[1]:g}); "
                 f"L2 norm = ({l2[0]:g}, {l2[1]:g})")
    for e in record.get("update", ()):
        lines.append(f"    [Update] Layer {e['layer']}, param "
                     f"{e['param']} data: {e['data']:g}; "
                     f"diff: {e['diff']:g}")
    return lines


def sentinel_line(record: dict) -> str:
    """One-line text form of a `sentinel` record."""
    flags = ", ".join(f for f in ("nan", "inf", "overflow")
                      if record.get(f))
    where = record.get("entry") or record.get("phase", "?")
    return (f"Numeric sentinel tripped at iteration {record['iter']}: "
            f"{record.get('phase')} phase, {where} [{flags or 'loss'}]")


class CaffeLogSink:
    """Caffe/glog-format text emitter (see module docstring). The banner
    and every line carry a glog timestamp prefix so elapsed-seconds
    extraction works; the reference binary's own logs parse with the
    identical regexes."""

    def __init__(self, path: str, net_name: str = "net",
                 append: bool = False, unbuffered: bool = False,
                 flush_every: int = 64, flush_secs: float = 5.0):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._policy = _FlushPolicy(unbuffered, flush_every, flush_secs)
        had_content = append and os.path.exists(path) \
            and os.path.getsize(path) > 0
        if not append:
            # truncate + reopen append, like JsonlSink: several sinks
            # alternating on one stream must never resume a positioned
            # "w" handle over records another sink appended
            open(path, "w").close()
        self._f = open(path, "a")
        self._atexit_cb = _register_atexit_flush(self)
        if not had_content:
            # one banner per log: extract_seconds measures elapsed time
            # from the FIRST 'Solving' line, so a resumed segment keeps
            # the original solve start
            self._emit(f"Solving {net_name}")
            self._f.flush()

    def _emit(self, line: str):
        now = datetime.datetime.now()
        prefix = ("I%02d%02d %02d:%02d:%02d.%06d %5d solver.py:0] "
                  % (now.month, now.day, now.hour, now.minute, now.second,
                     now.microsecond, os.getpid()))
        self._f.write(prefix + line + "\n")

    def _maybe_flush(self):
        # buffered like JsonlSink (same policy knobs): one record = one
        # policy tick, however many glog lines it rendered to
        if self._policy.due():
            self._f.flush()
            self._policy.flushed()

    def write(self, record: dict):
        rtype = record.get("type")
        if rtype == "debug_trace":
            for text in debug_trace_lines(record):
                self._emit(text)
            self._maybe_flush()
            return
        line = {"setup": setup_line, "health": health_line,
                "span": _span_line, "retry": retry_line,
                "fault_redraw": fault_redraw_line,
                "sentinel": sentinel_line}.get(rtype)
        if line is not None:
            self._emit(line(record))
            self._maybe_flush()
            return
        if rtype is not None:
            return  # other typed records are not Caffe-shaped; skip
        it = record["iter"]
        lr = _scalar(record.get("lr", 0.0))
        loss = _scalar(record.get("smoothed_loss",
                                  record.get("loss", 0.0)))
        self._emit(f"Iteration {it}, lr = {lr:g}")
        self._emit(f"Iteration {it}, loss = {loss:g}")
        j = 0
        for name, v in (record.get("outputs") or {}).items():
            vals = v if isinstance(v, list) else [v]
            for x in vals:
                self._emit(f"    Train net output #{j}: {name} = {x:g}")
                j += 1
        quar = record.get("quarantine")
        if quar:
            # extra line, deliberately shaped unlike any reference line
            # so parse_log/extract_seconds regexes skip it unchanged
            ids = quar if isinstance(quar, list) else [quar]
            self._emit("    Quarantined configs: "
                       + ", ".join(str(int(i)) for i in ids))
        self._maybe_flush()

    def flush(self):
        if not self._f.closed:
            self._f.flush()
            self._policy.flushed()

    def close(self):
        atexit.unregister(self._atexit_cb)
        if not self._f.closed:
            self._f.close()
