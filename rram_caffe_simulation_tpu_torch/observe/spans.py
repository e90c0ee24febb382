"""Host-side span tracer: wall-clock spans of the sweep's lifecycle
(counterpart of the reference package's observe/spans.py).

- `SpanTracer`: `begin`/`end`, a context-manager `span()`, `complete()`
  for a caller-timed section and `instant()` point events. Thread-safe
  and ring-buffered (a bounded deque: overflow drops the oldest events
  and counts them in `dropped`), clocked by `time.perf_counter`
  durations anchored to one wall-clock epoch taken at construction.
- Two exports: schema-validated `span` JSONL records (`drain_records()`,
  an incremental cursor, so the sweep drains at every step() return
  into the metric sinks without re-emitting) and a Chrome-trace JSON
  file (`write_chrome_trace()`), pid = the process index, tid = the
  thread role (dispatcher / chunk-consumer / snapshot-writer), which
  Perfetto and chrome://tracing load beside a `torch.profiler` trace.
- `phase_breakdown()` (seconds per span name) and
  `bench_phase_breakdown()` (dispatch / host-blocked / consumer /
  checkpoint seconds).

Stdlib only, like schema.py. Spans are host observations: with no
tracer armed the instrumented sites emit nothing, and arming one changes
no result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .schema import SCHEMA_VERSION

#: default ring capacity: ~64k events ≈ a few MB of host dicts; a
#: chunked sweep emits a handful of spans per chunk, so this covers
#: hours of steady-state before the ring wraps
DEFAULT_CAPACITY = 65536


class _OpenSpan:
    """Token returned by `begin()`, closed by `end()` (or the `span()`
    context manager). Not buffered until closed."""

    __slots__ = ("name", "cat", "iter", "args", "t0_wall", "t0_perf",
                 "thread")

    def __init__(self, name, cat, iteration, args, t0_wall, t0_perf,
                 thread):
        self.name = name
        self.cat = cat
        self.iter = iteration
        self.args = args
        self.t0_wall = t0_wall
        self.t0_perf = t0_perf
        self.thread = thread


class SpanTracer:
    """Ring-buffered, thread-safe span collector (module docstring).

    Every completed span / instant is one small host dict; `events()`
    snapshots them, `drain_records()` converts the not-yet-drained
    suffix into schema-validated `span` JSONL records, and
    `write_chrome_trace()` renders the whole ring as a Chrome-trace
    JSON object. `process_index` is plain data the caller provides (0
    for a single-process sweep)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 process_index: int = 0,
                 process_name: Optional[str] = None):
        self.capacity = max(int(capacity), 1)
        self.process_index = int(process_index)
        self.process_name = (process_name
                             or f"sweep p{self.process_index}")
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dropped = 0          # events the ring overwrote
        self._seq = 0             # monotone event id (drain cursor)
        self._drained = 0         # last seq drain_records() emitted
        #: explicit thread-role overrides (ident -> role); threads
        #: without one report their threading name (the consumer /
        #: writer / prefetch threads are already usefully named)
        self._roles: Dict[int, str] = {}
        #: open async spans: (cat, name, id) -> begin info
        self._async: Dict[tuple, dict] = {}
        # ONE wall anchor + a perf_counter origin: positions on the
        # timeline are wall-epoch-based (processes of a pod share the
        # host clock and merge cleanly), durations are perf_counter
        # deltas (immune to wall-clock steps)
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # ------------------------------------------------------------------
    # clocks / threads

    def _now(self) -> float:
        """Wall-epoch seconds on the tracer's monotonic time base."""
        return self._wall0 + (time.perf_counter() - self._perf0)

    def set_thread_role(self, role: str):
        """Name the CALLING thread's track in the exported timeline
        (e.g. "dispatcher"). Threads without an explicit role report
        their `threading` name — the pipeline's worker threads
        ("chunk-consumer", "snapshot-writer", "group-prefetch") are
        already named for this."""
        with self._lock:
            self._roles[threading.get_ident()] = str(role)

    def _thread_role(self) -> str:
        role = self._roles.get(threading.get_ident())
        if role is not None:
            return role
        t = threading.current_thread()
        return ("main" if t is threading.main_thread() else t.name)

    # ------------------------------------------------------------------
    # emission

    def _append(self, ev: dict):
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    def begin(self, name: str, cat: str = "sweep", iteration: int = 0,
              args: Optional[dict] = None) -> _OpenSpan:
        """Open a span on the calling thread; close it with `end()`.
        Nothing is buffered until the span closes."""
        return _OpenSpan(str(name), str(cat), int(iteration), args,
                         self._now(), time.perf_counter(),
                         self._thread_role())

    def end(self, token: _OpenSpan, args: Optional[dict] = None):
        """Close a `begin()` token; the completed span enters the
        ring. Extra `args` merge over the begin-time ones."""
        dur = time.perf_counter() - token.t0_perf
        merged = token.args
        if args:
            merged = dict(merged or {}, **args)
        self._append({
            "kind": "span", "name": token.name, "cat": token.cat,
            "t": token.t0_wall, "dur": max(dur, 0.0),
            "thread": token.thread, "iter": token.iter,
            "args": merged})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "sweep", iteration: int = 0,
             args: Optional[dict] = None):
        """`with tracer.span("dispatch", iteration=it): ...`"""
        token = self.begin(name, cat, iteration, args)
        try:
            yield token
        finally:
            self.end(token)

    def complete(self, name: str, dur_s: float, cat: str = "sweep",
                 iteration: int = 0, args: Optional[dict] = None):
        """Record a span that ENDED NOW with a caller-measured
        duration — for sections timed with their own perf_counter
        pair (e.g. a measured submit-backpressure wait)."""
        dur = max(float(dur_s), 0.0)
        self._append({
            "kind": "span", "name": str(name), "cat": str(cat),
            "t": self._now() - dur, "dur": dur,
            "thread": self._thread_role(), "iter": int(iteration),
            "args": args})

    def instant(self, name: str, cat: str = "sweep", iteration: int = 0,
                id: Optional[str] = None, args: Optional[dict] = None):
        """A zero-duration point event (healing reseed, quarantine,
        a request lifecycle transition). `id` links instants of one
        logical entity (the request id)."""
        ev = {"kind": "instant", "name": str(name), "cat": str(cat),
              "t": self._now(), "dur": 0.0,
              "thread": self._thread_role(), "iter": int(iteration),
              "args": args}
        if id is not None:
            ev["id"] = str(id)
        self._append(ev)

    def async_begin(self, name: str, id: str, cat: str = "request",
                    iteration: int = 0, args: Optional[dict] = None):
        """Open a long-lived span keyed by (cat, name, id) — e.g. a
        serve request from submit to terminal, spanning many beats and
        threads. Closed by `async_end` with the same key; re-opening an
        already-open key replaces it."""
        thread = self._thread_role()
        with self._lock:
            self._async[(str(cat), str(name), str(id))] = {
                "t": self._now(), "perf": time.perf_counter(),
                "thread": thread,
                "iter": int(iteration), "args": args}

    def async_end(self, name: str, id: str, cat: str = "request",
                  iteration: int = 0, args: Optional[dict] = None):
        """Close an `async_begin`; the completed span (with its `id`)
        enters the ring. An end with no matching begin (e.g. a request
        resumed into a fresh process) records a zero-duration span so
        the terminal transition is never silently lost."""
        key = (str(cat), str(name), str(id))
        with self._lock:
            opened = self._async.pop(key, None)
        now_perf = time.perf_counter()
        if opened is None:
            t0, dur, it0, margs = (self._now(), 0.0, int(iteration),
                                   args)
        else:
            t0 = opened["t"]
            dur = max(now_perf - opened["perf"], 0.0)
            it0 = opened["iter"]
            margs = dict(opened["args"] or {}, **(args or {})) \
                if (opened["args"] or args) else None
        self._append({
            "kind": "span", "name": str(name), "cat": str(cat),
            "t": t0, "dur": dur, "thread": self._thread_role(),
            "iter": it0, "id": str(id), "args": margs})

    # ------------------------------------------------------------------
    # export

    def events(self) -> List[dict]:
        """Snapshot of the buffered events (oldest first)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def open_async(self) -> List[tuple]:
        """Keys of still-open async spans (debugging / drain checks)."""
        with self._lock:
            return sorted(self._async)

    def drain_records(self) -> List[dict]:
        """Schema-validated `span` JSONL records for every event not
        yet drained (an internal cursor: each event is emitted exactly
        once across repeated calls, however many callers share the
        tracer). Events the ring dropped before a drain are simply
        gone — `dropped` counts them."""
        with self._lock:
            # the undrained events are a SUFFIX of the ring (seq order
            # == append order, overflow drops from the left): walk from
            # the right and stop at the first drained one, so a full
            # 64Ki ring costs O(new), not O(capacity), per drain —
            # this runs on the dispatcher at every step() return
            fresh = []
            for e in reversed(self._events):
                if e["seq"] <= self._drained:
                    break
                fresh.append(dict(e))
            fresh.reverse()
            self._drained = self._seq
        return [make_span_record(e, self.process_index) for e in fresh]

    def chrome_events(self) -> List[dict]:
        """The ring as Chrome-trace events: one "X" (complete) event
        per span — async spans (those carrying an `id`) as "b"/"e"
        pairs so Perfetto draws them on their own async track — one
        "i" event per instant, plus process/thread metadata. ts/dur in
        microseconds on the wall-epoch time base (shared across
        processes, so per-process files merge)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            open_async = {k: dict(v) for k, v in self._async.items()}
        pid = self.process_index
        tids: Dict[str, int] = {}

        def tid(role: str) -> int:
            if role not in tids:
                tids[role] = len(tids) + 1
            return tids[role]

        out: List[dict] = []
        for e in events:
            base = {"name": e["name"], "cat": e["cat"], "pid": pid,
                    "tid": tid(e["thread"]),
                    "ts": round(e["t"] * 1e6, 3)}
            if e.get("args") or "iter" in e:
                base["args"] = dict(e.get("args") or {},
                                    iter=e.get("iter", 0))
            if e["kind"] == "instant":
                ev = dict(base, ph="i", s="t")
                if "id" in e:
                    ev["args"] = dict(ev.get("args") or {}, id=e["id"])
                out.append(ev)
            elif "id" in e:
                out.append(dict(base, ph="b", id=e["id"]))
                out.append(dict(base, ph="e", id=e["id"],
                                ts=round((e["t"] + e["dur"]) * 1e6, 3)))
            else:
                out.append(dict(base, ph="X",
                                dur=round(e["dur"] * 1e6, 3)))
        # still-open async spans (a drained service's in-flight
        # requests): emit the "b" edge so the timeline shows them
        for (cat, name, id_), info in sorted(open_async.items()):
            out.append({"name": name, "cat": cat, "pid": pid,
                        "tid": tid(info.get("thread", "main")),
                        "ph": "b",
                        "id": id_, "ts": round(info["t"] * 1e6, 3),
                        "args": dict(info.get("args") or {},
                                     iter=info.get("iter", 0))})
        meta = [{"ph": "M", "name": "process_name", "pid": pid,
                 "tid": 0, "args": {"name": self.process_name}}]
        for role, t in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": t, "args": {"name": role}})
        return meta + out

    def write_chrome_trace(self, path: str) -> str:
        """Write the ring as one Chrome-trace JSON object (atomic
        temp-file + rename). Load it in Perfetto / chrome://tracing;
        `merge_chrome_traces` folds several (per-process) files into
        one."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


def make_span_record(event: dict, process_index: int = 0) -> dict:
    """One schema-validated `span` JSONL record (schema.py SPAN_FIELDS)
    from a tracer event dict."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "type": "span",
        "iter": int(event.get("iter", 0)),
        "wall_time": float(event["t"]),
        "name": str(event["name"]),
        "cat": str(event["cat"]),
        "kind": str(event["kind"]),
        "dur_s": round(float(event.get("dur", 0.0)), 6),
        "thread": str(event.get("thread", "main")),
        "process": int(process_index),
    }
    if event.get("id") is not None:
        rec["id"] = str(event["id"])
    if event.get("args"):
        rec["args"] = dict(event["args"])
    return rec


def span_line(record: dict) -> str:
    """One-line text form of a `span` record (CaffeLogSink)."""
    head = (f"Span {record.get('cat')}/{record.get('name')} "
            f"[{record.get('thread')}]")
    if record.get("kind") == "instant":
        tail = f" at iteration {record.get('iter')}"
    else:
        tail = (f": {record.get('dur_s', 0):g} s "
                f"(iteration {record.get('iter')})")
    if record.get("id"):
        tail += f" id={record['id']}"
    return head + tail


def merge_chrome_traces(paths, out_path: str) -> str:
    """Concatenate the traceEvents of several Chrome-trace JSON files
    (the per-process exports of a pod run) into one loadable file —
    the per-file pid/tid metadata keeps every process and thread role
    distinguished on the shared wall-clock time base."""
    events: List[dict] = []
    for p in paths:
        with open(p) as f:
            payload = json.load(f)
        events.extend(payload.get("traceEvents", []))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out_path)
    return out_path


def phase_breakdown(events, by_thread: bool = False) -> dict:
    """Seconds per span name across an iterable of tracer events OR
    `span` JSONL records (both carry name/kind + a duration field).
    Instants are skipped. `by_thread=True` keys by (name, thread) —
    how the bench drivers split dispatcher-blocked time from
    concurrent consumer work."""
    out: dict = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        dur = float(e.get("dur", e.get("dur_s", 0.0)) or 0.0)
        key = ((e.get("name", "?"), e.get("thread", "?")) if by_thread
               else e.get("name", "?"))
        out[key] = out.get(key, 0.0) + dur
    return out


def bench_phase_breakdown(events) -> dict:
    """The bench rows' `extra.phase_breakdown` dict (one definition,
    shared by bench.py and bench_sweep.py): `dispatch_seconds` is
    chunk-program enqueue time, `host_blocked_seconds` the dispatcher
    actually waiting (submit backpressure + end-of-step drains +
    inline consumes when synchronous), `consumer_thread_seconds` the
    bookkeeping the pipeline hid on the consumer thread (overlapped,
    not critical-path), and checkpoint/prefetch the durability and
    overlapped-build time."""
    by = phase_breakdown(events, by_thread=True)

    def tot(name, thread=None):
        return sum(v for (n, th), v in by.items()
                   if n == name and (thread is None or th == thread))

    return {
        "dispatch_seconds": round(tot("dispatch"), 4),
        "host_blocked_seconds": round(
            tot("submit_wait") + tot("drain")
            + tot("consume", "dispatcher"), 4),
        "consumer_thread_seconds": round(
            tot("consume", "chunk-consumer"), 4),
        "checkpoint_seconds": round(
            tot("checkpoint") + tot("save_faults") + tot("write"), 4),
        "prefetch_seconds": round(tot("group_build"), 4),
    }
