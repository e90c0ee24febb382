"""Host-side overlap: an ordered consumer thread, crash-safe file writes
and the pipeline's accounting (counterpart of the reference package's
async_exec.py).

- `OrderedConsumer`: a bounded-queue thread that applies a callback to
  submitted items in exact submission order. The sweep's dispatcher
  hands it one chunk's results and goes on enqueueing the next chunk's
  kernels while the consumer waits for the copies, feeds the sinks and
  notes quarantines. Its first error is sticky: it re-raises at the next
  call, and every later one (the thread keeps draining the queue without
  processing, so nothing blocks on a dead consumer). With a stall timeout
  a `submit` or `drain` that would wait on a consumer whose heartbeat is
  stale raises `StallError` instead of hanging.
- `atomic_write` / `BackgroundWriter`: every payload is written to a
  sibling temp file and `os.replace`d into place only on success, so a
  crash mid-write never leaves a partial file under the final name. The
  writer takes (path, write_fn) pairs in order on one thread; the caller
  hands it host data only, fetched on the calling thread.
- `PipelineStats`: where the dispatcher blocked (submit backpressure, or
  the inline bookkeeping at depth 0), how long the consumer worked
  concurrently, barrier waits and write seconds: the `pipeline` field of
  the observe `setup` record.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional


class StallError(RuntimeError):
    """The consumer stopped making progress while work was pending (its
    heartbeat went stale past the stall timeout). The sweep catches it
    to write an emergency checkpoint before it aborts; `checkpoint_path`
    is that file's path when one was written."""

    def __init__(self, message: str, checkpoint_path: Optional[str] = None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path


_STOP = object()


class OrderedConsumer:
    """Bounded-queue consumer thread, in-order, with sticky errors.

    `submit(item)` hands one unit of work to the thread and returns the
    seconds it blocked (only when the queue, `depth` items, is full:
    the dispatcher's backpressure). `drain()` returns once every
    submitted item is consumed, re-raising a consumer error.
    `consumer_s` sums the thread's seconds in `fn`; `tracer` (an
    observe.spans.SpanTracer) makes each item one `span_name` span on
    the thread."""

    def __init__(self, fn: Callable, depth: int = 2,
                 name: str = "chunk-consumer",
                 stall_timeout: Optional[float] = None):
        self._fn = fn
        self._depth = max(int(depth), 1)
        self._name = name
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.consumer_s = 0.0
        self.tracer = None
        self.span_name = name
        # heartbeat: the monotonic time of the consumer's last sign of
        # life (an item picked up or finished)
        self.stall_timeout = stall_timeout
        self._beat = time.monotonic()

    def check(self):
        """Re-raise the sticky consumer error, if one has occurred."""
        if self._error is not None:
            raise self._error

    def idle_for(self) -> float:
        """Seconds since the consumer last made progress."""
        return time.monotonic() - self._beat

    def _check_stall(self, waited_from: float):
        """Raise StallError when the heartbeat is stale past the timeout
        and the caller itself has waited at least that long."""
        if self.stall_timeout is None:
            return
        if (self.idle_for() > self.stall_timeout
                and time.monotonic() - waited_from > self.stall_timeout):
            raise StallError(
                f"consumer {self._name!r} made no progress for "
                f"{self.idle_for():.1f}s (stall timeout "
                f"{self.stall_timeout:g}s) with work pending")

    def _run(self):
        while True:
            item = self._q.get()
            self._beat = time.monotonic()
            try:
                if item is _STOP:
                    return
                if self._error is None:
                    t0 = time.perf_counter()
                    self._fn(item)
                    dt = time.perf_counter() - t0
                    self.consumer_s += dt
                    if self.tracer is not None:
                        self.tracer.complete(self.span_name, dt,
                                             cat="host")
            except BaseException as e:   # surfaced at the next call
                self._error = e
            finally:
                self._beat = time.monotonic()
                self._q.task_done()

    def _wait_step(self) -> float:
        return min(0.25, max(self.stall_timeout, 0.01))

    def submit(self, item) -> float:
        """Enqueue one item; returns the seconds blocked on
        backpressure."""
        self.check()
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self._name)
            self._thread.start()
        t0 = time.perf_counter()
        if self.stall_timeout is None:
            self._q.put(item)
        else:
            t_block = time.monotonic()
            while True:
                try:
                    self._q.put(item, timeout=self._wait_step())
                    break
                except queue.Full:
                    self.check()
                    self._check_stall(t_block)
        return time.perf_counter() - t0

    def drain(self) -> float:
        """Barrier: block until every submitted item is consumed, then
        re-raise any sticky error. Returns the seconds blocked."""
        self.check()
        t0 = time.perf_counter()
        if self.stall_timeout is None:
            self._q.join()
        else:
            t_block = time.monotonic()
            with self._q.all_tasks_done:
                while self._q.unfinished_tasks:
                    self._q.all_tasks_done.wait(self._wait_step())
                    if self._q.unfinished_tasks:
                        if self._error is not None:
                            break
                        self._check_stall(t_block)
        dt = time.perf_counter() - t0
        self.check()
        return dt

    def abandon(self):
        """Give up on a stalled consumer: mark it failed so no later call
        blocks on it, and leave the (daemon) thread to the process. A
        healthy consumer is stopped with `close()`."""
        if self._error is None:
            self._error = StallError(
                f"consumer {self._name!r} abandoned after a stall")
        self._thread = None

    def close(self):
        """Stop the thread (pending items are consumed first)."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_STOP)
            self._thread.join()
        self._thread = None


def atomic_write(path: str, write_fn: Callable[[str], None]):
    """Run `write_fn(tmp_path)` against a sibling temp file and
    `os.replace` it into `path` only on success; the temp file is
    removed on failure."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def write(path: str, write_fn: Callable[[str], None],
          writer: Optional["BackgroundWriter"] = None):
    """One atomic write of `path`: queued on `writer` when one is given,
    else inline on the calling thread."""
    if writer is None:
        atomic_write(path, write_fn)
    else:
        writer.submit(path, write_fn)


# Queued writes each hold a full host copy of the state they write; two
# let the caller hand over one while the writer works on the other, and
# a third blocks the caller instead of growing host memory.
QUEUE_DEPTH = 2


class BackgroundWriter:
    """Off-thread atomic file writer: `submit(path, write_fn)` queues
    one write (a full queue blocks the caller), `wait()` is the
    barrier; errors are sticky. `write_s` sums the writer's seconds;
    `tracer` makes each write one "write" span on its thread."""

    def __init__(self):
        self._consumer = OrderedConsumer(self._write, depth=QUEUE_DEPTH,
                                         name="snapshot-writer")
        self._consumer.span_name = "write"
        self.write_s = 0.0

    @property
    def tracer(self):
        return self._consumer.tracer

    @tracer.setter
    def tracer(self, tracer):
        self._consumer.tracer = tracer

    def _write(self, item):
        path, write_fn = item
        t0 = time.perf_counter()
        atomic_write(path, write_fn)
        self.write_s += time.perf_counter() - t0

    def check(self):
        """Re-raise the writer's first error, if any."""
        self._consumer.check()

    def submit(self, path: str, write_fn: Callable[[str], None]):
        """Queue one atomic write; `write_fn(tmp_path)` runs on the
        writer thread. Re-raises an earlier writer error."""
        self._consumer.submit((path, write_fn))

    def wait(self):
        """Block until every queued write has landed, then re-raise the
        first writer error, if any."""
        self._consumer.drain()

    def close(self):
        """Stop the thread after the queued writes."""
        self._consumer.close()


class PipelineStats:
    """Host-overlap accounting of one runner, the `pipeline` field of
    the observe `setup` record. At depth 0 `host_blocked_s` is the
    inline bookkeeping time per chunk; at depth >= 1 the submit
    backpressure alone. `setup_overlap_s` is the runner's build time
    hidden behind the previous group's run (`GroupPrefetcher.take`)."""

    def __init__(self, depth: int = 0):
        self.depth = int(depth)
        self.chunks = 0
        self.records = 0
        self.host_blocked_s = 0.0
        self.consumer_s = 0.0
        self.drain_s = 0.0
        self.snapshot_write_s = 0.0
        self.checkpoint_write_s = 0.0
        self.setup_overlap_s = 0.0

    def record(self) -> dict:
        """The `pipeline` sub-record (observe/schema.py
        PIPELINE_FIELDS)."""
        rec = {
            "depth": self.depth,
            "chunks": int(self.chunks),
            "host_blocked_seconds": round(float(self.host_blocked_s), 6),
        }
        if self.records:
            rec["records"] = int(self.records)
        for key, val in (("consumer_seconds", self.consumer_s),
                         ("drain_seconds", self.drain_s),
                         ("snapshot_write_seconds", self.snapshot_write_s),
                         ("checkpoint_write_seconds",
                          self.checkpoint_write_s),
                         ("setup_overlap_seconds", self.setup_overlap_s)):
            if val:
                rec[key] = round(float(val), 6)
        return rec
