"""Crash-safe file writes, inline or on a background thread (counterpart
of the reference package's async_exec.py `atomic_write` and
`BackgroundWriter`).

Every payload is written to a sibling temp file and `os.replace`d into
place only on success, so a crash mid-write never leaves a partial file
under the final name: a good snapshot or checkpoint is never replaced by
a bad one. The background writer takes (path, write_fn) pairs in order
on one thread; the caller hands it host data only (numpy arrays, proto
messages), fetched from the device on the calling thread. Its first
error is sticky: it re-raises at the next `submit` or `wait`, and every
later one.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional


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


_STOP = object()


# Queued writes each hold a full host copy of the state they write; two
# let the caller hand over one while the writer works on the other, and
# a third blocks the caller instead of growing host memory.
QUEUE_DEPTH = 2


class BackgroundWriter:
    """Off-thread atomic file writer: `submit(path, write_fn)` queues
    one write (a full queue blocks the caller), `wait()` is the
    barrier. `write_s` sums the writer's seconds."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.write_s = 0.0

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._error is None:
                    path, write_fn = item
                    t0 = time.perf_counter()
                    atomic_write(path, write_fn)
                    self.write_s += time.perf_counter() - t0
            except BaseException as e:      # surfaced at submit/wait
                self._error = e
            finally:
                self._q.task_done()

    def check(self):
        """Re-raise the writer's first error, if any."""
        if self._error is not None:
            raise self._error

    def submit(self, path: str, write_fn: Callable[[str], None]):
        """Queue one atomic write; `write_fn(tmp_path)` runs on the
        writer thread. Re-raises an earlier writer error."""
        self.check()
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="snapshot-writer")
            self._thread.start()
        self._q.put((path, write_fn))

    def wait(self):
        """Block until every queued write has landed, then re-raise the
        first writer error, if any."""
        self._q.join()
        self.check()

    def close(self):
        """Stop the thread after the queued writes."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_STOP)
            self._thread.join()
        self._thread = None
