"""Profiler capture (counterpart of the reference package's
observe/trace.py, which wraps `jax.profiler.trace`).

`trace(profile_dir)` wraps a code region in a `torch.profiler` capture
of the host and, where a card is present, the device, and writes the
Chrome trace `trace.<pid>.json` under `profile_dir` when the region
ends; with no directory it is a no-op. Load the file in Perfetto or
chrome://tracing, beside the sweep's span export
(`SweepRunner.write_trace`) from the same directory.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(profile_dir=None):
    """Capture a torch.profiler trace of the region under `profile_dir`
    (created if missing); does nothing when `profile_dir` is empty.
    Yields the profiler (None when off)."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace.{os.getpid()}.json"))
