"""Cold-start accounting (counterpart of the reference package's
cache.py `SetupStats`): the seconds a runner spent decoding its dataset
and building its kernels, assembled into the observe `setup` record.

- `decode_seconds` is the device dataset's materialisation (the LMDB
  decoded into tensors on the device).
- `compile_seconds` is the time `kernels.py` spent in nvcc in this
  process since the stats were made; the compile state is "miss" when
  nvcc ran, "hit" when every kernel loaded came from the build
  directory, "unused" when no kernel was loaded (the plain versions on
  the CPU).

The reference's persistent XLA compilation cache and decoded-dataset
cache have no counterpart: the dataset state is "disabled".
"""
from __future__ import annotations

import time
from typing import Optional

from . import kernels


class SetupStats:
    """Cold-start phase accounting for one runner; `record()` is its
    `setup` record (observe/schema.py). Build it before the runner's
    first kernel launch: the compile seconds are counted from then."""

    def __init__(self):
        self.decode_s = 0.0
        self.dataset = "disabled"
        self.pipeline = None          # async_exec.PipelineStats
        self.bytes_per_step = None
        self.fault_format = None
        self.fault_model = None
        self.engine = None
        self.engine_fallback_reason = None
        self.conv_im2col = None
        self.conv_im2col_reason = None
        self.conv_patch_bytes = None
        self._c0 = kernels.compile_seconds()
        self._n0 = kernels.builds()

    def add_decode(self, seconds: float):
        self.decode_s += float(seconds)

    def timed_decode(self):
        return _Timed(self.add_decode)

    @property
    def compile_s(self) -> float:
        return kernels.compile_seconds() - self._c0

    def compile_status(self) -> str:
        if kernels.builds() > self._n0:
            return "miss"
        return "hit" if kernels.loaded() else "unused"

    def record(self, setup_s: Optional[float] = None) -> dict:
        from .observe.sink import make_setup_record
        return make_setup_record(
            decode_s=self.decode_s, compile_s=self.compile_s,
            compile_status=self.compile_status(),
            dataset_status=self.dataset, setup_s=setup_s,
            pipeline=(self.pipeline.record()
                      if self.pipeline is not None else None),
            bytes_per_step_est=self.bytes_per_step,
            fault_state_format=self.fault_format,
            fault_model=self.fault_model, engine=self.engine,
            engine_fallback_reason=self.engine_fallback_reason,
            conv_im2col=self.conv_im2col,
            conv_im2col_reason=self.conv_im2col_reason,
            conv_patch_bytes=self.conv_patch_bytes)


class _Timed:
    def __init__(self, sink):
        self._sink = sink

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sink(time.perf_counter() - self._t0)
        return False
