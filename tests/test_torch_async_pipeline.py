"""The port's sweep pipeline (async_exec.OrderedConsumer and the
SweepRunner's pipeline_depth, stall_timeout_s and step() return)
against the reference package's.

The small conv net of tests/test_torch_sweep.py at C = 3 lanes
(lifetimes N(250, 30) to N(450, 250), the ternary crossbar read, packed
banks). Held: the consumer keeps exact order, its errors are sticky and
never hang, a stalled consumer raises StallError and an abandoned one
never blocks again; depths None, 0 and 2 give identical losses, outputs,
params, history, banks and records (timing aside), and no chunk's state
shares storage with the next one's; against the reference's runner at
the same depth, from one seed, `step()` returns the reference's
(losses, outputs) within 1e-4 relative (the tolerance of
tests/test_torch_sweep.py: the packages sum convolutions and products in
other orders) and, at depth 2, the records carry the reference's integer
fields exactly and its floats within 1e-4; a stall's emergency
checkpoint restores into a new runner of either package, which continues
as the run that never stalled (bit for bit in the port, within 1e-5
relative and banks identical in the reference)."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu_torch import async_exec
from rram_caffe_simulation_tpu_torch.observe import schema as tschema

from test_torch_checkpoint import (assert_same_state, feed_from, host_tree,
                                   port, ref_solver, state_of)
from test_torch_observe import close
from test_torch_sweep import MEANS, STDS

TIMING = ("wall_time", "step_latency_s", "iters_per_s")
REL = 1e-4


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def strip(records):
    return [{k: v for k, v in r.items() if k not in TIMING}
            for r in records]


# ---------------------------------------------------------------------------
# OrderedConsumer

def test_ordered_consumer_preserves_order():
    seen = []
    c = async_exec.OrderedConsumer(seen.append, depth=2)
    for i in range(20):
        c.submit(i)
    c.drain()
    assert seen == list(range(20))
    c.close()


def test_ordered_consumer_sticky_error_drains_queue():
    def fn(i):
        if i == 3:
            raise ValueError("item 3")
    c = async_exec.OrderedConsumer(fn, depth=1)
    with pytest.raises(ValueError, match="item 3"):
        for i in range(50):          # must not hang on the full queue
            c.submit(i)
        c.drain()
    with pytest.raises(ValueError, match="item 3"):
        c.submit(99)
    with pytest.raises(ValueError, match="item 3"):
        c.drain()
    c.close()


@pytest.mark.parametrize("where", ["submit", "drain"])
def test_ordered_consumer_stall_raises_and_abandon_never_blocks(where):
    release = threading.Event()
    c = async_exec.OrderedConsumer(lambda i: release.wait(30.0), depth=1,
                                   stall_timeout=0.2)
    t0 = time.monotonic()
    try:
        with pytest.raises(async_exec.StallError, match="no progress"):
            c.submit(0)
            c.submit(1)                  # the queue holds one
            if where == "submit":
                c.submit(2)
            c.drain()
        assert time.monotonic() - t0 < 5.0
        c.abandon()
        t1 = time.monotonic()
        for call in (lambda: c.submit(3), c.drain, c.check):
            with pytest.raises(async_exec.StallError, match="abandoned"):
                call()
        assert time.monotonic() - t1 < 1.0
    finally:
        release.set()


def test_background_writer_rides_the_consumer(tmp_path):
    w = async_exec.BackgroundWriter()
    for i in range(3):
        w.submit(str(tmp_path / f"f{i}"),
                 lambda tmp, i=i: open(tmp, "w").write(str(i)))
    w.wait()
    assert [open(tmp_path / f"f{i}").read() for i in range(3)] == \
        ["0", "1", "2"]
    assert w.write_s > 0
    w.close()


# ---------------------------------------------------------------------------
# depths None, 0 and 2 within the port

def metrics_runner(depth, sink, **kw):
    from test_torch_sweep import port_solver
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = port_solver(feed_from(0))
    s.enable_metrics(sink)
    return SweepRunner(s, 3, means=MEANS, stds=STDS, engine="cuda",
                       packed_state=True, dtype_policy="ternary",
                       device="cpu", pipeline_depth=depth, **kw)


@pytest.mark.parametrize("chunk", [1, 3])
def test_depths_give_identical_results(chunk):
    runs = {}
    for depth in (None, 0, 2):
        sink = ListSink()
        r = metrics_runner(depth, sink)
        out = [r.step(3, chunk=chunk) for _ in range(2)]
        r.close()
        runs[depth] = (r, out, sink.records)
    base_r, base_out, base_recs = runs[0]
    for depth in (None, 2):
        r, out, recs = runs[depth]
        for (la, oa), (lb, ob) in zip(base_out, out):
            assert la.tobytes() == lb.tobytes()
            assert sorted(oa) == sorted(ob) == ["loss"]
            assert all(oa[k].tobytes() == ob[k].tobytes() for k in oa)
        assert_same_state(state_of(base_r), state_of(r))
        assert r.chunk_losses.tobytes() == base_r.chunk_losses.tobytes()
    assert strip(runs[2][2]) == strip(base_recs)
    assert runs[None][2] == []           # depth None feeds no sink
    assert len(base_recs) == 6 // chunk
    assert all(len(rec["loss"]) == 3 and tschema.validate_record(rec) == []
               for rec in base_recs)
    assert base_recs[-1]["iter"] == 5
    assert runs[2][0].pipeline.records == runs[0][0].pipeline.records \
        == 6 // chunk
    assert runs[2][0].pipeline.chunks == runs[None][0].pipeline.chunks


def test_chunk_records_read_the_chunk_last_iteration():
    """Only a chunk's last iteration builds the full metrics tree: the
    records of chunk 3 equal those of chunk 1 at iterations 2 and 5."""
    recs = {}
    for chunk in (1, 3):
        sink = ListSink()
        r = metrics_runner(0, sink)
        r.step(6, chunk=chunk)
        r.close()
        recs[chunk] = {rec["iter"]: rec for rec in strip(sink.records)}
    assert sorted(recs[3]) == [2, 5] and sorted(recs[1]) == list(range(6))
    assert all(recs[3][it] == recs[1][it] for it in (2, 5))


def test_chunks_never_share_storage():
    """The state a chunk hands to the bookkeeping is never written by the
    next: every step's commit allocates new leaves."""
    r = port(pipeline_depth=2)
    before = {k: v for k, v in r._state_arrays().items()}
    ptrs = {k: v.data_ptr() for k, v in before.items()}
    r.step(1)
    after = r._state_arrays()
    shared = [k for k, v in after.items()
              if v.data_ptr() == ptrs[k] and not torch.equal(v, before[k])]
    assert shared == []
    assert all(after[k] is not before[k] for k in after
               if k.startswith(("params/", "fault/life_q")))
    r.close()


# ---------------------------------------------------------------------------
# against the reference runner

@pytest.mark.parametrize("depth", [None, 2])
def test_step_and_records_equal_the_reference(depth):
    """One seed, both packages (the same draw); the reference on engine
    "pallas" (no straight-through gradient on broken cells, as the
    port). step() returns (losses (C,), {"loss": (C,)}) as the
    reference; at depth 2 the records match too."""
    tsink, jsink = ListSink(), ListSink()
    r = metrics_runner(depth, tsink)
    with jax.enable_x64(False):
        js = ref_solver(feed_from(0))
        js.enable_metrics(jsink)
        ref = JSweep(js, 3, means=MEANS, stds=STDS, engine="pallas",
                     packed_state=True, dtype_policy="ternary",
                     pipeline_depth=depth)
        for _ in range(2):
            got = r.step(2, chunk=2)
            want = ref.step(2, chunk=2)
            np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=REL)
            assert sorted(got[1]) == sorted(want[1])
            for k in got[1]:
                np.testing.assert_allclose(got[1][k], np.asarray(want[1][k]),
                                           rtol=REL)
                assert got[1][k].shape == np.asarray(want[1][k]).shape
        banks = host_tree(ref.fault_states)["life_q"]
        ref.close()
    r.close()
    for k, q in r.fault_states["life_q"].items():
        np.testing.assert_array_equal(q.numpy(), banks[k])
    assert len(tsink.records) == len(jsink.records) == (2 if depth else 0)
    for a, b in zip(strip(tsink.records), strip(jsink.records)):
        assert close(a, b, rel=REL) == []


def _blocking_runner(tmp_path, release, depth=1):
    class BlockingSink:
        n = 0

        def write(self, record):
            self.n += 1
            if self.n >= 2:
                release.wait(30.0)       # a wedged filesystem
    from test_torch_sweep import port_solver
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = port_solver(feed_from(0))
    s.param.snapshot_prefix = str(tmp_path / "snap")
    s.enable_metrics(BlockingSink())
    return SweepRunner(s, 3, means=MEANS, stds=STDS, engine="cuda",
                       packed_state=True, dtype_policy="ternary",
                       device="cpu", pipeline_depth=depth,
                       stall_timeout_s=0.3)


@pytest.fixture(scope="module")
def stalled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stall")
    release = threading.Event()
    r = _blocking_runner(tmp, release)
    t0 = time.monotonic()
    try:
        with pytest.raises(async_exec.StallError) as ei:
            r.step(12, chunk=1)
        took = time.monotonic() - t0
        it = r.iter
        again = r.step(2)                 # the stop is sticky
    finally:
        release.set()
    return {"error": ei.value, "took": took, "iter": it, "runner": r,
            "again": again}


def test_stall_raises_with_an_emergency_checkpoint(stalled):
    e = stalled["error"]
    assert stalled["took"] < 10.0
    assert e.checkpoint_path and os.path.exists(e.checkpoint_path)
    assert f"_sweep_stall_iter_{stalled['iter']}.ckpt.npz" in \
        e.checkpoint_path
    assert stalled["runner"].iter == stalled["iter"]


def test_stall_checkpoint_continues_bit_for_bit_in_the_port(stalled):
    it = stalled["iter"]
    full = port()
    full.step(it, chunk=it)
    want = [full.step(1)[0].copy() for _ in range(2)]
    fresh = port(start=it)
    fresh.restore(stalled["error"].checkpoint_path)
    got = [fresh.step(1)[0].copy() for _ in range(2)]
    for a, b in zip(want, got):
        assert a.tobytes() == b.tobytes()
    assert_same_state(state_of(full), state_of(fresh))


def test_stall_checkpoint_restores_into_the_reference(stalled):
    it = stalled["iter"]
    full = port()
    full.step(it, chunk=it)
    want = [full.step(1)[0].copy() for _ in range(2)]
    with jax.enable_x64(False):
        ref = JSweep(ref_solver(feed_from(it)), 3, means=MEANS, stds=STDS,
                     engine="jax", packed_state=True,
                     dtype_policy="ternary")
        ref.restore(stalled["error"].checkpoint_path)
        assert ref.iter == it
        got = [np.asarray(ref.step(1, chunk=1)[0]).copy() for _ in range(2)]
        banks = host_tree(ref.fault_states)["life_q"]
        ref.close()
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5)
    for k, q in full.fault_states["life_q"].items():
        np.testing.assert_array_equal(q.numpy(), banks[k])


def test_setup_record_carries_the_pipeline(tmp_path):
    sink = ListSink()
    r = metrics_runner(2, sink, stall_timeout_s=5.0)
    r.step(4, chunk=2)
    rec = r.setup_record(setup_s=1.5)
    r.close()
    assert tschema.validate_record(rec) == []
    assert rec["engine"] == "cuda" and rec["fault_state_format"] == "packed"
    assert rec["bytes_per_step_est"] == r.bytes_per_step_est()
    pipe = rec["pipeline"]
    assert (pipe["depth"], pipe["chunks"], pipe["records"]) == (2, 2, 2)
    assert pipe["consumer_seconds"] > 0
    assert rec["cache"] == {"compile": "unused", "dataset": "disabled"}
    assert rec["setup_seconds"] == 1.5
    json.dumps(rec)
