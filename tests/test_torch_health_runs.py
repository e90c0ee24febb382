"""The port's health records from whole runs (the Solver's
enable_health, the SweepRunner's health_every) against the reference
package's: both from one prototxt and seed, so the banks and the
censuses stay equal, the sweep's with its lane map, every record valid
under both schemas. The census helpers, the program and the ledger are
held in tests/test_torch_health.py."""
import pytest

import jax

from rram_caffe_simulation_tpu.observe import schema as jschema
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu_torch.observe import schema as tschema

from test_torch_async_pipeline import ListSink
from test_torch_checkpoint import feed_from, ref_solver
from test_torch_observe import close
from test_torch_sweep import MEANS, STDS, port_solver


def test_solver_health_records_equal_the_reference(monkeypatch):
    """Both Solvers from one prototxt and seed (the same fault state),
    no crossbar read: the banks stay equal, so do the censuses."""
    from test_torch_observe import SOLVER, REPO, jfeed, JNet, pb, \
        text_format, JSolver, TSolver, tproto, jsink, tsink
    monkeypatch.chdir(REPO)
    sp = pb.SolverParameter()
    text_format.Parse(SOLVER, sp)
    recs = {}
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]), tile_spec="2x2")
        recs["j"] = ListSink()
        js.metrics_logger = jsink.MetricsLogger([recs["j"]])
        js.enable_health(2)
        js.step(4)
    ts = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                 tile_spec="2x2")
    recs["t"] = ListSink()
    ts.metrics_logger = tsink.MetricsLogger([recs["t"]])
    ts.enable_health(2)
    ts.step(4)
    got, want = recs["t"].records, recs["j"].records
    assert [r["iter"] for r in got] == [r["iter"] for r in want] == [2, 4]
    for a, b in zip(got, want):
        assert tschema.validate_record(a) == jschema.validate_record(a) == []
        a, b = dict(a), dict(b)
        a.pop("wall_time"), b.pop("wall_time")
        assert close(a, b) == []
    assert ts.health_ledger.summary() == js.health_ledger.summary()


@pytest.mark.parametrize("depth", [None, 2])
def test_sweep_health_records_equal_the_reference(depth):
    """One seed, both packages: the port's sweep and the reference's
    (engine "jax") with health_every 2, chunk 2; the banks stay equal,
    so do the censuses, lane map and summary."""
    tsink_, jsink_ = ListSink(), ListSink()
    s = port_solver(feed_from(0))
    s.enable_metrics(tsink_)
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    r = SweepRunner(s, 3, means=MEANS, stds=STDS, engine="cuda",
                    packed_state=True, dtype_policy="ternary", device="cpu",
                    pipeline_depth=depth, health_every=2)
    with jax.enable_x64(False):
        js = ref_solver(feed_from(0))
        js.enable_metrics(jsink_)
        ref = JSweep(js, 3, means=MEANS, stds=STDS, engine="jax",
                     packed_state=True, dtype_policy="ternary",
                     pipeline_depth=depth, health_every=2)
        ref.step(6, chunk=2)
        ref_summary = ref.health_summary()
        ref.close()
    r.step(6, chunk=2)
    r.close()
    health = lambda sink: [dict(x) for x in sink.records
                           if x.get("type") == "health"]
    got, want = health(tsink_), health(jsink_)
    assert [x["iter"] for x in got] == [x["iter"] for x in want] == [4, 6]
    for a, b in zip(got, want):
        assert a["lane_map"] == [0, 1, 2]
        assert tschema.validate_record(a) == []
        a.pop("wall_time"), b.pop("wall_time")
        assert close(a, b) == []
    assert r.health_summary() == ref_summary
