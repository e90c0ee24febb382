"""The multi-group sweep's runner-level parts against the reference
package's: `PipelineStats.setup_overlap_s` (async_exec.py),
`GroupPrefetcher` (parallel/sweep.py) and `SweepRunner(precompile_chunk=)`.

The inputs are those of scripts/check_resume_equivalence.py: a generated
24-record 1x8x8 LMDB written with the reference's `lmdb_py.BulkWriter`,
a one-InnerProduct solver over it (batch 8, SGD with momentum), and
lifetimes N(300, 60).

- `PipelineStats.record()` equals the reference's at the same field
  values.
- The prefetcher's accounting (one build in flight, build and wait
  seconds, the hidden seconds credited to the runner), a build error
  re-raised by `take()`, `cancel()` closing an abandoned runner (and
  dropping a failed build's error) and the context manager's cancel:
  each run on both packages' prefetchers with the same build functions,
  the outcomes equal.
- A runner built on the prefetch thread equals one built inline, bit for
  bit, after steps.
- `precompile_chunk=2`: the decode runs on its `dataset-decode` thread
  while the constructor's thread loads the step's kernels, and every
  lane's params,
  history and banks equal a runner's without it bit for bit after 4
  steps; against the reference's runner with `precompile_chunk=2` at
  f32 (engine "jax", x64 off) the per-lane losses agree within 1e-5
  relative and the fault banks bit for bit. The probe declines where the
  reference's does: a random transform (no device dataset at all), an
  empty DB, no DB.
- `pack_state` of tensors (a build packs its banks where the draw put
  them) and of host arrays equals the reference's, byte for byte.
- `engine_fallback_reason` and `_edit_leaf_rows` (the driver's NaN
  hook: only the given lanes' rows change).
"""
import json
import threading
import time

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu import async_exec as jasync
from rram_caffe_simulation_tpu.parallel import GroupPrefetcher as JPrefetch
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import async_exec as tasync
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.parallel import GroupPrefetcher as TPrefetch
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_self_healing import REL, banks

RECORDS = 24
PACKAGES = {"port": (TPrefetch, tasync), "reference": (JPrefetch, jasync)}


def build_db(path, records=RECORDS):
    """The resume guard's LMDB: `records` random 1x8x8 uint8 images,
    labels 0-3 from their mean."""
    from rram_caffe_simulation_tpu.data import lmdb_py
    from rram_caffe_simulation_tpu.data.db import array_to_datum
    rng = np.random.RandomState(0)
    with lmdb_py.BulkWriter(str(path)) as w:
        for i in range(records):
            img = rng.randint(0, 255, (1, 8, 8), dtype=np.uint8)
            w.put(b"%08d" % i, array_to_datum(
                img, int(img.mean() // 64)).SerializeToString())
    return str(path)


def solver_text(db, prefix, mirror=False, fault=True):
    """The resume guard's solver over `db` (a Data layer, batch 8, one
    InnerProduct of 4 outputs), with lifetimes N(300, 60) unless
    `fault` is False (the driver sets its own)."""
    tp = "scale: 0.00390625" + (" mirror: true" if mirror else "")
    text = f"""
base_lr: 0.05
lr_policy: "fixed"
momentum: 0.9
type: "SGD"
max_iter: 1000
display: 0
random_seed: 3
snapshot_prefix: "{prefix}/snap"
net_param {{
  name: "resumeguard"
  layer {{ name: "data" type: "Data" top: "data" top: "label"
    data_param {{ source: "{db}" batch_size: 8 }}
    transform_param {{ {tp} }} }}
  layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
    inner_product_param {{ num_output: 4
      weight_filler {{ type: "xavier" }} }} }}
  layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip"
    bottom: "label" top: "loss" }}
}}
"""
    if fault:
        text += 'failure_pattern { type: "gaussian" mean: 300 std: 60 }\n'
    return text


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return build_db(tmp_path_factory.mktemp("prefetch") / "db")


def port_runner(text, C=3, **kw):
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    return TSweep(s, C, device="cpu", **kw)


def ref_runner(text, C=3, **kw):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return JSweep(JSolver(sp), C, **kw)


def state_bytes(r):
    return {k: v.detach().numpy().tobytes()
            for k, v in r._state_arrays().items()}


# ---------------------------------------------------------------------------
# PipelineStats.setup_overlap_s

@pytest.mark.parametrize("overlap", [0.0, 2.5])
def test_pipeline_record_equals_the_reference(overlap):
    recs = []
    for mod in (tasync, jasync):
        st = mod.PipelineStats(depth=2)
        st.chunks, st.records = 5, 5
        st.host_blocked_s, st.consumer_s = 0.25, 1.5
        st.drain_s, st.snapshot_write_s = 0.125, 0.5
        st.checkpoint_write_s, st.setup_overlap_s = 0.75, overlap
        recs.append(st.record())
    assert recs[0] == recs[1]
    assert ("setup_overlap_seconds" in recs[0]) == bool(overlap)
    assert tschema.validate_record(
        {"schema_version": tschema.SCHEMA_VERSION, "type": "setup",
         "wall_time": 0.0, "decode_seconds": 0.0, "compile_seconds": 0.0,
         "cache": {"compile": "unused", "dataset": "disabled"},
         "pipeline": recs[0]}) == []


# ---------------------------------------------------------------------------
# GroupPrefetcher, each scenario on both packages

def accounting(cls, mod):
    gp = cls()

    class FakeRunner:
        pipeline = mod.PipelineStats()

    def build():
        time.sleep(0.2)
        return FakeRunner()

    gp.start(build)
    with pytest.raises(RuntimeError, match="in flight"):
        gp.start(build)
    time.sleep(0.3)                       # the current group runs
    r = gp.take()
    return {"runner": isinstance(r, FakeRunner),
            "built": gp.last_build_s >= 0.2,
            "hidden": gp.last_wait_s < 0.15,
            "credited": r.pipeline.setup_overlap_s == pytest.approx(
                gp.last_build_s - gp.last_wait_s, abs=1e-12),
            "overlap": r.pipeline.setup_overlap_s > 0.0}


def build_error(cls, mod):
    gp = cls()

    def boom():
        raise RuntimeError("group B setup failed")

    gp.start(boom)
    out = {}
    for _ in range(2):
        try:
            gp.take()
            out.setdefault("take", []).append(None)
        except RuntimeError as e:
            out.setdefault("take", []).append(str(e).split(";")[0])
    out["seconds"] = gp.last_build_s >= 0.0
    return out


@pytest.mark.parametrize("scenario", [accounting, build_error])
def test_prefetcher_equals_the_reference(scenario):
    got = {name: scenario(*PACKAGES[name]) for name in PACKAGES}
    assert got["port"] == got["reference"]
    assert all(v for v in got["port"].values())


def test_prefetcher_build_error_message():
    gp = TPrefetch()
    gp.start(lambda: (_ for _ in ()).throw(ValueError("bad group")))
    with pytest.raises(ValueError, match="bad group"):
        gp.take()
    with pytest.raises(RuntimeError, match="no group prefetch"):
        gp.take()


def _consumer_stopped(r):
    return r._consumer is not None and r._consumer._thread is None


def test_prefetcher_cancel_closes_runner(db, tmp_path):
    text = solver_text(db, tmp_path)
    builds = {"port": lambda: port_runner(text, C=2, pipeline_depth=2),
              "reference": lambda: ref_runner(text, C=2, pipeline_depth=2)}
    got = {}
    for name, (cls, _) in PACKAGES.items():
        pf = cls()
        pf.start(builds[name])
        pf.cancel()
        built = pf._box.get("result")
        out = [pf._thread is None, built is not None,
               _consumer_stopped(built)]
        # a failed build cancels silently; nothing in flight: a no-op
        pf.start(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        pf.cancel()
        out.append(pf._thread is None)
        pf.cancel()
        got[name] = out
    assert got["port"] == got["reference"] == [True] * 4


def test_prefetcher_context_manager_cancels(db, tmp_path):
    text = solver_text(db, tmp_path)
    builds = {"port": lambda: port_runner(text, C=2, pipeline_depth=2),
              "reference": lambda: ref_runner(text, C=2, pipeline_depth=2)}
    got = {}
    for name, (cls, _) in PACKAGES.items():
        with cls() as pf:
            pf.start(builds[name])
        built = pf._box.get("result")
        got[name] = [pf._thread is None, built is not None,
                     _consumer_stopped(built)]
    assert got["port"] == got["reference"] == [True] * 3


def test_prefetcher_traces_the_build():
    from rram_caffe_simulation_tpu_torch.observe.spans import SpanTracer
    gp = TPrefetch()
    gp.tracer = SpanTracer()

    class FakeRunner:
        pipeline = tasync.PipelineStats()

    gp.start(FakeRunner)
    gp.take()
    spans = [e for e in gp.tracer.events() if e.get("name") == "group_build"]
    assert len(spans) == 1 and spans[0]["cat"] == "setup"


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="f32"),
    pytest.param({"packed_state": True, "dtype_policy": "ternary"},
                 id="packed-ternary")])
def test_runner_built_on_the_thread_equals_inline(db, tmp_path, kw):
    text = solver_text(db, tmp_path)
    gp = TPrefetch()
    gp.start(lambda: port_runner(text, 3, pipeline_depth=2, **kw))
    bg = gp.take()
    fg = port_runner(text, 3, pipeline_depth=2, **kw)
    lb, _ = bg.step(4, chunk=2)
    lf, _ = fg.step(4, chunk=2)
    assert lb.tobytes() == lf.tobytes()
    assert state_bytes(bg) == state_bytes(fg)
    rec = bg.setup_record()
    assert rec["pipeline"]["depth"] == 2
    assert tschema.validate_record(rec) == []
    bg.close()
    fg.close()


# ---------------------------------------------------------------------------
# precompile_chunk

def decode_threads(monkeypatch):
    """The names of the threads the sweep's dataset decodes ran on."""
    from rram_caffe_simulation_tpu_torch.parallel import sweep as tsweep
    real, names = tsweep.materialize_data_source, []

    def decode(layer):
        names.append(threading.current_thread().name)
        return real(layer)
    monkeypatch.setattr(tsweep, "materialize_data_source", decode)
    return names


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="f32"),
    pytest.param({"packed_state": True, "dtype_policy": "ternary",
                  "pipeline_depth": 2}, id="packed-ternary-depth2")])
def test_precompile_equals_no_precompile(db, tmp_path, kw, monkeypatch):
    text = solver_text(db, tmp_path)
    names = decode_threads(monkeypatch)
    plain = port_runner(text, **kw)
    assert names == [threading.current_thread().name]
    pre = port_runner(text, precompile_chunk=2, **kw)
    assert names[1:] == ["dataset-decode"]
    shapes = {k: tuple(v.shape) for k, v in pre._dataset.items()}
    assert shapes == {"data": (RECORDS, 1, 8, 8), "label": (RECORDS,)}
    assert shapes == {k: tuple(v.shape) for k, v in plain._dataset.items()}
    assert state_bytes(pre) == state_bytes(plain)
    lp, _ = plain.step(4, chunk=2)
    lq, _ = pre.step(4, chunk=2)
    assert lq.tobytes() == lp.tobytes()
    assert state_bytes(pre) == state_bytes(plain)
    rec = pre.setup_record(setup_s=1.0)
    assert tschema.validate_record(rec) == []
    assert rec["decode_seconds"] > 0
    assert json.loads(json.dumps(rec)) == rec
    plain.close()
    pre.close()


def test_precompile_lanes_equal_the_reference(db, tmp_path):
    text = solver_text(db, tmp_path)
    port = port_runner(text, precompile_chunk=2)
    with jax.enable_x64(False):
        ref = ref_runner(text, precompile_chunk=2, engine="jax")
        assert (2, True) in ref._aot_keys
        for _ in range(2):
            lp, _ = port.step(2, chunk=2)
            lr, _ = ref.step(2, chunk=2)
            np.testing.assert_allclose(lp, np.asarray(lr), rtol=REL)
            bp, br = banks(port), banks(ref)
            assert bp.keys() == br.keys()
            for name in bp:
                assert bp[name].tobytes() == br[name].tobytes(), name
    assert port.iter == ref.iter == 4


def test_probe_declines_under_a_random_transform(db, tmp_path,
                                                 monkeypatch):
    names = decode_threads(monkeypatch)
    r = port_runner(solver_text(db, tmp_path, mirror=True),
                    precompile_chunk=2)
    assert r._dataset is None and names == []
    assert r.setup_record()["decode_seconds"] == 0.0
    losses, _ = r.step(2, chunk=2)        # the host feed still trains
    assert np.isfinite(losses).all()


def test_probe_declines_without_records(db, tmp_path):
    from rram_caffe_simulation_tpu_torch.parallel.sweep import SweepRunner
    empty = build_db(tmp_path / "empty", records=0)
    s = TSolver(tproto.parse(solver_text(db, tmp_path), "SolverParameter"),
                device="cpu")
    layer = [ly for ly in s.net.layers if ly.is_data_source][0]
    assert SweepRunner._probe_dataset(layer) is True
    layer.lp.data_param.source = empty
    assert SweepRunner._probe_dataset(layer) is False
    layer.lp.data_param.source = str(tmp_path / "no_such_db")
    assert SweepRunner._probe_dataset(layer) is False


def test_engine_fallback_reason():
    """None when the requested engine ran; the reason when engine "cuda"
    has no crossbar read to arm (sigma 0, no dtype policy)."""
    text = ('net_param { name: "n" layer { name: "in" type: "Input" '
            'top: "data" top: "label" input_param { shape { dim: 2 dim: 6 } '
            'shape { dim: 2 } } } layer { name: "fc" type: "InnerProduct" '
            'bottom: "data" top: "fc" inner_product_param { num_output: 3 '
            'weight_filler { type: "xavier" } } } layer { name: "loss" '
            'type: "SoftmaxWithLoss" bottom: "fc" bottom: "label" '
            'top: "loss" } } base_lr: 0.1 lr_policy: "fixed" random_seed: 1 '
            'failure_pattern { type: "gaussian" mean: 300 std: 100 }')

    def feed():
        return {"data": np.zeros((2, 6), np.float32),
                "label": np.zeros(2, np.float32)}

    def runner(**kw):
        s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                    train_feed=feed)
        return TSweep(s, 2, device="cpu", **kw)
    assert runner().engine_fallback_reason is None
    assert runner(dtype_policy="ternary").engine_fallback_reason is not None
    assert runner(engine="torch",
                  dtype_policy="ternary").engine_fallback_reason is None
    r = runner(engine="cuda")
    assert "no crossbar read" in r.engine_fallback_reason
    assert r.setup_record()["engine_fallback_reason"] \
        == r.engine_fallback_reason
    assert runner(engine="cuda",
                  dtype_policy="ternary").engine_fallback_reason is None


def test_edit_leaf_rows_touches_only_its_lanes(db, tmp_path):
    r = port_runner(solver_text(db, tmp_path))
    before = r.params["ip"][0].clone()

    def poison(row):
        row = np.array(row)
        row.flat[0] = np.nan
        return row
    new = np.full(tuple(before.shape[1:]), 0.5, np.float32)
    out = TSweep._edit_leaf_rows(r.params["ip"][0], {1: poison, 2: new})
    assert out is r.params["ip"][0]
    assert torch.equal(out[0], before[0])
    assert np.isnan(out[1].reshape(-1)[0].item())
    assert torch.equal(out[1].reshape(-1)[1:], before[1].reshape(-1)[1:])
    assert torch.equal(out[2], torch.from_numpy(new))
    with pytest.raises(ValueError, match="row of shape"):
        TSweep._edit_leaf_rows(out, {0: np.zeros(3, np.float32)})


@pytest.mark.parametrize("dtype,last", [("int16", 1024), ("int32", 10),
                                        ("int16", 7)])
def test_pack_state_of_tensors_equals_the_host_pack(dtype, last):
    """A runner's build packs its banks where the draw put them (on the
    card, no host round trip): tensors and host arrays give the same
    bytes as the reference's pack_state."""
    from rram_caffe_simulation_tpu.fault import packed as jpacked
    from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
    rng = np.random.RandomState(5)
    life = rng.normal(300.0, 400.0, (3, 6, last)).astype(np.float32)
    life.flat[:6] = [-0.3, -0.0, 0.0, -100.0, 100.0, 100.5]
    stuck = rng.randint(-1, 2, life.shape).astype(np.float32)
    spec = {"decrement": 100.0, "life_dtype": dtype}
    host = {"lifetimes": {"ip/0": life}, "stuck": {"ip/0": stuck}}
    tens = {g: {k: torch.from_numpy(v) for k, v in t.items()}
            for g, t in host.items()}
    got = tpacked.pack_state(tens, spec, device="cpu")
    want = tpacked.pack_state(host, spec, device="cpu")
    ref = jpacked.pack_state(host, spec)
    for group in ("life_q", "stuck_bits"):
        a, b = got[group]["ip/0"], want[group]["ip/0"]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()
        assert a.numpy().tobytes() == np.asarray(ref[group]["ip/0"]).tobytes()
    with pytest.raises(ValueError, match="do not fit"):
        tpacked.pack_state({"lifetimes": {"ip/0": torch.full((2,), 1e9)},
                            "stuck": {"ip/0": torch.zeros(2)}},
                           {"decrement": 100.0, "life_dtype": "int16"})
