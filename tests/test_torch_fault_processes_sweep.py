"""The port's SweepRunner, checkpoints, co-design reducers and both
example drivers under fault-process stacks, against the reference
package's, on the CPU.

- Lanes: a runner under read_disturb (kernel B1's mode "always", its
  plain version here) and under the drift stack (unfused) on the driver
  tests' one-InnerProduct net, ternary read, packed banks, against the
  reference's runner on engine "pallas" from the same draw: the draw bit
  for bit, then after every chunk the banks,
  ages and broken fractions bit for bit and the per-lane losses within
  1e-4 relative, as tests/test_torch_sweep.py holds them.
- Checkpoints: the v5 `fault_process` pin both ways between the
  packages, a mismatch refused in the reference's words, a v4 file
  upgraded as endurance.
- Refills: a self-healing refill's fresh rows (`_fresh_rows`) through
  the stack, bit for bit.
- Co-design: fault/codesign.py on the reference's own cases.
- The drivers: run_1000_sweep's resume pin compares canonical specs;
  run_codesign on a tiny grid (2 processes x 2 adc_bits x 2 lanes, 3
  iterations) against the reference's driver: the records' axes and
  `broken` equal, `loss` within 1e-4 relative (the one-InnerProduct
  net's GEMM), the report's keys and the exit code equal.
"""
import contextlib
import importlib.util
import io
import json
import os
import signal

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import codesign as jcodesign
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_1000_sweep as tdriver
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_codesign as tcodesign_driver
from rram_caffe_simulation_tpu_torch.fault import codesign as tcodesign
from rram_caffe_simulation_tpu_torch.observe import sink as tsink
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_group_prefetch import build_db, solver_text
from test_torch_sweep import MEANS, STDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIFT = "endurance_stuck_at+conductance_drift:nu=0.2,sigma=0.1"
REL = 1e-4


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def host(tree):
    return jax.tree.map(np.asarray, tree)


def tbytes(state):
    out = {}
    for group, leaves in state.items():
        for k, v in leaves.items():
            a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            out[f"{group}/{k}"] = (a.dtype.str, a.shape, a.tobytes())
    return out


def error_text(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _sp(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return sp


# ---------------------------------------------------------------------------
# lanes

@pytest.mark.parametrize("spec", ["read_disturb", DRIFT])
def test_lanes_equal_the_reference_runner(spec, tmp_path):
    """On the driver tests' one-InnerProduct net (its dataset on the
    device), against the reference's runner on engine "pallas", which
    gives a broken cell no gradient, as the port does (the drift stack's
    ages count writes)."""
    text = lmdb_text(tmp_path, "lanes")
    opts = dict(packed_state=True, dtype_policy="ternary", means=MEANS,
                stds=STDS)
    port = TSweep(TSolver(tproto.parse(text, "SolverParameter"),
                          device="cpu", fault_process=spec), 3,
                  engine="cuda", device="cpu", **opts)
    ref = JSweep(JSolver(_sp(text), fault_process=spec), 3,
                 engine="pallas", **opts)
    fused = spec == "read_disturb"
    assert port.fused_epilogue_resolved == ref.fused_epilogue_resolved \
        == fused
    assert port._step.fused_mode == ("always" if fused else None)
    if not fused:
        assert port.fused_epilogue_reason == ref.fused_epilogue_reason
    assert ref._pack_spec == port._pack_spec
    # the draw through the stack: bit for bit
    assert tbytes(port.fault_states) == tbytes(host(ref.fault_states))
    p, h, f = convert.sweep_state_to_jax(port)
    ref.params = jax.tree.map(jnp.asarray, p)
    ref.history = jax.tree.map(jnp.asarray, h)
    for _ in range(4):                              # 8 steps, chunk 2
        got = port.step(2, chunk=2)[0]
        want = np.asarray(ref.step(2, chunk=2)[0])
        np.testing.assert_allclose(got, want, rtol=REL)
        state = host(ref.fault_states)
        mine = tbytes(port.fault_states)
        for k, v in tbytes(state).items():
            if k.startswith(("life_q", "stuck_bits", "drift")):
                assert mine[k] == v, k
        # the same broken counts (the reference's fraction is float32
        # with x64 off, the port's the float64 of the same count)
        cells = sum(v[0].numel() for v in port.fault_states["life_q"].values())
        np.testing.assert_array_equal(
            np.rint(port.broken_fractions() * cells),
            np.rint(np.asarray(ref.broken_fractions(), np.float64) * cells))
    assert (port.broken_fractions() > 0.05).all()


# ---------------------------------------------------------------------------
# checkpoints

def lmdb_text(tmp_path, tag):
    return solver_text(build_db(tmp_path / f"db_{tag}"), tmp_path / tag)


def runners(tmp_path, tag, spec, n=3, packed=False):
    text = lmdb_text(tmp_path, tag)
    kw = dict(means=[200.0, 300.0, 400.0][:n], stds=[40.0, 50.0, 60.0][:n],
              pipeline_depth=0, packed_state=packed)
    return (lambda: TSweep(TSolver(tproto.parse(text, "SolverParameter"),
                                   device="cpu", fault_process=spec), n,
                           device="cpu", **kw),
            lambda: JSweep(JSolver(_sp(text), fault_process=spec), n, **kw))


def meta_of(path):
    with np.load(path) as z:
        return json.loads(bytes(bytearray(z["__meta__"])).decode())


def arrays_bytes(r):
    return {k: np.asarray(v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else v).tobytes()
        for k, v in r._state_arrays().items()}


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_checkpoint_pin_crosses_both_ways(tmp_path, packed):
    make_port, make_ref = runners(tmp_path, "c", DRIFT, packed=packed)
    port = make_port()
    port.step(4, chunk=2)
    ck = port.checkpoint(str(tmp_path / "port.ckpt.npz"))
    meta = meta_of(ck)
    assert meta["version"] == 6
    assert meta["fault_process"] == \
        "conductance_drift:nu=0.2,sigma=0.1+endurance_stuck_at"
    ref = make_ref()
    ref.restore(ck)
    assert arrays_bytes(ref) == arrays_bytes(port)
    back = ref.checkpoint(str(tmp_path / "ref.ckpt.npz"))
    assert meta_of(back)["fault_process"] == meta["fault_process"]
    port2 = make_port()
    port2.restore(back)
    assert arrays_bytes(port2) == arrays_bytes(port)
    # the restored port runner steps on as the one that wrote it
    np.testing.assert_array_equal(port2.step(2, chunk=2)[0],
                                  port.step(2, chunk=2)[0])
    assert arrays_bytes(port2) == arrays_bytes(port)
    for r in (port, port2, ref):
        r.close()


def test_checkpoint_process_mismatch_refused(tmp_path):
    make_rd, _ = runners(tmp_path, "m", "read_disturb")
    r = make_rd()
    r.step(2, chunk=2)
    ck = r.checkpoint(str(tmp_path / "rd.ckpt.npz"))
    make_port, make_ref = runners(tmp_path, "m", None)
    got = error_text(lambda: make_port().restore(ck))
    assert got is not None and "fault process" in got[1]
    assert got == error_text(lambda: make_ref().restore(ck))


def test_v4_checkpoint_upgrades_as_endurance(tmp_path):
    make_port, make_ref = runners(tmp_path, "v", None)
    r = make_port()
    r.step(4, chunk=2)
    ck = r.checkpoint(str(tmp_path / "v5.ckpt.npz"))
    want = r.step(2, chunk=2)[0]
    with np.load(ck) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(bytes(bytearray(data["__meta__"])).decode())
    meta["version"] = 4
    meta.pop("fault_process")
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    v4 = str(tmp_path / "v4.ckpt.npz")
    np.savez(v4, **data)
    r2 = make_port()
    r2.restore(v4)
    np.testing.assert_array_equal(r2.step(2, chunk=2)[0], want)
    make_rd, make_ref_rd = runners(tmp_path, "v", "read_disturb")
    got = error_text(lambda: make_rd().restore(v4))
    assert got is not None and "fault process" in got[1]
    assert got == error_text(lambda: make_ref_rd().restore(v4))


# ---------------------------------------------------------------------------
# refills

@pytest.mark.parametrize("spec", ["read_disturb", DRIFT,
                                  "permanent_fault_map:fraction=0.2"])
@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_refill_rows_equal_the_reference(tmp_path, spec, packed):
    make_port, make_ref = runners(tmp_path, "h", spec, packed=packed)
    port, ref = make_port(), make_ref()
    for cfg, attempt in ((1, 2), (5, 1)):
        got = port._fresh_rows(cfg, attempt)
        want = ref._fresh_rows(cfg, attempt)
        assert sorted(got) == sorted(want)
        fault = [k for k in want if k.startswith("fault/")]
        assert any(k.startswith("fault/drift_age/") for k in fault) == \
            ("drift" in spec)
        for k in fault:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    # self-healing over the stack finishes
    port.enable_self_healing(budget=6, max_retries=1)
    while not port.healing_complete():
        port.step(2, chunk=2)
    assert sorted(port.config_report()["completed"]) == [0, 1, 2]


# ---------------------------------------------------------------------------
# the runner's refusal and records

def test_packed_state_refused_for_a_decay_only_stack(tmp_path):
    make_port, make_ref = runners(tmp_path, "p", "conductance_drift:nu=0.2",
                                  packed=True)
    got = error_text(make_port)
    assert got is not None and "packed_state" in got[1]
    assert got == error_text(make_ref)


@pytest.mark.parametrize("spec", [
    None, "conductance_drift:nu=0.2+endurance_stuck_at",
    "permanent_fault_map:fraction=0.05", "read_disturb:reads_per_step=400"])
def test_setup_record_fault_model_equals_the_reference(spec, tmp_path):
    make_port, make_ref = runners(tmp_path, "s", spec)
    t, j = make_port(), make_ref()
    trec, jrec = t.setup_record(), j.setup_record()
    assert trec["fault_model"] == jrec["fault_model"]
    assert ("fault model " + jrec["fault_model"]["spec"]) in \
        tsink.setup_line(trec)
    assert t._process_canonical() == j._process_canonical()


# ---------------------------------------------------------------------------
# co-design reducers, on the reference's own cases

PARETO = [
    {"loss": 1.0, "bits": 8, "tag": "hi"},
    {"loss": 2.0, "bits": 2, "tag": "lo"},
    {"loss": 2.5, "bits": 2, "tag": "dominated"},
    {"loss": 1.5, "bits": 8, "tag": "dominated2"},
    {"loss": float("nan"), "bits": 2, "tag": "failed"},
    {"bits": 4, "tag": "no-loss"},
]


def test_codesign_grid_and_grouping():
    axes = {"process": ["a", "b"], "adc_bits": [2, 4],
            "mean": [100.0, 200.0], "std": [10.0],
            "tiles": ["1x1", "cells=128x128"]}
    grid = tcodesign.expand_grid(axes)
    assert grid == jcodesign.expand_grid(axes)
    assert len(grid) == 16
    groups = tcodesign.group_static(grid)
    assert groups == jcodesign.group_static(grid)
    assert len(groups) == 8 and all(len(v) == 2 for v in groups.values())
    assert tcodesign.static_key({"tiles": "2X2"}) == \
        jcodesign.static_key({"tiles": "2X2"})
    assert tcodesign.STATIC_AXES == jcodesign.STATIC_AXES
    assert tcodesign.LANE_AXES == jcodesign.LANE_AXES
    for bad in ({"sigma": []}, {"sigma": 0.1}):
        got = error_text(lambda: tcodesign.expand_grid(bad))
        assert got is not None and "non-empty" in got[1]
        assert got == error_text(lambda: jcodesign.expand_grid(bad))
    assert error_text(lambda: tcodesign.static_key({"tiles": "bogus"})) \
        == error_text(lambda: jcodesign.static_key({"tiles": "bogus"}))


@pytest.mark.parametrize("kw", [{}, {"maximize_x": True, "maximize_y": True},
                                {"maximize_y": True}])
def test_codesign_pareto_front_and_report(kw, tmp_path):
    front, dominated = tcodesign.pareto_front(PARETO, "loss", "bits", **kw)
    assert (front, dominated) == jcodesign.pareto_front(PARETO, "loss",
                                                        "bits", **kw)
    for recs in (PARETO, PARETO[:1], PARETO[:2]):
        got = tcodesign.make_report(recs, "loss", "bits", **kw)
        want = jcodesign.make_report(recs, "loss", "bits", **kw)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
    front, dominated = tcodesign.pareto_front(PARETO, "loss", "bits")
    assert [r["tag"] for r in front] == ["hi", "lo"] and dominated == 2
    tiled = [dict(r, tiles=t) for r, t in zip(PARETO[:2], ["2x2", "1X1"])]
    axes = {"tiles": ["2x2", "1x1"]}
    assert tcodesign.make_report(tiled, "loss", "bits", axes=axes) == \
        jcodesign.make_report(tiled, "loss", "bits", axes=axes)
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in PARETO[:3]) + "\n\n")
    assert tcodesign.load_results(str(path)) == \
        jcodesign.load_results(str(path))
    assert tcodesign.collapsed_axes(tiled, tiled[:1]) == \
        jcodesign.collapsed_axes(tiled, tiled[:1]) == ["tiles"]


# ---------------------------------------------------------------------------
# the drivers

def run_main(main, argv):
    """(exit code, stdout) of a driver's main(argv), the working
    directory and the SIGTERM/SIGINT handlers restored."""
    cwd = os.getcwd()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    out = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    except SystemExit as e:
        code = e.code
    finally:
        os.chdir(cwd)
        for s, h in handlers.items():
            signal.signal(s, h)
    return code, out.getvalue()


@pytest.fixture(scope="module")
def driver_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("procdriver")
    db = build_db(root / "db")
    path = root / "solver.prototxt"
    path.write_text(solver_text(db, root, fault=False))
    return {"root": root, "solver": str(path),
            "fault_solver": _fault_solver_file(root, db)}


def _fault_solver_file(root, db):
    path = root / "fault_solver.prototxt"
    path.write_text(solver_text(db, root))
    return str(path)


def test_driver_resume_pins_the_canonical_spec(driver_inputs, tmp_path,
                                               capsys):
    d = tmp_path / "run"
    argv = ["--device", "cpu", "--solver", driver_inputs["solver"],
            "--configs", "2", "--group", "2", "--block", "0", "--iters",
            "4", "--chunk", "2", "--mean", "300", "--std", "60",
            "--pipeline-depth", "0", "--run-dir", str(d)]
    code, _ = run_main(tdriver.main, argv + [
        "--process", "endurance_stuck_at+conductance_drift:nu=0.2"])
    assert code == 0
    with open(d / "manifest.json") as f:
        assert json.load(f)["process"] == \
            "conductance_drift:nu=0.2+endurance_stuck_at"
    for other in ("read_disturb", "conductance_drift:nu=0.3"
                  "+endurance_stuck_at", "conductance_drift:nu=0.2"):
        code, _ = run_main(tdriver.main, ["--device", "cpu", "--resume",
                                          str(d), "--process", other])
        assert code == 2, other
        assert "manifest pin" in capsys.readouterr().err
    for same in ("conductance_drift:nu=0.20+endurance_stuck_at",
                 "endurance_stuck_at + conductance_drift:nu=2e-1"):
        code, out = run_main(tdriver.main, ["--device", "cpu", "--resume",
                                            str(d), "--process", same])
        assert code == 0, same
        assert "Resuming" in out


@pytest.fixture(scope="module")
def codesign_runs(driver_inputs):
    spec = importlib.util.spec_from_file_location(
        "reference_run_codesign",
        os.path.join(REPO, "examples", "gaussian_failure",
                     "run_codesign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = driver_inputs["root"]
    argv = ["--solver", driver_inputs["fault_solver"], "--processes",
            "endurance_stuck_at,read_disturb", "--adc-bits", "0,4",
            "--means", "300,500", "--stds", "60", "--iters", "3",
            "--chunk", "3"]
    runs = {}
    with jax.enable_x64(False):
        runs["reference"] = run_main(mod.main, argv + [
            "--out", str(root / "cd_ref")]) + (str(root / "cd_ref"),)
    runs["port"] = run_main(tcodesign_driver.main, argv + [
        "--device", "cpu", "--out", str(root / "cd_port")]) + (
            str(root / "cd_port"),)
    return runs


def test_codesign_driver_equals_the_reference(codesign_runs):
    (pc, pout, pdir), (rc, _, rdir) = (codesign_runs["port"],
                                       codesign_runs["reference"])
    assert pc == rc and pc in (0, 65)
    pres = tcodesign.load_results(os.path.join(pdir, "results.jsonl"))
    rres = tcodesign.load_results(os.path.join(rdir, "results.jsonl"))
    assert len(pres) == len(rres) == 8
    axes = ("process", "sigma", "adc_bits", "strategy", "tiles", "mean",
            "std", "adc_cost_bits")
    for a, b in zip(pres, rres):
        assert sorted(a) == sorted(b)
        assert {k: a[k] for k in axes} == {k: b[k] for k in axes}
        assert np.float32(a["broken"]) == np.float32(b["broken"])
        assert a["loss"] == pytest.approx(b["loss"], rel=REL)
    assert any(r["broken"] > 0 for r in pres)
    reports = []
    for d in (pdir, rdir):
        with open(os.path.join(d, "pareto_report.json")) as f:
            reports.append(json.load(f))
    assert sorted(reports[0]) == sorted(reports[1])
    for k in ("schema_version", "evaluated", "axes", "metric_x",
              "metric_y", "front_size", "degenerate"):
        assert reports[0][k] == reports[1][k], k
    assert "Pareto front" in pout and "engine: no crossbar read" in pout


def test_codesign_driver_usage_errors(driver_inputs, tmp_path):
    code, _ = run_main(tcodesign_driver.main, [
        "--device", "cpu", "--solver", driver_inputs["fault_solver"],
        "--adc-bits", "1", "--out", str(tmp_path / "x")])
    assert code == 2
    with pytest.raises(KeyError, match="Unknown fault process"):
        run_main(tcodesign_driver.main, [
            "--device", "cpu", "--processes", "bit_rot",
            "--out", str(tmp_path / "y")])
