"""The port's `debug_info` deep trace, numeric sentinels and watchdog
(observe/debug.py, the capture points of net/builder.py, the Solver's
and the SweepRunner's side) against the reference package's, on the
same prototxt and seed (the RNG bridge gives both packages the same
params and fault state) and the same numpy batch.

Held, after the reference's tests/test_debug_trace.py (:104-277, :384,
:464, :489, :531, :544) and the sweep's watchdog of
tests/test_sweep_durability.py (:341-402):
- the lines a Solver prints and the `debug_trace` records it logs: the
  names and their order equal the reference's exactly, every value
  within REL = 1e-5 relative of the reference's (the two packages sum
  the products in other orders; f32 rounding), or ABS = 1e-7 where the
  value is rounding of a zero; a printed value (6 significant digits)
  also within one unit of its last digit. The values equal a numpy
  recomputation of the reductions too (rtol 2e-4, as the reference's
  own test);
- debug off runs the same operations as a solver without debug_info;
- the sentinel records, the CaffeLogSink lines, the watchdog's halt,
  snapshot and overflow trip, the loss-phase record, the in-place data
  top, and the sweep's per-lane sentinels, quarantine, watchdog halt
  and snapshot: the reference's text and fields (but wall times and
  paths).
The data-parallel, model-parallel, step_fused and CLI cases of the
reference's file (:286, :343, :403, :427) have no port counterpart yet.

The sweep's debug vectors, sentinel state and watchdog are held in
tests/test_torch_debug_trace_sweep.py."""
import math
import re

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.observe import schema as jschema
from rram_caffe_simulation_tpu.observe import sink as jsink
from rram_caffe_simulation_tpu.observe.debug import \
    NetDebugSpec as JNetDebugSpec
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.observe import debug as tdebug
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.observe import sink as tsink
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

REL = 1e-5
ABS = 1e-7
NUM = re.compile(r"-?(?:nan|inf|\d+(?:\.\d*)?(?:e[+-]?\d+)?)")

DEBUG_NET = """name: "DebugNet"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.5 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 3
    weight_filler { type: "gaussian" std: 0.5 }
    bias_filler { type: "constant" value: 0.0 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2"
  bottom: "label" top: "loss" }
"""
INPLACE_NET = """name: "InplaceData"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "relu0" type: "ReLU" bottom: "data" top: "data" }
layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  inner_product_param { num_output: 3
    weight_filler { type: "gaussian" std: 0.5 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc1"
  bottom: "label" top: "loss" }
"""


def batch(seed=3):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(8, 6).astype(np.float32),
            "label": rng.randint(0, 3, 8).astype(np.float32)}


def solver_text(prefix, net=DEBUG_NET, debug=True, fault=True, lr=0.05,
                extra=""):
    text = (f'net_param {{ {net} }} base_lr: {lr} lr_policy: "fixed" '
            f'momentum: 0.9 display: 0 max_iter: 100 random_seed: 7 '
            f'snapshot_prefix: "{prefix}" {extra}')
    if fault:
        text += ' failure_pattern { type: "gaussian" mean: 250 std: 30 }'
    if debug:
        text += " debug_info: true"
    return text


def port_solver(text, b=None):
    b = batch() if b is None else b
    return TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                   train_feed=lambda: b)


def ref_solver(text, b=None):
    b = batch() if b is None else b
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        return JSolver(sp, train_feed=lambda: b)


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def debug_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("    [Forward]", "    [Backward]",
                              "    [Update]"))]


def close(a: float, b: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= max(REL * max(abs(a), abs(b)), ABS)


def assert_lines_equal(got, want):
    """Same text with the numbers taken out, in the same order; each
    number within REL (ABS near zero), or one unit of its printed 6th
    significant digit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        for x, y in zip(NUM.findall(g), NUM.findall(w)):
            fx, fy = float(x), float(y)
            unit = 10.0 ** (math.floor(math.log10(max(abs(fx), abs(fy),
                                                      1e-300))) - 5)
            assert close(fx, fy) or abs(fx - fy) <= unit * 1.0001, (g, w)


def assert_records_equal(got: dict, want: dict, path=""):
    """Two records' fields, wall times aside: names and strings exactly,
    floats within REL (ABS near zero)."""
    if isinstance(want, dict):
        keys = set(want) - {"wall_time"}
        assert set(got) - {"wall_time"} == keys, (path, sorted(got),
                                                  sorted(want))
        for k in keys:
            assert_records_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_records_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert close(float(got), float(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


def run_both(tmp_path, capsys, text, steps, setup=None):
    """The port's and the reference's Solver from `text`, `steps`
    steps each, with a ListSink and `setup(solver)` applied to both;
    returns ((port, stdout, sink), (reference, stdout, sink))."""
    out = []
    for make in (port_solver, ref_solver):
        s = make(text)
        sink = ListSink()
        s.param.display = 1
        s.enable_metrics(sink)
        if setup is not None:
            setup(s)
        capsys.readouterr()
        with jax.enable_x64(False):
            s.step(steps)
        out.append((s, capsys.readouterr().out, sink))
    return out


# ---------------------------------------------------------------------------
# the Solver's lines and records

def test_debug_lines_and_records_equal_the_reference(tmp_path, capsys):
    (ts, tout, tsink_), (js, jout, jsink_) = run_both(
        tmp_path, capsys, solver_text(str(tmp_path / "s")), 3)
    got, want = debug_lines(tout), debug_lines(jout)
    # 2 data tops, fc1 (top + 2 params), relu1, fc2 (top + 2), loss; 2
    # bottoms, 4 params; all-params; 4 updates: 22 a step
    assert len(want) == 3 * 22
    assert_lines_equal(got, want)
    trec = [r for r in tsink_.records if r.get("type") == "debug_trace"]
    jrec = [r for r in jsink_.records if r.get("type") == "debug_trace"]
    assert [r["iter"] for r in trec] == [0, 1, 2]
    for a, b in zip(trec, jrec):
        assert tschema.validate_record(a) == []
        assert jschema.validate_record(a) == []
        assert_records_equal(a, b)
    assert not any(r.get("type") == "sentinel" for r in tsink_.records)
    assert ts.debug_spec.fault == ts._fault_keys == js.debug_spec.fault
    for attr in ("fwd", "bwd", "update", "probe_sites"):
        assert getattr(ts.debug_spec, attr) == getattr(js.debug_spec, attr)


def test_debug_values_equal_numpy(tmp_path, capsys):
    """The first step's values against a numpy recomputation of the
    same reductions (no fault engine: the read is the stored weight)."""
    s = port_solver(solver_text(str(tmp_path / "s"), fault=False))
    W1, b1 = (s.params["fc1"][i].numpy().copy() for i in (0, 1))
    W2, b2 = (s.params["fc2"][i].numpy().copy() for i in (0, 1))
    capsys.readouterr()
    s.step(1)
    lines = debug_lines(capsys.readouterr().out)
    x, lab = batch()["data"], batch()["label"].astype(int)
    h = x @ W1.T + b1
    r = np.maximum(h, 0)
    z = r @ W2.T + b2
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    loss = -np.log(p[np.arange(8), lab]).mean()
    dz = p.copy()
    dz[np.arange(8), lab] -= 1
    dz /= 8
    gW2, gb2 = dz.T @ r, dz.sum(0)
    dr = dz @ W2
    dh = dr * (h > 0)
    gW1, gb1 = dh.T @ x, dh.sum(0)
    ma = lambda a: float(np.abs(a).mean())
    params = (W1, b1, W2, b2)
    grads = (gW1, gb1, gW2, gb2)
    want = ([ma(x), ma(lab), ma(h), ma(W1), ma(b1), ma(r), ma(z), ma(W2),
             ma(b2), loss, ma(dz), ma(dr), ma(gW2), ma(gb2), ma(dh),
             ma(gW1), ma(gb1),
             sum(np.abs(a).sum() for a in params),
             sum(np.abs(a).sum() for a in grads),
             math.sqrt(sum((a ** 2).sum() for a in params)),
             math.sqrt(sum((a ** 2).sum() for a in grads))]
            + [v for a, g in zip(params, grads)
               for v in (ma(a), 0.05 * ma(g))])
    got = []
    for ln in lines:
        if "All net params" in ln:
            got += [float(v) for pair in re.findall(
                r"= \(([^,]+), ([^)]+)\)", ln) for v in pair]
        else:
            got += [float(v) for v in re.findall(
                r"(?:data|diff): ([^;\s]+)", ln)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)


def test_debug_off_runs_the_same_operations(tmp_path):
    """debug_info with the trace off builds the step a solver without
    debug_info builds: the same aten operations, in the same order (the
    port's counterpart of the reference's equal jaxprs), and a step of
    five values; on, the trace adds operations and a sixth value."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def ops_of(step, s):
        args = (s.params, s.history, s.fault_state,
                {k: torch.from_numpy(v) for k, v in batch().items()}, 0,
                step.noise.step_key(s._key, 0))
        with Ops() as mode:
            out = step(*args)
        return mode.ops, out
    plain = port_solver(solver_text(str(tmp_path / "a"), debug=False))
    traced = port_solver(solver_text(str(tmp_path / "b")))
    ops_plain, out_plain = ops_of(plain.make_train_step(), plain)
    ops_off, out_off = ops_of(traced.make_train_step(with_debug=False),
                              traced)
    ops_on, out_on = ops_of(traced.make_train_step(), traced)
    assert ops_plain == ops_off
    assert len(out_plain) == len(out_off) == 5
    assert len(ops_on) > len(ops_off) and len(out_on) == 6
    assert sorted(out_on[5]["debug"]) == ["bwd", "fault", "fwd", "loss",
                                          "norms", "sentinel", "upd_data",
                                          "upd_diff"]


def test_sentinel_tree_and_lanes():
    """sentinel_tree's flags and first bad entries, per lane, on the
    reference's rule (nan, inf, finite above 1e30)."""
    v = torch.tensor([[1.0, float("nan"), 2.0, float("inf")],
                      [1.0, 2.0, 1e31, 3.0],
                      [1.0, 2.0, 3.0, 4.0]])
    empty = torch.zeros((3, 0))
    tree = tdebug.sentinel_tree({"forward": v, "backward": empty,
                                 "update": v.flip(-1), "fault": empty})
    assert tree["first"].tolist() == [[1, -1, 0, -1], [2, -1, 1, -1],
                                      [-1, -1, -1, -1]]
    assert tree["nan"].tolist() == [[1, 0, 1, 0], [0, 0, 0, 0],
                                    [0, 0, 0, 0]]
    assert tree["inf"][:, 0].tolist() == [1, 0, 0]
    assert tree["ovf"][:, 2].tolist() == [0, 1, 0]


def test_caffe_sink_writes_the_reference_debug_lines(tmp_path, capsys):
    text = solver_text(str(tmp_path / "s"))
    payloads = []
    for make, name in ((port_solver, "p.log"), (ref_solver, "r.log")):
        s = make(text)
        s.param.display = 1
        mod = tsink if make is port_solver else jsink
        path = str(tmp_path / name)
        s.enable_metrics(mod.CaffeLogSink(path, net_name=s.net.name))
        with jax.enable_x64(False):
            s.step(2)
        s.metrics_logger.close()
        payloads.append([ln.split("] ", 1)[1] for ln in
                         open(path).read().splitlines() if "] " in ln])
    got, want = payloads
    assert len([ln for ln in want if ln.startswith("    [Forward]")]) == 20
    assert_lines_equal(got, want)


def test_debug_trace_lines_and_sentinel_line_equal_the_reference():
    rec = {
        "type": "debug_trace", "iter": 0,
        "forward": [{"layer": "a", "kind": "top", "blob": "x",
                     "value": 1.5}],
        "backward": [{"layer": "a", "kind": "param", "blob": "0",
                      "value": 0.25}],
        "update": [{"layer": "a", "param": "0", "data": 1.0,
                    "diff": 0.125}],
        "params_l1": [2.0, 1.0], "params_l2": [1.5, 0.5],
    }
    assert tsink.debug_trace_lines(rec) == jsink.debug_trace_lines(rec) == [
        "    [Forward] Layer a, top blob x data: 1.5",
        "    [Backward] Layer a, param blob 0 diff: 0.25",
        "    [Backward] All net params (data, diff): "
        "L1 norm = (2, 1); L2 norm = (1.5, 0.5)",
        "    [Update] Layer a, param 0 data: 1; diff: 0.125",
    ]
    for sent in ({"type": "sentinel", "iter": 3, "phase": "forward",
                  "entry": "layer fc2, top blob fc2", "nan": True,
                  "inf": False, "overflow": False},
                 {"type": "sentinel", "iter": 4, "phase": "loss",
                  "nan": False, "inf": True, "overflow": False}):
        assert tsink.sentinel_line(sent) == jsink.sentinel_line(sent)


def test_sentinel_record_loss_phase_validates():
    summ = {"tripped": False, "phase": None, "entry": None,
            "flags": {"nan": False, "inf": False, "overflow": False},
            "loss": float("inf")}
    rec = tdebug.NetDebugSpec.sentinel_record(None, 3, summ)
    want = JNetDebugSpec.sentinel_record(None, 3, summ)
    assert rec["phase"] == "loss" and "entry" not in rec
    assert_records_equal(rec, want)
    assert tschema.validate_record(rec) == []


def test_inplace_layer_on_data_top_does_not_alias_data_line(tmp_path,
                                                            capsys):
    text = solver_text(str(tmp_path / "s"), net=INPLACE_NET, fault=False)
    outs = []
    for make in (port_solver, ref_solver):
        s = make(text)
        capsys.readouterr()
        with jax.enable_x64(False):
            s.step(1)
        outs.append(debug_lines(capsys.readouterr().out))
    assert_lines_equal(*outs)
    fwd = {}
    for ln in outs[0]:
        m = re.match(r"    \[Forward\] Layer (\S+), top blob (\S+) data: "
                     r"(\S+)$", ln)
        if m:
            fwd[(m.group(1), m.group(2))] = float(m.group(3))
    x = batch()["data"]
    np.testing.assert_allclose(fwd[("data", "data")], np.abs(x).mean(),
                               rtol=2e-4)
    np.testing.assert_allclose(fwd[("relu0", "data")],
                               np.maximum(x, 0).mean(), rtol=2e-4)


# ---------------------------------------------------------------------------
# the Solver's watchdog

def _poison(s, layer, value, at=(0, 0)):
    w = np.array(s.params[layer][0])
    w[at] = value
    s.params[layer][0] = (torch.from_numpy(w) if isinstance(
        s.params[layer][0], torch.Tensor) else jnp.asarray(w))


def _watchdog_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Watchdog", "Snapshotting"))]


@pytest.mark.parametrize("policy,layer,value", [
    ("halt", "fc2", np.nan), ("snapshot", "fc1", np.nan),
    ("halt", "fc2", np.inf), ("halt", "fc1", 1e35)])
def test_watchdog_trips_as_the_reference(tmp_path, capsys, policy, layer,
                                         value):
    """A poisoned weight trips the forward sentinel at the first layer
    that reads it: the port prints the reference's diagnostic, logs its
    sentinel record, stops after iteration 0, and under "snapshot"
    leaves a snapshot that restores with the poisoned weight."""
    runs = []
    for make, sub in ((port_solver, "p"), (ref_solver, "r")):
        (tmp_path / sub).mkdir()
        s = make(solver_text(str(tmp_path / sub / "snap"), debug=False))
        sink = ListSink()
        s.enable_metrics(sink)
        s.enable_watchdog(policy)
        _poison(s, layer, value)
        capsys.readouterr()
        with jax.enable_x64(False):
            s.step(4)
        assert s.iter == 1
        runs.append((_watchdog_lines(capsys.readouterr().out),
                     [r for r in sink.records
                      if r.get("type") == "sentinel"]))
    (got, grec), (want, wrec) = runs
    strip = lambda ls: [ln.replace(str(tmp_path / "p"), "D").replace(
        str(tmp_path / "r"), "D") for ln in ls]
    assert strip(got) == strip(want)
    assert f"forward phase, layer {layer}, top blob {layer}" in got[0]
    assert len(grec) == len(wrec) == 1
    assert tschema.validate_record(grec[0]) == []
    assert_records_equal(grec[0], wrec[0])
    snaps = list((tmp_path / "p").glob("snap*"))
    if policy == "halt":
        assert not snaps
    else:
        state = tmp_path / "p" / "snap_iter_0.solverstate"
        assert state.exists()
        s2 = port_solver(solver_text(str(tmp_path / "q"), debug=False))
        s2.restore(str(state))
        assert s2.iter == 0
        assert torch.isnan(s2.params["fc1"][0]).any()


def test_watchdog_on_a_poisoned_rate_names_the_update_phase(tmp_path,
                                                            capsys):
    text = solver_text(str(tmp_path / "s"), debug=False, lr="nan")
    s = port_solver(text)
    s.enable_watchdog("snapshot")
    s.step(5)
    out = capsys.readouterr().out
    assert "Watchdog tripped at iteration 0: update phase" in out
    assert (tmp_path / "s_iter_0.solverstate").exists()
    assert s.iter == 1


def test_enable_watchdog_after_step_built_raises(tmp_path):
    s = port_solver(solver_text(str(tmp_path / "s"), debug=False))
    s.step(1)
    with pytest.raises(ValueError, match="before"):
        s.enable_watchdog("halt")
    with pytest.raises(ValueError, match="unknown watchdog"):
        port_solver(solver_text(str(tmp_path / "t"))).enable_watchdog(
            "explode")
