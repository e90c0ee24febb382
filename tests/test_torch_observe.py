"""The port's telemetry (observe/: the record schema, the counters, the
sinks, the Solver's metrics) against the reference package's.

Held: the schema copy gives the reference's verdict on every record
here (and its source equals the reference's below the docstring); the
counters equal the reference's on the same arrays (integers exactly,
f32 within 1e-6 relative); a JsonlSink writes the reference's bytes and
a CaffeLogSink the reference's lines (below the glog prefix) for the
same records. The Solver's in-step metrics equal the reference's
jitted step with_metrics=True in lockstep on the narrow CIFAR net of
tests/test_torch_solver.py (each step starts both packages from the
reference's state and batch): every integer field exactly, every float
within 1e-6 relative (the gradient and update norms within 1e-5: the
packages' gradients part at f32 summation level), under no strategy
and under threshold (writes_saved), with f32 and packed banks, and
per_tile under a 2x2 tile spec. The records a port Solver writes
validate under the port's schema and under the reference's
scripts/check_metrics_schema.py, and
the first record (iteration 0, one seed, one state) equals the
reference Solver's. With `debug_info` both packages print the same
[Forward] / [Backward] / [Update] lines on that net (the tolerance of
tests/test_torch_debug_trace.py)."""
import ast
import copy
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.observe import counters as jcounters
from rram_caffe_simulation_tpu.observe import schema as jschema
from rram_caffe_simulation_tpu.observe import sink as jsink
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.observe import counters as tcounters
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.observe import sink as tsink
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_solver import REPO, SOLVER

REL = 1e-6
# the gradient and update norms: the two packages sum the convolutions'
# backward in other orders, so their gradients part at f32 summation
# level. The largest gaps these tests read are 4.97e-6 (grad_norm) and
# 1.01e-6 (update_norm), over the 50 norms of this file and
# tests/test_torch_health.py
NORM_REL = 6e-6
THRESHOLD = 0.05
TIMING = ("wall_time", "step_latency_s", "iters_per_s")


def close(a, b, path="", rel=None) -> list:
    """Differences between two host trees: integers (and their lists)
    exactly, floats within `rel` relative (default REL, NORM_REL for
    the norms)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a
                for d in close(a[k], b[k], f"{path}.{k}", rel)]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in close(x, y, f"{path}[{i}]", rel)]
    if isinstance(a, bool) or isinstance(b, bool) \
            or isinstance(a, str) or isinstance(b, str):
        return [] if a == b else [f"{path}: {a!r} != {b!r}"]
    if isinstance(a, int) and isinstance(b, int):
        return [] if a == b else [f"{path}: {a} != {b} (integer)"]
    if isinstance(a, int) != isinstance(b, int):
        return [f"{path}: {a!r} and {b!r} differ in type"]
    if math.isnan(a) and math.isnan(b):
        return []
    if rel is None:
        rel = NORM_REL if path.endswith(("grad_norm", "update_norm")) \
            else REL
    if abs(a - b) <= rel * max(abs(a), abs(b)):
        return []
    return [f"{path}: {a!r} vs {b!r}"]


# ---------------------------------------------------------------------------
# the schema

GOOD_METRICS = {
    "schema_version": 1, "iter": 100, "wall_time": 1.0, "loss": 0.8,
    "lr": 0.01, "step_latency_s": 0.01, "iters_per_s": 100.0, "seed": 3,
    "grad_norm": 2.0, "update_norm": 0.2, "outputs": {"loss": [0.8, 0.9]},
    "quarantine": [1], "lane_map": [0, 1],
    "fault": {"broken_total": [3, 4], "newly_expired": [1, 0],
              "life_min": [-50.0, 50.0], "life_mean": [1e3, 2e3],
              "writes_saved": [0, 7],
              "per_param": {"ip1/0": {"broken": [3, 4],
                                      "newly_expired": [1, 0],
                                      "life_min": [-50.0, 50.0],
                                      "life_mean": [1e3, 2e3]}},
              "per_process": {"endurance_stuck_at": {"broken": [3, 4]}},
              "per_tile": {"ip1/0": {"grid": [2, 2],
                                     "broken_frac": [0.1, 0.0, 0.2, 0.0],
                                     "life_min": [-5.0, 1.0, -2.0, 3.0],
                                     "stuck_neg": [1, 0, 2, 0],
                                     "stuck_zero": [0, 0, 0, 0],
                                     "stuck_pos": [1, 0, 0, 0]}}}}
GOOD_SETUP = {"schema_version": 1, "type": "setup", "wall_time": 1.0,
              "decode_seconds": 0.5, "compile_seconds": 12.0,
              "cache": {"compile": "miss", "dataset": "disabled"},
              "setup_seconds": 14.0, "engine": "cuda",
              "pipeline": {"depth": 2, "chunks": 3,
                           "host_blocked_seconds": 0.01, "records": 3,
                           "consumer_seconds": 0.2, "drain_seconds": 0.1},
              "bytes_per_step_est": 1000, "fault_state_format": "packed",
              "fault_model": {"spec": "endurance_stuck_at"}}
GOOD_HEALTH = {"schema_version": 1, "type": "health", "iter": 10,
               "wall_time": 1.0, "every": 10, "decrement": 100.0,
               "process": "endurance_stuck_at",
               "life_edges": [100.0, 1000.0],
               "params": {"ip1/0": {"grid": [1, 1], "cells": [8],
                                    "life_hist": [[1, 2, 3, 2]],
                                    "broken_frac": [0.125],
                                    "life_mean": [500.0],
                                    "stuck_neg": [1], "stuck_zero": [0],
                                    "stuck_pos": [0]}}}
GOOD_SPAN = {"schema_version": 1, "type": "span", "iter": 3,
             "wall_time": 1.0, "name": "dispatch", "cat": "sweep",
             "kind": "span", "dur_s": 0.5, "thread": "dispatcher",
             "process": 0, "args": {"k": 2}}


def _with(rec, **kw):
    out = copy.deepcopy(rec)
    out.update(kw)
    return out


RECORDS = {
    "metrics": GOOD_METRICS,
    "metrics-negative-iter": _with(GOOD_METRICS, iter=-1),
    "metrics-string-loss": _with(GOOD_METRICS, loss="x"),
    "metrics-float-count": _with(GOOD_METRICS, fault={"broken_total": 1.5}),
    "metrics-empty-vector": _with(GOOD_METRICS, lr=[]),
    "setup": GOOD_SETUP,
    "setup-bad-cache-state": _with(GOOD_SETUP, cache={"compile": "warm",
                                                      "dataset": "hit"}),
    "setup-negative-pipeline": _with(GOOD_SETUP, pipeline={
        "depth": 2, "chunks": 3, "host_blocked_seconds": -1.0}),
    "setup-bad-format": _with(GOOD_SETUP, fault_state_format="int4"),
    "health": GOOD_HEALTH,
    "health-no-params": {k: v for k, v in GOOD_HEALTH.items()
                         if k != "params"},
    "span": GOOD_SPAN,
    "span-bad-kind": _with(GOOD_SPAN, kind="begin"),
    "span-negative-duration": _with(GOOD_SPAN, dur_s=-0.1),
    "unknown-type": {"schema_version": 1, "type": "nope"},
    "wrong-version": _with(GOOD_METRICS, schema_version=2),
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_schema_copy_gives_the_reference_verdict(name):
    rec = RECORDS[name]
    assert tschema.validate_record(rec) == jschema.validate_record(rec)
    assert bool(jschema.validate_record(rec)) == ("-" in name)


def test_schema_copy_equals_the_reference_below_its_docstring():
    """The same program (comments aside: the copy drops the reference
    project's issue numbers)."""
    def body(mod):
        tree = ast.parse(open(mod.__file__).read())
        assert isinstance(tree.body[0].value, ast.Constant)
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))
    assert body(tschema) == body(jschema)


# ---------------------------------------------------------------------------
# the counters

def _arrays(seed, shapes=((6, 5), (5,), (3, 4))):
    rng = np.random.RandomState(seed)
    return {f"p{i}/0": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def test_counters_mean_abs_and_global_norm_equal_the_reference():
    a = _arrays(1)
    for v in a.values():
        assert float(tcounters.mean_abs(torch.from_numpy(v))) == \
            pytest.approx(float(jcounters.mean_abs(jnp.asarray(v))),
                          rel=REL)
    got = float(tcounters.global_norm_sq(
        {k: torch.from_numpy(v) for k, v in a.items()}))
    want = float(jcounters.global_norm_sq(
        {k: jnp.asarray(v) for k, v in a.items()}))
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("with_life", [False, True])
def test_write_traffic_saved_equals_the_reference(with_life):
    before = _arrays(2)
    after = {k: np.where(np.abs(v) < 0.7, 0.0, v).astype(np.float32)
             for k, v in before.items()}
    life = {k: np.random.RandomState(3).randint(-2, 3, v.shape)
            .astype(np.float32) for k, v in before.items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    got = tcounters.write_traffic_saved(
        t(before), t(after), tengine.EPSILON32,
        lifetimes=t(life) if with_life else None)
    want = jcounters.write_traffic_saved(
        j(before), j(after), 1e-20, lifetimes=j(life) if with_life else None)
    assert int(got) == int(want) > 0
    # per lane: the lanes' counts, each the reference's on its slice
    lanes = tcounters.write_traffic_saved(
        {k: torch.stack([v, v * 0]) for k, v in t(before).items()},
        {k: torch.stack([v, v * 0]) for k, v in t(after).items()},
        tengine.EPSILON32, lanes=2)
    assert lanes.tolist() == [int(jcounters.write_traffic_saved(
        j(before), j(after), 1e-20)), 0]


def test_to_host_equals_the_reference():
    tree = {"i": np.int32(7), "f": np.float32(0.1),
            "v": np.arange(3, dtype=np.int32),
            "m": np.full((2, 2), 0.3, np.float32),
            "n": {"x": np.float32(-2.5)}}
    want = jcounters.to_host(jax.tree.map(jnp.asarray, tree))
    got = tcounters.to_host(jax.tree.map(torch.from_numpy,
                                         jax.tree.map(np.asarray, tree)))
    assert got == want
    assert isinstance(got["i"], int) and isinstance(got["f"], float)


# ---------------------------------------------------------------------------
# the sinks

SINK_RECORDS = {
    "metrics": jsink.make_record(3, {"loss": 0.5, "lr": 0.01,
                                     "grad_norm": 1.5, "fault": {
                                         "broken_total": 4}},
                                 smoothed_loss=0.6, outputs={
                                     "loss": 0.5, "acc": [0.1, 0.2]},
                                 elapsed_s=2.0, n_iters=4, seed=9,
                                 quarantine=[2]),
    "sweep-metrics": jsink.make_record(5, {"loss": [0.5, 0.7],
                                           "lr": [0.01, 0.01]},
                                       outputs={"loss": [0.5, 0.7]},
                                       elapsed_s=1.0, n_iters=2),
    "setup": jsink.make_setup_record(0.5, 12.25, "miss", "disabled",
                                     setup_s=14.0, pipeline={
                                         "depth": 2, "chunks": 3,
                                         "host_blocked_seconds": 0.01}),
    "health": GOOD_HEALTH,
    "span": GOOD_SPAN,
}


@pytest.mark.parametrize("name", sorted(SINK_RECORDS))
def test_sinks_write_the_reference_lines(name, tmp_path):
    rec = SINK_RECORDS[name]
    out = {}
    for tag, mod in (("j", jsink), ("t", tsink)):
        js = mod.JsonlSink(str(tmp_path / f"{tag}.jsonl"))
        cs = mod.CaffeLogSink(str(tmp_path / f"{tag}.log"), net_name="n")
        logger = mod.MetricsLogger([js, cs])
        logger.log(rec)
        logger.close()
        text = open(tmp_path / f"{tag}.log").read().splitlines()
        out[tag] = (open(tmp_path / f"{tag}.jsonl").read(),
                    [line.split("] ", 1)[1] for line in text])
    assert out["t"] == out["j"]
    assert len(out["t"][1]) >= 2          # the banner and the record


def test_setup_record_has_the_reference_fields_and_the_engine():
    want = jsink.make_setup_record(
        0.5, 12.25, "miss", "disabled", setup_s=14.0,
        pipeline={"depth": 0, "chunks": 1, "host_blocked_seconds": 0.5},
        bytes_per_step_est=100, fault_state_format="packed",
        fault_model={"spec": "endurance_stuck_at"}, conv_im2col="implicit",
        conv_im2col_reason="why", conv_patch_bytes=64)
    got = tsink.make_setup_record(
        0.5, 12.25, "miss", "disabled", setup_s=14.0,
        pipeline={"depth": 0, "chunks": 1, "host_blocked_seconds": 0.5},
        bytes_per_step_est=100, fault_state_format="packed",
        fault_model={"spec": "endurance_stuck_at"}, engine="cuda",
        conv_im2col="implicit", conv_im2col_reason="why",
        conv_patch_bytes=64)
    assert got.pop("engine") == "cuda"
    assert {k: v for k, v in got.items() if k != "wall_time"} == \
        {k: v for k, v in want.items() if k != "wall_time"}


# ---------------------------------------------------------------------------
# the Solver's metrics, in lockstep with the reference's

def solver_text(strategy: bool):
    return SOLVER + (f' failure_strategy {{ type: "threshold" threshold: '
                     f'{THRESHOLD} }}' if strategy else "")


CASES = [("f32", False, None), ("f32", True, None), ("packed", False, None),
         ("packed", True, None), ("f32", False, "2x2"),
         ("packed", True, "2x2")]


@pytest.mark.parametrize("fmt,strategy,tiles", CASES)
def test_solver_metrics_equal_the_reference_in_lockstep(monkeypatch, fmt,
                                                        strategy, tiles):
    monkeypatch.chdir(REPO)
    text = solver_text(strategy)
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]), tile_spec=tiles)
        state = {g: {k: np.asarray(v) for k, v in leaves.items()}
                 for g, leaves in js.fault_state.items()}
        opts = dict(fault_format=fmt)
        if fmt == "packed":
            spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                          pattern=sp.failure_pattern)
            state = jpacked.pack_state(state, spec)
            opts["pack_spec"] = spec
        jstep = jax.jit(js.make_train_step(with_metrics=True, **opts))
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 fault_format=fmt, tile_spec=tiles)
    step = ts.make_train_step(hw_engine="torch", with_metrics=True,
                              **dict(opts, pack_spec=ts.pack_spec))
    assert step.with_metrics and ts.pack_spec == opts.get("pack_spec")
    params, hist = js.params, js.history
    jstate = jax.tree.map(jnp.asarray, state)
    saved = 0
    for it in range(4):
        ts.params = convert.params_from_jax(
            {k: [np.asarray(a) for a in v] for k, v in params.items()})
        ts.history = {k: {s: torch.from_numpy(np.array(a)) for s, a in
                          v.items()} for k, v in hist.items()}
        ts.fault_state = convert.fault_state_from_jax(
            jax.tree.map(np.asarray, jstate))
        batch = {k: np.asarray(v) for k, v in js.train_feed().items()}
        with jax.enable_x64(False):
            params, hist, jstate, _, _, jm = jstep(
                params, hist, jstate,
                {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.int32(it), jax.random.fold_in(js._key, it), False)
            want = jcounters.to_host(jm)
        out = step(ts.params, ts.history, ts.fault_state,
                   {k: torch.from_numpy(v) for k, v in batch.items()}, it,
                   prng.fold_in(ts._key, it))
        got = tcounters.to_host(out[5])
        assert close(got, want) == [], it
        assert ("per_tile" in got["fault"]) == (tiles is not None)
        saved += got["fault"]["writes_saved"]
    assert (saved > 0) == strategy
    assert got["fault"]["broken_total"] > 0


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_solver_records_validate_and_equal_the_reference(monkeypatch,
                                                         tmp_path):
    """Both Solvers from one prototxt and seed (the same params and
    fault state), metrics to a JsonlSink, display 1, two steps; health
    every step. The first record (iteration 0: one state, one batch)
    equals the reference's within REL, timing aside; every port record
    validates under both schemas, through the reference's script too."""
    monkeypatch.chdir(REPO)
    text = solver_text(True).replace("display: 0", "display: 1")
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
        js.enable_metrics(jsink.JsonlSink(str(tmp_path / "j.jsonl")))
        js.step(1)
        js.metrics_logger.close()
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    path = str(tmp_path / "t.jsonl")
    ts.enable_metrics(tsink.JsonlSink(path))
    ts.enable_health(1)
    ts.step(2)
    ts.metrics_logger.close()
    recs = _records(path)
    assert [r.get("type") for r in recs] == [None, None, "health"]
    for r in recs:
        assert tschema.validate_record(r) == []
        assert jschema.validate_record(r) == []
    strip = lambda r: {k: v for k, v in r.items() if k not in TIMING}
    assert close(strip(recs[0]), strip(_records(tmp_path / "j.jsonl")[0])) \
        == []
    assert recs[0]["seed"] == ts.seed and "seed" not in recs[1]
    script = os.path.join(REPO, "scripts", "check_metrics_schema.py")
    r = subprocess.run([sys.executable, script, path], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("fmt,strategy", [("f32", True), ("packed", True),
                                          ("packed", False)])
def test_a_step_no_record_reads_carries_writes_saved_alone(fmt, strategy):
    """record=False gives the state of record=True bit for bit, and a
    tree of `fault.writes_saved` alone (empty without a threshold)."""
    ts = TSolver(tproto.parse(solver_text(strategy), "SolverParameter"),
                 device="cpu", fault_format=fmt)
    step = ts.make_train_step(hw_engine="torch", with_metrics=True,
                              fault_format=fmt, pack_spec=ts.pack_spec)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in ts.train_feed().items()}
    full, light = (step(ts.params, ts.history, ts.fault_state, batch, 0,
                        prng.fold_in(ts._key, 0), record=rec)
                   for rec in (True, False))
    got = lambda out: tcounters.to_host(list(out[:5]))
    assert got(full) == got(light)
    if strategy:
        assert light[5] == {"fault": {"writes_saved":
                                      full[5]["fault"]["writes_saved"]}}
    else:
        assert light[5] == {}


def test_display_records_equal_every_step_records(monkeypatch):
    """display 3 against display 1 from one seed, under threshold: a
    display-3 record equals the display-1 record of its iteration (timing
    aside), but for writes_saved, the sum of the interval's."""
    monkeypatch.chdir(REPO)
    recs = {}
    for display in (1, 3):
        text = solver_text(True).replace("display: 0",
                                         f"display: {display}")
        ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
        sink = []
        ts.enable_metrics(type("ListSink", (), {"write": lambda self, r:
                                                sink.append(r)})())
        ts.step(7)
        recs[display] = {r["iter"]: {k: v for k, v in r.items()
                                     if k not in TIMING} for r in sink}
    every, third = recs[1], recs[3]
    assert sorted(third) == [0, 3, 6]
    for it, rec in third.items():
        want = json.loads(json.dumps(every[it]))
        want["fault"]["writes_saved"] = sum(
            every[i]["fault"]["writes_saved"]
            for i in range(max(it - 2, 0), it + 1))
        assert rec == want, it
    assert third[3]["fault"]["writes_saved"] > every[3]["fault"][
        "writes_saved"] > 0


def test_enable_metrics_raises_once_the_step_ran():
    ts = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                 train_feed=lambda: {"data": np.zeros((8, 3, 32, 32),
                                                      np.float32),
                                     "label": np.zeros(8, np.float32)})
    ts.step(1)
    with pytest.raises(ValueError, match="before the train step"):
        ts.enable_metrics()


def test_debug_info_runs_in_the_reference_and_raises_in_the_port(
        monkeypatch, capsys):
    """(Named when the port refused debug_info.) The first step's
    debug_info lines of the narrow CIFAR solver: the reference's and
    the port's, names and order exact, values within REL = 1e-5 of
    tests/test_torch_debug_trace.py."""
    from test_torch_debug_trace import assert_lines_equal, debug_lines
    monkeypatch.chdir(REPO)
    text = SOLVER + " debug_info: true"
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
        js.step(1)
    want = debug_lines(capsys.readouterr().out)
    assert any(re.match(r"\s+\[Forward\] Layer conv1, top blob conv1 "
                        r"data: ", line) for line in want)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    ts.step(1)
    got = debug_lines(capsys.readouterr().out)
    assert len(got) == len(want) > 40
    assert_lines_equal(got, want)
