"""The port's fault processes (rram_caffe_simulation_tpu_torch/fault/
processes/) against the reference package's, on the CPU: the registry
and FaultSpec surface, each process's draws and Fail transforms, and the
Solver under a process stack.

Tolerances:

- None (bits) for every draw (lifetimes, stuck values, drift rates; tiled
  and untiled, one key and a batch of keys), every transform's
  lifetimes, packed counters, ages and weights, and the per_process
  counters. The drift weights are the reference's jitted arithmetic:
  XLA's CPU exp and log1p (core/prng.py) and the final multiply-add as
  one fused multiply-add, which XLA contracts in the reference's jitted
  step; the same function run eagerly (no contraction) parts from it at
  a target other than 0, and the port follows the step.
- The Solver lockstep: banks, ages, rates and counters bits; losses
  within 1e-4 relative and params rtol 1e-3, atol 1e-5 (the two
  packages sum convolutions and products in other orders), as
  tests/test_torch_solver.py holds them.

The lockstep runs the resume guard's one-InnerProduct net (a 24-record
LMDB, N(300, 60)) under the ternary crossbar read, the reference's step
jitted on engine "pallas"
(interpret mode), the port's on engine "torch" (the kernels' plain
versions), each step started from the reference's state and batch.
"""
import os

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.core import registry as jregistry
from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.fault import mapping as jmapping
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.fault import processes as jproc
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.core import registry as tregistry
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import fused as tfused
from rram_caffe_simulation_tpu_torch.fault import mapping as tmapping
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.fault import processes as tproc
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_group_prefetch import build_db, solver_text

SHAPES = {"ip/0": (6, 20), "ip/1": (6,)}
TILES = [None, "cells=3x10"]
SPECS = [
    "endurance_stuck_at",
    "read_disturb",
    "read_disturb:reads_per_step=40",
    "permanent_fault_map:fraction=0.3",
    "conductance_drift:nu=0.2,sigma=0.1",
    "conductance_drift:nu=0.5,target=0.3",
    "endurance_stuck_at+conductance_drift:nu=0.2,sigma=0.1",
    "read_disturb+conductance_drift:nu=0.3,sigma=0.5,target=-0.2",
]
PACKABLE = [s for s in SPECS if not s.startswith("conductance_drift")]
# each draw path once: read_disturb draws the engine's state, as
# endurance_stuck_at does (test_default_stack_draws_the_engine_state)
DRAW_SPECS = [s for s in SPECS if not s.startswith("read_disturb")
              and "target=0.3" not in s]
LOCKSTEP = ["read_disturb", "permanent_fault_map:fraction=0.1",
            "endurance_stuck_at+conductance_drift:nu=0.2,sigma=0.1"]


@pytest.fixture(autouse=True)
def x64_off():
    # the reference's production precision: float32 draws
    with jax.enable_x64(False):
        yield


def patterns(mean=300.0, std=60.0):
    text = f'type: "gaussian" mean: {mean} std: {std}'
    jp = pb.FailurePatternParameter()
    text_format.Parse(text, jp)
    return jp, tproto.parse(text, "FailurePatternParameter")


def stacks(spec, tiles=None):
    jt = None if tiles is None else jmapping.TileSpec.parse(tiles)
    tt = None if tiles is None else tmapping.TileSpec.parse(tiles)
    return (jproc.FaultSpec.parse(spec).build(tiles=jt),
            tproc.FaultSpec.parse(spec).build(tiles=tt))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def tbytes(state):
    """{group/key: (dtype, shape, bytes)} of either package's state."""
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
    except Exception as e:      # the type and text of what was raised
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# the registry and the spec

def test_registry_contents_and_errors():
    assert sorted(tregistry.FAULT_PROCESS_REGISTRY) == sorted(
        jregistry.FAULT_PROCESS_REGISTRY)
    for reg in (tregistry, jregistry):
        assert error_text(lambda: reg.create_fault_process("bit_rot")) \
            == error_text(lambda: jregistry.create_fault_process("bit_rot"))
    got = error_text(lambda: tregistry.register_fault_process(
        "endurance_stuck_at")(object))
    assert got == error_text(lambda: jregistry.register_fault_process(
        "endurance_stuck_at")(object))
    assert got[0] == "KeyError" and "registered twice" in got[1]
    for name, cls in tregistry.FAULT_PROCESS_REGISTRY.items():
        ref = jregistry.FAULT_PROCESS_REGISTRY[name]
        assert cls.process_name == ref.process_name == name
        for attr in ("phase", "has_lifetimes", "supports_packed",
                     "fused_mode", "param_names"):
            assert getattr(cls, attr) == getattr(ref, attr), (name, attr)


@pytest.mark.parametrize("name,params", [
    ("conductance_drift", {"mu": 0.1}),
    ("read_disturb", {"reads_per_step": 0.0}),
    ("read_disturb", {"reads_per_step": "many"}),
    ("permanent_fault_map", {}),
    ("permanent_fault_map", {"fraction": 0.1, "map": "x.npz"}),
    ("permanent_fault_map", {"fraction": 1.5}),
    ("conductance_drift", {"nu": -1.0}),
    ("endurance_stuck_at", {"nu": 1.0}),
])
def test_process_parameter_errors_equal_the_reference(name, params):
    got = error_text(lambda: tregistry.create_fault_process(name, params))
    assert got is not None
    assert got == error_text(
        lambda: jregistry.create_fault_process(name, params))


@pytest.mark.parametrize("text", [
    None, "", "endurance_stuck_at", " read_disturb ",
    "endurance_stuck_at+conductance_drift:sigma=0.1, nu=0.2",
    "conductance_drift:nu=0.2,sigma=0.1+endurance_stuck_at",
    "conductance_drift:nu=0.20", "conductance_drift:nu=2e-1",
    "read_disturb:reads_per_step=400", "permanent_fault_map:map=a/b.npz",
    "permanent_fault_map:fraction=0.05+conductance_drift:target=-0.5",
])
def test_spec_parse_canonical_and_model_equal_the_reference(text):
    t, j = tproc.FaultSpec.parse(text), jproc.FaultSpec.parse(text)
    assert t.processes == j.processes
    assert t.canonical() == j.canonical()
    assert t.to_model() == j.to_model()
    assert repr(t) == repr(j)
    tb, jb = t.build(), j.build()
    for attr in ("has_lifetimes", "supports_packed",
                 "supports_fused_epilogue"):
        assert getattr(tb, attr) == getattr(jb, attr), attr
    assert tb.unpackable() == jb.unpackable()
    assert tb.fused_unsupported_reason() == jb.fused_unsupported_reason()
    assert tb.write_quantum(100.0) == jb.write_quantum(100.0)
    assert tb.fused_mode == (jb.processes[0].fused_mode
                             if jb.supports_fused_epilogue else None)


@pytest.mark.parametrize("text", [
    "conductance_drift:nu", "read_disturb+", "bit_rot",
    "endurance_stuck_at+read_disturb", "conductance_drift+conductance_drift",
    "conductance_drift:=3"])
def test_spec_errors_equal_the_reference(text):
    got = error_text(lambda: tproc.FaultSpec.parse(text).build())
    assert got is not None
    assert got == error_text(lambda: jproc.FaultSpec.parse(text).build())


def test_stack_composition_rules():
    T = tproc
    with pytest.raises(ValueError, match="at most one clamp"):
        T.ProcessStack([T.EnduranceStuckAt(), T.ReadDisturb()])
    with pytest.raises(ValueError, match="listed twice"):
        T.ProcessStack([T.ConductanceDrift(), T.ConductanceDrift()])
    stack = T.ProcessStack([T.EnduranceStuckAt(), T.ConductanceDrift()])
    assert [p.process_name for p in stack.processes] == [
        "conductance_drift", "endurance_stuck_at"]
    assert stack.has_lifetimes and stack.supports_packed
    drift_only = T.ProcessStack([T.ConductanceDrift()])
    assert not drift_only.has_lifetimes and not drift_only.supports_packed
    assert drift_only.unpackable() == ["conductance_drift"]
    assert T.ProcessStack([T.EnduranceStuckAt()], tiles="1x1").tiles is None
    with pytest.raises(ValueError, match="fused epilogue unsupported"):
        stack.fail_fused({}, {}, {}, {})
    # the package exports the reference's names
    from rram_caffe_simulation_tpu_torch import fault
    assert {"FaultProcess", "FaultSpec", "ProcessStack",
            "register_fault_process"} <= set(fault.__all__)


# ---------------------------------------------------------------------------
# draws

@pytest.mark.parametrize("tiles", TILES, ids=["untiled", "tiled"])
@pytest.mark.parametrize("spec", DRAW_SPECS)
def test_draws_equal_the_reference(spec, tiles):
    """init_state and draw_rescaled from one key, and draw_state_rows over
    5 configs (and rows 1-4 of them), bit for bit."""
    js, ts = stacks(spec, tiles)
    jp, tp = patterns()
    key = 11
    want = host(js.init_state(jax.random.PRNGKey(key), SHAPES, jp))
    got = ts.init_state(prng.PRNGKey(key), SHAPES, tp)
    assert tbytes(got) == tbytes(want)
    want = host(js.draw_rescaled(jax.random.PRNGKey(key), SHAPES, jp,
                                 800.0, 90.0))
    got = ts.draw_rescaled(prng.PRNGKey(key), SHAPES, tp, 800.0, 90.0)
    assert tbytes(got) == tbytes(want)
    means, stds = [200.0, 300.0, 400.0, 500.0, 600.0], [10.0, 60.0, 0.0,
                                                        90.0, 30.0]
    want = host(jengine.draw_state_rows(
        jax.random.PRNGKey(5), SHAPES, jp, 5, means, stds, process=js))
    got = tengine.draw_state_rows(prng.PRNGKey(5), SHAPES, tp, 5, means,
                                  stds, process=ts)
    assert tbytes(got) == tbytes(want)
    # a block of rows is those rows of the full draw
    part = tengine.draw_state_rows(prng.PRNGKey(5), SHAPES, tp, 5, means,
                                   stds, rows=(1, 4), process=ts)
    assert tbytes(part) == tbytes(jax.tree.map(lambda a: a[1:4], want))


@pytest.mark.parametrize("tiles", TILES, ids=["untiled", "tiled"])
@pytest.mark.parametrize("spec", ["endurance_stuck_at", "read_disturb",
                                  "read_disturb:reads_per_step=40"])
def test_default_stack_draws_the_engine_state(spec, tiles):
    """The endurance stack and read_disturb delegate: byte for byte the
    engine's draws, one key and stacked."""
    _, ts = stacks(spec, tiles)
    _, tp = patterns()
    tt = None if tiles is None else tmapping.TileSpec.parse(tiles)
    key = prng.PRNGKey(3)
    assert tbytes(ts.init_state(key, SHAPES, tp)) == tbytes(
        tengine.init_fault_state(key, SHAPES, tp, tiles=tt))
    assert tbytes(ts.draw_rescaled(key, SHAPES, tp, 700.0, 20.0)) == \
        tbytes(tengine.draw_rescaled_state(key, SHAPES, tp, 700.0, 20.0,
                                           tiles=tt))
    assert tbytes(tengine.stack_fault_states(key, SHAPES, tp, 4,
                                             process=ts)) == \
        tbytes(tengine.stack_fault_states(key, SHAPES, tp, 4, tiles=tt))


# ---------------------------------------------------------------------------
# one fail per process

def fail_inputs(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    params, diffs = {}, {}
    for k, s in shapes.items():
        params[k] = (rng.randn(*s) * 0.5).astype(np.float32)
        d = (rng.randn(*s) * 0.01).astype(np.float32)
        u = rng.rand(*s)
        d[u < 0.4] = 0.0
        d[(u >= 0.4) & (u < 0.45)] = 1e-21       # under the write epsilon
        d[(u >= 0.45) & (u < 0.5)] = np.float32(1e-20)
        diffs[k] = d
    return params, diffs


def _same_state(got, want):
    got, want = tbytes(got), tbytes(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("spec,fmt", [(s, "f32") for s in SPECS]
                         + [(s, "packed") for s in PACKABLE])
def test_fail_equals_the_reference(spec, fmt):
    """Five steps of the stack's fail (f32) or fail_packed (packed banks;
    a decay-only stack has none) against the reference's jitted
    transform from the same state: weights, lifetimes or counters, stuck
    values or banks, ages and rates, bit for bit, and the per_process
    counters."""
    js, ts = stacks(spec)
    jp, _ = patterns()
    state = host(js.init_state(jax.random.PRNGKey(2), SHAPES, jp))
    if "drift_age" in state:    # ages already running: 0 to 60 steps
        rng = np.random.RandomState(9)
        state["drift_age"] = {k: rng.randint(0, 60, v.shape).astype(
            np.float32) for k, v in state["drift_age"].items()}
    spec_p = None
    if fmt == "packed":
        spec_p = jpacked.make_pack_spec(state, js.write_quantum(100.0),
                                        pattern=jp)
        state = host(jpacked.pack_state(state, spec_p))
        jfail = jax.jit(lambda p, s, d: js.fail_packed(p, s, d, spec_p))
    else:
        jfail = jax.jit(lambda p, s, d: js.fail(p, s, d, 100.0))
    jcount = jax.jit(lambda s: js.counters(s, _life_view(s, spec_p)))
    tstate = convert.fault_state_from_jax(state)
    params, _ = fail_inputs(0)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for it in range(5):
        _, diffs = fail_inputs(it + 1)
        jparams, state = host(jfail(params, state, diffs))
        tdiffs = {k: torch.from_numpy(v) for k, v in diffs.items()}
        if fmt == "packed":
            tparams, tstate = ts.fail_packed(tparams, tstate, tdiffs, spec_p)
        else:
            tparams, tstate = ts.fail(tparams, tstate, tdiffs, 100.0)
        _same_state(tstate, state)
        for k in params:
            np.testing.assert_array_equal(
                tparams[k].numpy().view(np.int32),
                jparams[k].view(np.int32), err_msg=f"{it} {k}")
        counters_equal(ts.counters(tstate, _tlife_view(tstate, spec_p)),
                       host(jcount(state)))
        params = jparams
    if ts.has_lifetimes and spec != "permanent_fault_map:fraction=0.3":
        assert tengine.broken_fraction(tstate) > 0.05   # cells broke
    if "drift_age" in state:
        assert (tstate["drift_age"]["ip/0"] == 0).any()


def _life_view(state, spec):
    if "life_q" in state:
        return {k: jpacked.unpack_lifetimes(q, spec["decrement"])
                for k, q in state["life_q"].items()}
    return state.get("lifetimes", {})


def _tlife_view(state, spec):
    if "life_q" in state:
        return {k: tpacked.unpack_lifetimes(q, spec["decrement"])
                for k, q in state["life_q"].items()}
    return state.get("lifetimes", {})


def counters_equal(got, want):
    """The port's per_process counters (int64 counts) equal the
    reference's (int32 counts, float32 means), value and bits."""
    assert sorted(got) == sorted(want)
    for p, cs in want.items():
        assert sorted(got[p]) == sorted(cs), p
        for c, v in cs.items():
            v = np.asarray(v)
            assert got[p][c].cpu().numpy().astype(v.dtype).tobytes() == \
                v.tobytes(), (p, c)


@pytest.mark.parametrize("spec", ["endurance_stuck_at", "read_disturb",
                                  "read_disturb:reads_per_step=40",
                                  "permanent_fault_map:fraction=0.3"])
def test_fail_fused_equals_update_then_fail_packed(spec, monkeypatch):
    """The fused route (kernel B1's plain version on the CPU, in the
    process's mode, one call for all leaves) equals `data - diff` then
    the reference's fail_packed, bit for bit."""
    js, ts = stacks(spec)
    jp, _ = patterns()
    state = host(js.init_state(jax.random.PRNGKey(4), SHAPES, jp))
    spec_p = jpacked.make_pack_spec(state, js.write_quantum(100.0),
                                    pattern=jp)
    state = host(jpacked.pack_state(state, spec_p))
    tstate = convert.fault_state_from_jax(state)
    params, _ = fail_inputs(0)
    calls, group = [], tfused.fused_update_fail_leaves

    def spy(*args, mode):
        calls.append(mode)
        return group(*args, mode=mode)
    monkeypatch.setattr(tfused, "fused_update_fail_leaves", spy)
    for it in range(4):
        _, diffs = fail_inputs(it + 1)
        post = {k: params[k] - diffs[k] for k in params}
        jparams, state = host(jax.jit(
            lambda p, s, d: js.fail_packed(p, s, d, spec_p))(
                post, state, diffs))
        tparams, tstate = ts.fail_fused(
            {k: torch.from_numpy(v.copy()) for k, v in params.items()},
            tstate, {k: torch.from_numpy(v) for k, v in diffs.items()},
            spec_p)
        _same_state(tstate, state)
        for k in params:
            np.testing.assert_array_equal(tparams[k].numpy(), jparams[k])
        params = jparams
    assert calls == [ts.fused_mode] * 4


def test_drift_exp_is_xla_exp_over_the_process_arguments():
    """core/prng.py exp against jax.jit(jnp.exp) over the arguments the
    drift process reaches (-rate * dlog, rate ~ nu exp(sigma z)) and the
    whole float32 range, subnormal results flushed as XLA flushes them;
    log1p over the ages."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.uniform(-20, 0, 8000), rng.uniform(-1, 1, 4000),
        -np.abs(rng.randn(4000)) * 1e-3, rng.uniform(-88, 89, 8000),
        rng.uniform(-104, -80, 1000),
        [0.0, -0.0, np.inf, -np.inf, 88.72, 88.73, -87.3, -87.4, 1e-45]
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = prng.exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    age = np.concatenate([np.arange(0, 5000), np.arange(5000, 10 ** 6,
                                                         997)]).astype(
        np.float32)
    np.testing.assert_array_equal(
        prng.log1p(torch.from_numpy(age)).numpy().view(np.int32),
        np.asarray(jax.jit(jnp.log1p)(age)).view(np.int32))


# ---------------------------------------------------------------------------
# the map file

def test_permanent_fault_map_from_a_file(tmp_path):
    path = str(tmp_path / "map.npz")
    broken = np.zeros((6, 20), bool)
    broken[0, 0] = broken[2, 3] = broken[5, 19] = True
    stuck = np.zeros((6, 20), np.float32)
    stuck[0, 0], stuck[5, 19] = -1.0, 1.0
    np.savez(path, **{"ip/0/broken": broken, "ip/0/stuck": stuck})
    js, ts = stacks(f"permanent_fault_map:map={path}")
    jp, tp = patterns()
    want = host(js.init_state(jax.random.PRNGKey(0), SHAPES, jp))
    got = ts.init_state(prng.PRNGKey(0), SHAPES, tp)
    assert tbytes(got) == tbytes(want)
    assert int((got["lifetimes"]["ip/0"] < 0).sum()) == 3
    assert bool((got["lifetimes"]["ip/1"] > 0).all())   # fault-free
    # every config holds the same chip
    rows = tengine.draw_state_rows(prng.PRNGKey(1), SHAPES, tp, 3,
                                   [1.0] * 3, [2.0] * 3, process=ts)
    want = host(jengine.draw_state_rows(jax.random.PRNGKey(1), SHAPES, jp,
                                        3, [1.0] * 3, [2.0] * 3,
                                        process=js))
    assert tbytes(rows) == tbytes(want)
    for lane in range(3):
        assert torch.equal(rows["lifetimes"]["ip/0"][lane],
                           got["lifetimes"]["ip/0"])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{"ip/0/broken": np.zeros((2, 2), bool),
                     "ip/0/stuck": np.zeros((2, 2), np.float32)})
    worse = str(tmp_path / "worse.npz")
    np.savez(worse, **{"ip/0/broken": broken,
                       "ip/0/stuck": np.full((6, 20), 2.0, np.float32)})
    for p in (bad, worse):
        got = error_text(lambda: tproc.PermanentFaultMap(
            {"map": p}).init_state(prng.PRNGKey(0), SHAPES, tp))
        assert got is not None and got[0] == "ValueError"
        assert got == error_text(lambda: jproc.PermanentFaultMap(
            {"map": p}).init_state(jax.random.PRNGKey(0), SHAPES, jp))


# ---------------------------------------------------------------------------
# the Solver

@pytest.mark.parametrize("fmt", ["f32", "packed"])
@pytest.mark.parametrize("spec", LOCKSTEP)
def test_solver_matches_the_reference_in_lockstep(spec, fmt, tmp_path):
    text = drift_text(tmp_path, "l")
    js = JSolver(_sp(text), fault_process=spec)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 fault_process=spec)
    assert tbytes(ts.fault_state) == tbytes(host(js.fault_state))
    jstack = js.fault_process
    state, spec_p, opts = host(js.fault_state), None, {}
    if fmt == "packed":
        spec_p = jpacked.make_pack_spec(
            state, jstack.write_quantum(js.fail_decrement),
            pattern=js.param.failure_pattern)
        state = host(jpacked.pack_state(state, spec_p))
        opts = dict(pack_spec=spec_p)
    jstep = jax.jit(js.make_train_step(
        hw_engine="pallas", dtype_policy="ternary", fault_format=fmt,
        with_metrics=True, **opts))
    tstep = ts.make_train_step(hw_engine="torch", dtype_policy="ternary",
                               fault_format=fmt, with_metrics=True, **opts)
    fused = fmt == "packed" and jstack.supports_fused_epilogue
    assert tstep.fused_epilogue_resolved == fused
    assert tstep.fused_mode == (jstack.processes[0].fused_mode if fused
                                else None)
    if not fused and fmt == "packed":
        assert tstep.fused_epilogue_reason == \
            jstack.fused_unsupported_reason()
    params, hist = host(js.params), host(js.history)
    for it in range(6):
        batch = {k: np.asarray(v) for k, v in js.train_feed().items()}
        tp, th, tstate, tloss, _, tmets = tstep(
            convert.params_from_jax(params),
            {k: {s: torch.from_numpy(np.array(a)) for s, a in v.items()}
             for k, v in hist.items()},
            convert.fault_state_from_jax(state),
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, it,
            prng.fold_in(ts._key, it))
        params, hist, state, loss, _, mets = host(jstep(
            params, hist, state, {k: jnp.asarray(v) for k, v in
                                  batch.items()},
            jnp.int32(it), jax.random.fold_in(js._key, it), False))
        assert float(tloss) == pytest.approx(float(loss), rel=1e-4)
        got, want = tbytes(tstate), tbytes(state)
        assert sorted(got) == sorted(want)
        for k in want:
            if not k.startswith(("life", "stuck", "drift")):
                continue
            assert got[k] == want[k], (it, k)
        counters_equal(tmets["fault"]["per_process"],
                       mets["fault"]["per_process"])
        for ln, vals in params.items():
            for a, b in zip(vals, tp[ln]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-3, atol=1e-5)
    if jstack.has_lifetimes and "permanent" not in spec:
        assert tengine.broken_fraction(convert.fault_state_from_jax(
            state)) > 0.05


class EngineShim:
    """The pre-registry Fail: the engine's functions called directly."""
    has_lifetimes = True
    supports_fused_epilogue = True
    fused_mode = "write"

    def fail(self, p, s, d, dec):
        return tengine.fail(p, s, d, dec)

    def fail_packed(self, p, s, d, spec):
        return tpacked.fail_packed(p, s, d, spec)

    def counters(self, s, lv, lanes=0):
        return {}


@pytest.mark.parametrize("fmt", ["f32", "packed"])
def test_endurance_stack_equals_the_engine_path(fmt, tmp_path):
    """The default stack against the engine's functions called directly
    (the port's counterpart of scripts/check_fault_processes.py): losses,
    banks and the .faultstate file, byte for byte."""
    kw = dict(hw_engine="torch", dtype_policy="ternary", fault_format=fmt)
    a, b = (TSolver(tproto.parse(drift_text(tmp_path, tag),
                                 "SolverParameter"), device="cpu", **kw)
            for tag in "ab")
    assert a._step_fn.fused_epilogue_resolved == (fmt == "packed")
    b.fault_process = EngineShim()
    b._step_fn = b.make_train_step(**b._step_opts)
    for _ in range(6):
        a.step(1)
        b.step(1)
        assert float(a.last_loss) == float(b.last_loss)
    assert tbytes(a.fault_state) == tbytes(b.fault_state)
    fa = a.snapshot().replace(".caffemodel", ".faultstate")
    fb = b.snapshot().replace(".caffemodel", ".faultstate")
    with open(fa, "rb") as f1, open(fb, "rb") as f2:
        assert f1.read() == f2.read()
    assert a.broken_fraction() > 0.05


def drift_text(tmp_path, tag):
    db = build_db(tmp_path / f"db_{tag}")
    return solver_text(db, tmp_path / tag)


DRIFT = "endurance_stuck_at+conductance_drift:nu=0.3"


def test_drift_snapshot_round_trips_and_crosses_packages(tmp_path):
    text = drift_text(tmp_path, "d")
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                fault_process=DRIFT)
    assert sorted(s.fault_state) == ["drift_age", "drift_rate",
                                     "lifetimes", "stuck"]
    s.step(5)
    model = s.snapshot()
    state_file = model.replace(".caffemodel", ".solverstate")
    s2 = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 fault_process=DRIFT)
    s2.restore(state_file)
    assert tbytes(s2.fault_state) == tbytes(s.fault_state)
    # the reference restores the port's file to the same state
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, fault_process=DRIFT)
    js.restore(state_file)
    assert tbytes(s.fault_state) == tbytes(host(js.fault_state))
    # a default-process solver refuses the drift .faultstate, in the
    # reference's words
    s3 = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    js3 = JSolver(sp)
    got = error_text(lambda: s3.restore(state_file))
    assert got is not None and "fault process" in got[1]
    assert got == error_text(lambda: js3.restore(state_file))


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def flush(self):
        pass

    def close(self):
        pass


def test_redraw_record_and_line_name_the_stack(tmp_path, capsys):
    text = drift_text(tmp_path, "r")
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                fault_process=DRIFT)
    s.step(2)
    model = s.snapshot()
    os.remove(model.replace(".caffemodel", ".faultstate"))
    state_file = model.replace(".caffemodel", ".solverstate")
    recs, lines = {}, {}
    for name, make in (("port", lambda: TSolver(
            tproto.parse(text, "SolverParameter"), device="cpu",
            fault_process=DRIFT)), ("reference", lambda: JSolver(
                _sp(text), fault_process=DRIFT))):
        sink = ListSink()
        solver = make()
        solver.enable_metrics(sink)
        capsys.readouterr()
        solver.restore(state_file)
        lines[name] = capsys.readouterr().err
        recs[name] = [r for r in sink.records
                      if r.get("type") == "fault_redraw"]
    assert lines["port"] == lines["reference"]
    assert "conductance_drift:nu=0.3+endurance_stuck_at" in lines["port"]
    strip = lambda r: {k: v for k, v in r.items() if k != "wall_time"}
    assert [strip(r) for r in recs["port"]] == \
        [strip(r) for r in recs["reference"]]
    assert len(recs["port"]) == 1


def _sp(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return sp


def test_metrics_carry_the_stacks_counters(tmp_path):
    text = drift_text(tmp_path, "m").replace("display: 0", "display: 1")
    got = {}
    for name, make in (("port", lambda: TSolver(
            tproto.parse(text, "SolverParameter"), device="cpu",
            fault_process=DRIFT)), ("reference", lambda: JSolver(
                _sp(text), fault_process=DRIFT))):
        sink = ListSink()
        solver = make()
        solver.enable_metrics(sink)
        solver.step(3)
        got[name] = [r["fault"] for r in sink.records
                     if r.get("type") is None and "fault" in r]
    assert len(got["port"]) == len(got["reference"]) == 3
    for t, j in zip(got["port"], got["reference"]):
        assert t["per_process"] == j["per_process"]
        assert set(t["per_process"]) == {"endurance_stuck_at",
                                         "conductance_drift"}
        assert t["per_process"]["endurance_stuck_at"]["broken"] == \
            t["broken_total"]


# ---------------------------------------------------------------------------
# refusals, in the reference's words

def no_fault_text(tmp_path):
    db = build_db(tmp_path / "db_n")
    return solver_text(db, tmp_path / "n", fault=False)


def refusal_cases(tmp_path):
    nofault = no_fault_text(tmp_path)
    text = drift_text(tmp_path, "f")
    rf = text + ' rram_forward { sigma: 0.05 }'

    def port(spec, text=text, **kw):
        return TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                       fault_process=spec, **kw)
    return {
        "process without an engine": (
            lambda: TSolver(tproto.parse(nofault, "SolverParameter"),
                            device="cpu", fault_process="conductance_drift"),
            lambda: JSolver(_sp(nofault),
                            fault_process="conductance_drift")),
        "rram_forward with a drift-only stack": (
            lambda: port("conductance_drift:nu=0.2", text=rf),
            lambda: JSolver(_sp(rf), fault_process="conductance_drift:nu=0.2")),
        "fused epilogue with a multi-process stack": (
            lambda: port("endurance_stuck_at+conductance_drift",
                         dtype_policy="ternary", fault_format="packed",
                         fused_epilogue=True),
            lambda: _ref_fused(text)),
    }


def _ref_fused(text):
    js = JSolver(_sp(text), fault_process="endurance_stuck_at"
                 "+conductance_drift")
    spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                  pattern=js.param.failure_pattern)
    js.make_train_step(hw_engine="pallas", dtype_policy="ternary",
                       fault_format="packed", pack_spec=spec,
                       fused_epilogue=True)


@pytest.mark.parametrize("case", [
    "process without an engine", "rram_forward with a drift-only stack",
    "fused epilogue with a multi-process stack"])
def test_refusals_equal_the_reference(case, tmp_path):
    port, ref = refusal_cases(tmp_path)[case]
    got = error_text(port)
    assert got is not None and got[0] == "ValueError"
    assert got == error_text(ref)


TWO_FC = """base_lr: 0.1 lr_policy: "fixed" random_seed: 1
net_param { name: "two_fc"
  layer { name: "in" type: "Input" top: "data" top: "label"
    input_param { shape { dim: 4 dim: 6 } shape { dim: 4 } } }
  layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
    inner_product_param { num_output: 5
      weight_filler { type: "xavier" } } }
  layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
    inner_product_param { num_output: 3
      weight_filler { type: "xavier" } } }
  layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2"
    bottom: "label" top: "loss" } }
failure_pattern { type: "gaussian" mean: 300 std: 60 }
"""


def test_strategies_refused_without_lifetimes(tmp_path):
    order = tmp_path / "order.txt"
    order.write_text("4 3 2 1 0\n")
    text = TWO_FC + ' failure_strategy { type: "remapping" start: 1 ' \
        f'period: 2 prune_order_file: "{order}" }}'
    got = error_text(lambda: TSolver(tproto.parse(text, "SolverParameter"),
                                     device="cpu",
                                     fault_process="conductance_drift"))
    assert got == error_text(lambda: JSolver(
        _sp(text), train_feed=lambda: {},
        fault_process="conductance_drift"))
    assert got is not None and "remap/genetic" in got[1]


def test_drift_follows_the_jitted_step():
    """The reference splits with itself at a target other than 0: its
    jitted fail contracts target + (w - target) * decay into one fused
    multiply-add, its eager fail rounds the product first (ROADMAP §C).
    The port equals the jitted one, the form the train step runs."""
    js, ts = stacks("conductance_drift:nu=0.2,sigma=0.1,target=0.3")
    jp, _ = patterns()
    state = host(js.init_state(jax.random.PRNGKey(0), SHAPES, jp))
    rng = np.random.RandomState(1)
    state["drift_age"] = {k: rng.randint(0, 50, v.shape).astype(np.float32)
                          for k, v in state["drift_age"].items()}
    params, diffs = fail_inputs(2)
    jitted = host(jax.jit(lambda p, s, d: js.fail(p, s, d, 100.0))(
        params, state, diffs))[0]["ip/0"]
    eager = np.asarray(js.fail(params, state, diffs, 100.0)[0]["ip/0"])
    got = ts.fail({k: torch.from_numpy(v) for k, v in params.items()},
                  convert.fault_state_from_jax(state),
                  {k: torch.from_numpy(v) for k, v in diffs.items()},
                  100.0)[0]["ip/0"].numpy()
    np.testing.assert_array_equal(got.view(np.int32), jitted.view(np.int32))
    apart = float(np.mean(eager != jitted))
    print(f"eager and jitted reference apart in {apart:.2%} of the cells")
    assert 0 < apart < 1
    assert np.abs(eager - jitted).max() <= np.spacing(
        np.abs(jitted)).max()
