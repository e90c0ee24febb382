"""The rest of the solver in the port (solver/updates.py and
Solver.make_train_step's ComputeUpdate) against the reference package's.

Held, on the same numpy inputs:
- each of the six update rules, run eagerly, bit for bit: update and
  every history bank (Adam's bias correction included: the port calls
  the C library's powf, which is XLA's CPU pow);
- a port Solver in lockstep with the reference's jitted step (Pallas in
  interpret mode, the ternary read, packed banks, the fused epilogue) on
  the narrowed CIFAR-10-quick of test_torch_solver.py, each step started
  from the reference's state: life_q equal at every step, losses within
  1e-4 relative, params and history within rtol 1e-3, atol 1e-5 (XLA
  fuses products into adds inside jit and sums the GEMMs in another
  order). Under Nesterov, AdaDelta and Adam; under iter_size 2 and 3
  (the jitted reference divides by 3 through its reciprocal, an ulp off
  the eager division the port follows; the banks stay exact); and with
  clip_gradients engaged and L1 regularization;
- the legacy `solver_type` enum resolves as the reference resolves it;
- an Adam Solver's snapshot carries both history banks, in the
  .solverstate order, into the other package and back.
"""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.solver import updates as jU
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver
from rram_caffe_simulation_tpu_torch.solver import updates as tU

from test_torch_snapshot import files, host, port_solver, ref_solver, \
    ref_step
from test_torch_solver import REPO, SOLVER

F32 = np.float32
STEPS = 4
RULES = ["SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta", "Adam"]
HYPERS = {
    "common": "momentum: 0.9 momentum2: 0.999 rms_decay: 0.99",
    "other": "momentum: 0.95 momentum2: 0.99 delta: 1e-6 rms_decay: 0.9",
}


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def ref_param(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return sp


# ---------------------------------------------------------------------------
# the rules, eagerly

def rule_inputs(seed, shape=(9, 7)):
    rng = np.random.RandomState(seed)
    diff = (rng.randn(*shape) * 10.0 ** rng.uniform(-6, 0, shape)).astype(F32)
    diff[0, :3] = 0.0
    h = np.abs(rng.randn(*shape)).astype(F32) * F32(1e-3)
    h2 = np.abs(rng.randn(*shape)).astype(F32) * F32(1e-4)
    h[1, 0] = h2[1, 0] = 0.0
    return diff, {"h": h, "h2": h2}


@pytest.mark.parametrize("hyper", list(HYPERS))
@pytest.mark.parametrize("rule", RULES)
def test_rule_matches_reference_bit_for_bit(rule, hyper):
    text = HYPERS[hyper]
    jhp, thp = jU.Hyper(ref_param(text)), tU.Hyper(
        tproto.parse(text, "SolverParameter"))
    for name in ("momentum", "momentum2", "delta", "rms_decay"):
        assert getattr(thp, name) == float(getattr(jhp, name))
    slots_of = jU.HISTORY_SLOTS[rule]
    assert tU.HISTORY_SLOTS[rule] == slots_of
    for seed, (rate, t) in enumerate([(0.01, 1), (0.003, 7), (0.1, 1000),
                                      (1.0, 40001)]):
        diff, slots = rule_inputs(seed)
        slots = {s: slots[s] for s in slots_of}
        local_rate = float(F32(rate) * F32(2.0))
        with jax.enable_x64(False):
            ju, jh = jU.UPDATE_RULES[rule](
                jnp.asarray(diff), {s: jnp.asarray(v) for s, v in
                                    slots.items()},
                jnp.float32(rate) * 2.0, jhp, t)
            ju, jh = np.asarray(ju), {s: np.asarray(v) for s, v in
                                      jh.items()}
        tu, th = tU.UPDATE_RULES[rule](
            torch.from_numpy(diff), {s: torch.from_numpy(v.copy())
                                     for s, v in slots.items()},
            local_rate, thp, t)
        np.testing.assert_array_equal(bits(tu.numpy()), bits(ju),
                                      err_msg=f"{rule} t={t}")
        assert set(th) == set(jh)
        for s in jh:
            np.testing.assert_array_equal(bits(th[s].numpy()), bits(jh[s]),
                                          err_msg=f"{rule} {s} t={t}")


@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.95, 0.99)])
def test_adam_correction_equals_xla_pow_at_every_step(betas):
    """sqrt(1 - b2^t) / (1 - b1^t) at t = 1..20000, as the reference's
    adam computes it, against the port's host scalar: no step apart."""
    text = f"momentum: {betas[0]} momentum2: {betas[1]}"
    jhp = jU.Hyper(ref_param(text))
    thp = tU.Hyper(tproto.parse(text, "SolverParameter"))
    t = np.arange(1, 20001)
    with jax.enable_x64(False):
        tf = jnp.asarray(t, jnp.float32)
        want = np.asarray(jnp.sqrt(1.0 - jhp.momentum2 ** tf)
                          / (1.0 - jhp.momentum ** tf))
    got = np.array([tU.adam_correction(thp, int(s)) for s in t], F32)
    assert int((bits(got) != bits(want)).sum()) == 0


def test_hyper_defaults_are_float32():
    hp = tU.Hyper(tproto.parse("", "SolverParameter"))
    assert hp.delta == float(F32(1e-8)) and hp.delta != 1e-8
    assert hp.momentum2 == float(F32(0.999))
    assert hp.rms_decay == float(F32(0.99))


def test_clip_gradients_per_lane_matches_reference():
    """Each lane clips by its own norm (the reference vmaps the step): a
    lane over the clip is scaled to it, one under it is left alone."""
    rng = np.random.RandomState(3)
    grads = {"a": rng.randn(3, 5, 4).astype(F32),
             "b": rng.randn(3, 6).astype(F32)}
    grads["a"][1] *= F32(1e-3)
    grads["b"][1] *= F32(1e-3)
    clip = float(F32(0.5))
    out = tsolver.clip_gradients({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, clip, lanes=3)
    with jax.enable_x64(False):
        for c in range(3):
            g = {k: jnp.asarray(v[c]) for k, v in grads.items()}
            l2 = jnp.sqrt(sum(jnp.sum(v * v) for v in g.values()))
            scale = jnp.where(l2 > clip, clip / jnp.maximum(l2, 1e-30), 1.0)
            for k in g:
                np.testing.assert_allclose(out[k][c].numpy(),
                                           np.asarray(g[k] * scale),
                                           rtol=2e-7, atol=0)
            assert (float(l2) > clip) == (c != 1)
        single = tsolver.clip_gradients(
            {k: torch.from_numpy(v[0]) for k, v in grads.items()}, clip)
        for k in grads:
            assert torch.equal(single[k], out[k][0])


# ---------------------------------------------------------------------------
# the Solver in lockstep with the reference's jitted step

def lockstep(monkeypatch, text, steps=STEPS):
    """`steps` steps, each from the reference's state and batch; returns
    the port Solver."""
    monkeypatch.chdir(REPO)
    sp = ref_param(text)
    iter_size = max(sp.iter_size, 1)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
        spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                      pattern=sp.failure_pattern)
        jstate = jax.tree.map(jnp.asarray, jpacked.pack_state(
            {g: {k: np.asarray(v) for k, v in leaves.items()}
             for g, leaves in js.fault_state.items()}, spec))
        jstep = jax.jit(js.make_train_step(
            hw_engine="pallas", dtype_policy="ternary",
            fault_format="packed", pack_spec=spec, fused_epilogue=True))
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 hw_engine="cuda", dtype_policy="ternary",
                 fault_format="packed", fused_epilogue=True)
    assert ts.type == js.type and ts.pack_spec == spec
    params, hist = js.params, js.history
    for it in range(steps):
        ts.params = convert.params_from_jax(
            {k: [np.asarray(a) for a in v] for k, v in params.items()})
        ts.history = {k: {s: torch.from_numpy(np.array(a)) for s, a in
                          v.items()} for k, v in hist.items()}
        ts.fault_state = convert.fault_state_from_jax(
            jax.tree.map(np.asarray, jstate))
        subs = [{k: np.asarray(v) for k, v in js.train_feed().items()}
                for _ in range(iter_size)]
        batch = subs[0] if iter_size == 1 else {
            k: np.stack([sb[k] for sb in subs]) for k in subs[0]}
        with jax.enable_x64(False):
            params, hist, jstate, loss, _, _ = jstep(
                params, hist, jstate, {k: jnp.asarray(v) for k, v in
                                       batch.items()},
                jnp.int32(it), jax.random.fold_in(js._key, it), False)
        ts.params, ts.history, ts.fault_state, tloss, _ = ts._step_fn(
            ts.params, ts.history, ts.fault_state,
            {k: torch.from_numpy(v) for k, v in batch.items()}, it,
            ts._step_fn.noise.step_key(ts._key, it))
        assert float(tloss) == pytest.approx(float(loss), rel=1e-4), it
        for k, ref in jstate["life_q"].items():
            np.testing.assert_array_equal(
                ts.fault_state["life_q"][k].numpy(), np.asarray(ref),
                err_msg=f"step {it} {k}")
        for ln, vals in params.items():
            for a, b in zip(vals, ts.params[ln]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-3, atol=1e-5)
        for k, slots in hist.items():
            for s, a in slots.items():
                np.testing.assert_allclose(ts.history[k][s].numpy(),
                                           np.asarray(a), rtol=1e-3,
                                           atol=1e-5)
    assert ts.broken_fraction() > 0.01
    return ts


@pytest.mark.parametrize("rule,extra", [
    ("Nesterov", ""),
    ("AdaDelta", "delta: 1e-6"),
    ("Adam", "momentum2: 0.999"),
])
def test_rule_solver_matches_reference_in_lockstep(monkeypatch, rule, extra):
    ts = lockstep(monkeypatch, f'{SOLVER} type: "{rule}" {extra}')
    assert set(ts.history["ip1/0"]) == set(tU.HISTORY_SLOTS[rule])


@pytest.mark.parametrize("iter_size", [2, 3])
def test_iter_size_matches_reference_in_lockstep(monkeypatch, iter_size):
    """Sub-batches stacked on a leading axis, the sub-passes' gradients
    summed in order and divided by iter_size; the crossbar reads twice
    per sub-pass (B2 launches 2 * iter_size times a step on the card)."""
    calls = []
    orig = tsolver.Net.apply
    monkeypatch.setattr(tsolver.Net, "apply", lambda self, *a, **kw: (
        calls.append(kw.get("crossbar") is not None), orig(self, *a, **kw))[1])
    lockstep(monkeypatch, f"{SOLVER} iter_size: {iter_size}", steps=3)
    assert calls == [True] * (3 * iter_size)


def test_clip_and_l1_match_reference_in_lockstep(monkeypatch):
    """ClipGradients engaged on every step (its norm recorded above the
    clip), then L1 regularization."""
    norms = []
    orig = tsolver.clip_gradients

    def record(g, clip, lanes=0):
        norms.append((float(torch.sqrt(sum((v.double() ** 2).sum()
                                           for v in g.values()))), clip))
        return orig(g, clip, lanes)
    monkeypatch.setattr(tsolver, "clip_gradients", record)
    lockstep(monkeypatch, f'{SOLVER} clip_gradients: 0.05 '
             'regularization_type: "L1"')
    assert len(norms) == STEPS
    assert all(n > c for n, c in norms), norms


def test_sub_pass_keys_follow_the_reference(monkeypatch):
    """Under iter_size each sub-pass reads with fold_in(step key, i): its
    crossbar seeds are the reference's randint(fold_in(fold_in(
    fold_in(step key, i), 0x4A7), fault key)), found in StepNoise's
    block (no derivation on the spot), for a lane too."""
    monkeypatch.chdir(REPO)
    ts = TSolver(tproto.parse(f"{SOLVER} iter_size: 2", "SolverParameter"),
                 device="cpu", dtype_policy="ternary")
    noise = ts._step_fn.noise
    derived = []
    orig = noise._derive
    monkeypatch.setattr(noise, "_derive",
                        lambda rng: (derived.append(rng), orig(rng))[1])
    for lanes in (0, 3):
        rng = noise.step_key(ts._key, 5, lanes)
        n_block = len(derived)
        for i in range(2):
            sub = prng.fold_in(rng, i)
            _, seeds = noise(sub)
            with jax.enable_x64(False):
                step_key = jax.random.fold_in(
                    jnp.asarray(ts._key, jnp.uint32), 5)
                want = []
                for c in range(max(lanes, 1)):
                    key = (jax.random.fold_in(step_key, c) if lanes
                           else step_key)
                    base = jax.random.fold_in(jax.random.fold_in(key, i),
                                              0x4A7)
                    want.append([int(jax.random.randint(
                        jax.random.fold_in(base, j), (), 0,
                        jnp.iinfo(jnp.int32).max))
                        for j in noise.seeded])
            np.testing.assert_array_equal(
                np.asarray(seeds).reshape(-1, len(noise.seeded)),
                np.asarray(want))
        assert len(derived) == n_block          # found in the block


# ---------------------------------------------------------------------------
# the solver's configuration

def test_unknown_regularization_raises_as_the_reference(monkeypatch):
    monkeypatch.chdir(REPO)
    text = f'{SOLVER} regularization_type: "L3"'
    with pytest.raises(ValueError, match="unknown regularization 'L3'"):
        TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    with jax.enable_x64(False), pytest.raises(
            ValueError, match="unknown regularization 'L3'"):
        sp = ref_param(text)
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
        js.step(1)


@pytest.mark.parametrize("label", ["NESTEROV", "ADADELTA", "ADAM", "SGD"])
def test_legacy_solver_type_resolves_as_the_reference(monkeypatch, label):
    """`solver_type: <label>` without `type` trains that rule, with its
    history banks; the enum arrives as a number from text and binary,
    and a label string resolves alike."""
    monkeypatch.chdir(REPO)
    text = f"{SOLVER} solver_type: {label}"
    with jax.enable_x64(False):
        sp = ref_param(text)
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
    tp = tproto.parse(text, "SolverParameter")
    assert tp.solver_type == tU.LEGACY_SOLVER_LABELS.index(label)
    ts = TSolver(tp, device="cpu")
    assert ts.type == js.type == tU.LEGACY_SOLVER_TYPES[tp.solver_type]
    assert {k: tuple(v) for k, v in ts.history.items()} == {
        k: tuple(v) for k, v in js.history.items()}
    back = tproto.decode(tproto.encode(tp), "SolverParameter")
    assert back.solver_type == tp.solver_type
    assert tU.resolve_solver_type(back) == js.type

    class Labelled:                         # the enum given by its label
        solver_type, type = label, "SGD"

        def HasField(self, name):
            return name == "solver_type"
    assert tU.resolve_solver_type(Labelled()) == js.type
    # an explicit type wins over the enum, as in the reference
    tp.type = "AdaGrad"
    assert tU.resolve_solver_type(tp) == "AdaGrad"


# ---------------------------------------------------------------------------
# snapshots of an Adam solver

def test_adam_snapshot_round_trips_both_banks(tmp_path):
    """The port's .solverstate lists every param's "h", then every
    param's "h2"; the reference restores it into the same banks, and
    the port restores the reference's alike."""
    extra = 'type: "Adam" momentum2: 0.99'
    ts = port_solver(str(tmp_path / "port"), extra)
    ts.step(2)
    ts.snapshot()
    js = ref_solver(str(tmp_path / "ref"), extra)
    with jax.enable_x64(False):
        js.restore(files(str(tmp_path / "port"), 2)["solverstate"])
    for k, slots in js.history.items():
        assert set(slots) == {"h", "h2"}
        for s, v in slots.items():
            np.testing.assert_array_equal(host(v), ts.history[k][s].numpy())
    ref_step(js, 1)
    js.snapshot()
    back = port_solver(str(tmp_path / "back"), extra)
    back.restore(files(str(tmp_path / "ref"), 3)["solverstate"])
    assert back.iter == 3
    for k, slots in js.history.items():
        for s, v in slots.items():
            np.testing.assert_array_equal(back.history[k][s].numpy(),
                                          host(v))
    assert np.abs(back.history["fc1/0"]["h2"].numpy()).max() > 0
