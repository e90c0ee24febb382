"""The port's mitigation strategies against the reference package's, on
the same numpy inputs: the strategy functions of fault/strategies.py bit
for bit, the Solver's ApplyStrategy in lockstep with the reference's
jitted step on the narrowed CIFAR-10-quick of test_torch_solver.py
(threshold plus remapping, f32 and packed banks with the fused
epilogue), and the genetic search against the reference's Solver.step.

Exact where the reference is exact: thresholded updates, flag matrices,
neuron orders, permuted params and updates, slots, swaps, prune masks
and fault counters. Across the two step implementations a threshold
cell may flip where the GEMMs' summation order moves its update across
the cutoff: a counter may differ only where the port's |update| lies
within 1e-5 relative of its cutoff. Params are held within rtol 1e-3,
atol 1e-5 and losses within 1e-4 relative, as test_torch_solver.py
holds them."""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.fault import strategies as jstrat
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.utils.io import write_proto_binary
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.fault import strategies as tstrat
from rram_caffe_simulation_tpu_torch.parallel.sweep import SweepRunner
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_solver import NET, REPO, SOLVER

F32 = np.float32
FC = [("fc1/0", "fc1/1"), ("fc2/0", "fc2/1"), ("fc3/0", None)]
SHAPES = {"fc1/0": (12, 7), "fc1/1": (12,), "fc2/0": (9, 12), "fc2/1": (9,),
          "fc3/0": (4, 9)}
WEIGHTS = [w for w, _ in FC]


def bits(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.int32)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# the strategy functions

@pytest.mark.parametrize("threshold,rate,lr_mult", [
    (1e-3, 0.01, 1.0), (0.05, 0.001, 2.0), (0.3, 0.1, 1.0), (7e-4, 0.3, 0.1)])
def test_threshold_diffs_match_reference_bit_for_bit(threshold, rate,
                                                     lr_mult):
    """Tolerance: none (the bits, +0 against -0 included). The cutoff is
    float32 at each product, in order, as the reference computes it from
    its float32 rate: eagerly, and in its jitted step under a fixed
    policy, where the rate is a constant and the products run at trace
    time. (A rate traced from the iteration lets XLA fold threshold *
    lr_mult first, an ulp apart at (7e-4, 0.3, 0.1); ROADMAP §C.) Cells
    exactly at the cutoff and one ulp either side."""
    cutoff = F32(F32(F32(threshold) * F32(rate)) * F32(lr_mult))
    assert tstrat.threshold_cutoff(threshold, rate, lr_mult) == float(cutoff)
    rng = np.random.RandomState(0)
    diff = (rng.randn(40, 24) * cutoff * 2).astype(F32)
    up, down = np.nextafter(cutoff, F32(1)), np.nextafter(cutoff, F32(0))
    edge = [cutoff, -cutoff, up, down, -up, 0.0, -0.0]
    diff.flat[:len(edge)] = edge
    diffs = {"a/0": diff, "a/1": (diff[0] * 3).astype(F32)}
    lr = {"a/0": lr_mult, "a/1": 2 * lr_mult}
    mine = tstrat.threshold_diffs(to_torch(diffs), rate, lr, threshold)
    jitted = jax.jit(lambda d: jstrat.threshold_diffs(
        d, jnp.float32(rate), lr, threshold))
    for ref in (jitted(to_jax(diffs)),
                jstrat.threshold_diffs(to_jax(diffs), jnp.float32(rate), lr,
                                       threshold)):
        for k in diffs:
            np.testing.assert_array_equal(bits(mine[k].numpy()), bits(ref[k]))
    got = mine["a/0"].numpy().flat[:len(edge)]
    assert list(got == 0) == [True, True, False, True, False, True, True]
    assert 0 < (mine["a/0"] == 0).float().mean() < 1


def flag_state(rng, shapes, zeros=True):
    """Lifetimes on a coarse grid (many equal counts, some exactly 0)
    and stuck values in {-1, 0, +1}."""
    grid = [-200.0, -100.0, -0.5, 0.0, 0.5, 100.0] if zeros else \
        [-200.0, -100.0, -0.5, 0.5, 100.0]
    return {"lifetimes": {k: rng.choice(grid, s).astype(F32)
                          for k, s in shapes.items()},
            "stuck": {k: rng.choice([-1.0, 0.0, 1.0], s).astype(F32)
                      for k, s in shapes.items()}}


@pytest.mark.parametrize("hidden", [12, 64, 500])
@pytest.mark.parametrize("seed", range(4))
def test_sort_fc_neurons_on_ties_matches_reference(seed, hidden):
    """Tolerance: none. The counts are full of ties, so an unstable sort
    would part from jnp.argsort (torch's default sort on the CPU is
    stable only for short rows: 64 is CIFAR-10-quick's ip1); flags test
    life < 0, not <= 0."""
    rng = np.random.RandomState(seed)
    state = flag_state(rng, {"fc1/0": (hidden, 7), "fc2/0": (9, hidden),
                             "fc3/0": (4, 9)})
    if seed == 0:           # no flag at all: every count ties at 0
        state["stuck"] = {k: np.ones_like(v)
                          for k, v in state["stuck"].items()}
    for k in WEIGHTS:
        np.testing.assert_array_equal(
            tengine.stuck_zero_flags(to_torch(state), k).numpy(),
            np.asarray(jengine.stuck_zero_flags(to_jax(state), k)))
    ref = jstrat.sort_fc_neurons(to_jax(state), WEIGHTS)
    mine = tstrat.sort_fc_neurons(to_torch(state), WEIGHTS)
    assert len(mine) == len(ref) == 2
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    counts = (tengine.stuck_zero_flags(to_torch(state), "fc1/0").sum(1)
              + tengine.stuck_zero_flags(to_torch(state), "fc2/0").sum(0))
    assert len(torch.unique(counts)) < len(counts)          # ties


def remap_inputs(seed):
    rng = np.random.RandomState(seed)
    data = {k: rng.randn(*s).astype(F32) for k, s in SHAPES.items()}
    diffs = {k: (rng.randn(*s) * 1e-3).astype(F32) for k, s in SHAPES.items()}
    life = {k: (rng.randn(*s) * 150 + 100).astype(F32)
            for k, s in SHAPES.items()}
    for v in life.values():
        v.flat[::11] = 0.0          # broken, not failed (< 0 is the flag)
    stuck = {k: rng.choice([-1.0, 0.0, 1.0], s).astype(F32)
             for k, s in SHAPES.items()}
    prune = [rng.permutation(12).astype(np.int32),
             rng.permutation(9).astype(np.int32)]
    return rng, data, diffs, {"lifetimes": life, "stuck": stuck}, prune


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("fmt", ["f32", "packed"])
def test_remap_matches_reference_over_three_events(fmt, tracked):
    """Tolerance: none. Three events with cells wearing out in between;
    the flags come from the state (f32) or its unpacked view (packed
    banks, as the solver reads them)."""
    rng, data, diffs, state, prune = remap_inputs(1)
    spec = jpacked.make_pack_spec(state, 100.0, means=[100.0], stds=[150.0])
    jd, jdf, td, tdf = to_jax(data), to_jax(diffs), to_torch(data), \
        to_torch(diffs)
    slots0 = {"0": np.arange(12, dtype=np.int32),
              "1": np.arange(9, dtype=np.int32)}
    js, ts = to_jax(slots0), to_torch(slots0)
    moved = False
    for _ in range(3):
        if fmt == "packed":
            packed = jpacked.pack_state(state, spec)
            jview = jpacked.unpacked_view(to_jax(packed), spec)
            tview = tpacked.unpacked_view(
                convert.fault_state_from_jax(packed), spec)
        else:
            jview, tview = to_jax(state), to_torch(state)
        before = td["fc1/0"].clone()
        if tracked:
            jd, jdf, js = jstrat.remap_fc_neurons_tracked(jd, jdf, jview, FC,
                                                          prune, js)
            td, tdf, ts = tstrat.remap_fc_neurons_tracked(td, tdf, tview, FC,
                                                          prune, ts)
            for g in js:
                assert ts[g].dtype == torch.int32
                np.testing.assert_array_equal(ts[g].numpy(),
                                              np.asarray(js[g]))
        else:
            jd, jdf = jstrat.remap_fc_neurons(jd, jdf, jview, FC, prune)
            td, tdf = tstrat.remap_fc_neurons(td, tdf, tview, FC, prune)
        for k in SHAPES:
            np.testing.assert_array_equal(bits(td[k].numpy()), bits(jd[k]))
            np.testing.assert_array_equal(bits(tdf[k].numpy()), bits(jdf[k]))
        moved |= not torch.equal(before, td["fc1/0"])
        state = {"lifetimes": {k: np.where(rng.rand(*v.shape) < 0.5, v - 100,
                                           v).astype(F32)
                               for k, v in state["lifetimes"].items()},
                 "stuck": state["stuck"]}
    assert moved


def mlp(x, d):
    h = torch.relu(x @ d["fc1/0"].t() + d["fc1/1"])
    h = torch.relu(h @ d["fc2/0"].t() + d["fc2/1"])
    return h @ d["fc3/0"].t()


def test_remap_preserves_function():
    """The reference's tests/test_fault.py test_remap_preserves_function
    on the port, with a third FC layer: a consistent permutation of
    hidden neurons leaves the function unchanged (rtol 1e-5, atol 1e-5:
    the products sum in another order), and the most broken neuron
    hosts the last logical one of the prune order."""
    _, data, diffs, _, _ = remap_inputs(2)
    life = {k: np.ones(SHAPES[k], F32) for k in WEIGHTS}
    life["fc1/0"][2, :] = -1.0      # neuron 2 of group 0 broken at 0
    state = to_torch({"lifetimes": life,
                      "stuck": {k: np.zeros(SHAPES[k], F32) for k in WEIGHTS}})
    prune = [np.arange(12, dtype=np.int32), np.arange(9, dtype=np.int32)]
    d0 = to_torch(data)
    new, _ = tstrat.remap_fc_neurons(d0, to_torch(diffs), state, FC, prune)
    assert torch.equal(new["fc1/0"][2], d0["fc1/0"][11])
    x = torch.from_numpy(np.random.RandomState(3).randn(5, 7).astype(F32))
    torch.testing.assert_close(mlp(x, new), mlp(x, d0), rtol=1e-5,
                               atol=1e-5)


def test_remap_tracked_keeps_logical_identity():
    """Over several events with a changing state, the slot map finds
    every logical neuron's row where it lives (exact), and the function
    stays (rtol 1e-5, atol 1e-5)."""
    rng, data, diffs, state, prune = remap_inputs(4)
    d0 = to_torch(data)
    d, df = d0, to_torch(diffs)
    slots = to_torch({"0": np.arange(12, dtype=np.int32),
                      "1": np.arange(9, dtype=np.int32)})
    x = torch.from_numpy(rng.randn(5, 7).astype(F32))
    for _ in range(4):
        d, df, slots = tstrat.remap_fc_neurons_tracked(
            d, df, to_torch(state), FC, prune, slots)
        s0, s1 = slots["0"].long(), slots["1"].long()
        assert torch.equal(d["fc1/0"][s0], d0["fc1/0"])
        assert torch.equal(d["fc1/1"][s0], d0["fc1/1"])
        assert torch.equal(d["fc2/0"][s1][:, s0], d0["fc2/0"])
        assert torch.equal(d["fc2/1"][s1], d0["fc2/1"])
        assert torch.equal(d["fc3/0"][:, s1], d0["fc3/0"])
        torch.testing.assert_close(mlp(x, d), mlp(x, d0), rtol=1e-5,
                                   atol=1e-5)
        state = flag_state(rng, SHAPES, zeros=False)


def genetic_inputs(seed):
    rng = np.random.RandomState(seed)
    data = {k: rng.randn(*s).astype(F32) for k, s in SHAPES.items()}
    diffs = {k: (rng.randn(*s) * 1e-3).astype(F32) for k, s in SHAPES.items()}
    life = {k: (rng.randn(*SHAPES[k]) * 100).astype(F32) for k in WEIGHTS}
    masks = [np.where(rng.rand(*SHAPES[k]) < 0.5, 0.0,
                      np.abs(rng.randn(*SHAPES[k]))).astype(F32)
             for k in WEIGHTS]
    return rng, data, diffs, life, masks


def test_genetic_matches_reference_over_three_applications():
    """Seed 0 (the reference's default): the same RandomState call
    sequence, so the same swaps; data, diffs, prune masks and the
    overall distance exact after each of three applications."""
    rng, data, diffs, life, masks = genetic_inputs(5)
    kw = dict(fc_pairs=FC, start=3, period=5, switch_time=40)
    jg = jstrat.GeneticStrategy(prune_weights=[m.copy() for m in masks], **kw)
    tg = tstrat.GeneticStrategy(prune_weights=[m.copy() for m in masks], **kw)
    assert [jg.due() for _ in range(14)] == [tg.due() for _ in range(14)]
    jd = {k: v.copy() for k, v in data.items()}
    jdf = {k: v.copy() for k, v in diffs.items()}
    td = {k: v.copy() for k, v in data.items()}
    tdf = {k: v.copy() for k, v in diffs.items()}
    swapped = False
    for _ in range(3):
        assert tg.overall_dist(life) == jg.overall_dist(life)
        before = td["fc1/0"].copy()
        jg.apply(jd, jdf, life)
        tg.apply(td, tdf, life)
        for k in SHAPES:
            np.testing.assert_array_equal(bits(td[k]), bits(jd[k]))
            np.testing.assert_array_equal(bits(tdf[k]), bits(jdf[k]))
        for a, b in zip(tg.prune_weights, jg.prune_weights):
            np.testing.assert_array_equal(a, b)
        assert tg.overall_dist(life) == jg.overall_dist(life)
        swapped |= not np.array_equal(before, td["fc1/0"])
        life = {k: np.where(rng.rand(*v.shape) < 0.3, v - 100, v).astype(F32)
                for k, v in life.items()}
    assert swapped


def order_file(tmp_path, rows, name="order.txt"):
    path = tmp_path / name
    path.write_text("".join(" ".join(str(int(v)) for v in r) + "\n"
                            for r in rows))
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("bogus", r"unknown failure strategy 'bogus'"),
    ("genetic", r"genetic strategy requires a prune net"),
    ("rows", r"prune_order_file has 2 rows but the net has 1 hidden FC "
             r"groups"),
    ("short", r"prune_order row 0 is not a permutation of 0\.\.15 \(got 15 "
              r"entries\)"),
    ("dup", r"prune_order row 0 is not a permutation of 0\.\.15 \(got 16 "
            r"entries\)"),
    ("one_fc", r"genetic strategy needs >= 2 fault-target FC layers"),
])
def test_build_strategies_errors_match_reference(tmp_path, case, match):
    perm = list(range(16))
    rows = {"rows": [perm, perm], "short": [perm[:-1]],
            "dup": [perm[:-1] + [0]]}.get(case)
    text = (f'type: "remapping" prune_order_file: '
            f'"{order_file(tmp_path, rows)}"' if rows else
            'type: "bogus"' if case == "bogus" else 'type: "genetic"')
    sp_text = f"failure_strategy {{ {text} }}"
    ref = pb.SolverParameter()
    text_format.Parse(sp_text, ref)
    mine = tproto.parse(sp_text, "SolverParameter")
    pairs = [("ip1/0", "ip1/1"), ("ip2/0", "ip2/1")]
    loader = None
    if case == "one_fc":
        pairs = pairs[:1]
        loader = lambda net, model: [np.ones((16, 4), F32)]  # noqa: E731
    for mod, sp in ((jstrat, ref), (tstrat, mine)):
        with pytest.raises(ValueError, match=match):
            mod.build_strategies(sp, pairs, prune_net_loader=loader,
                                 hidden_sizes=[16])


def test_track_identity_needs_a_fault_engine(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    text = (SOLVER.split(" failure_pattern")[0] + ' failure_strategy { '
            'type: "remapping" track_identity: true prune_order_file: '
            f'"{order_file(tmp_path, [range(16)])}" }}')
    ref = pb.SolverParameter()
    text_format.Parse(text, ref)
    match = r"remapping with track_identity needs an active fault engine"
    with pytest.raises(ValueError, match=match):
        JSolver(ref)
    with pytest.raises(ValueError, match=match):
        TSolver(tproto.parse(text, "SolverParameter"), device="cpu")


def test_sweep_refuses_a_strategy_solver_by_name(monkeypatch, tmp_path):
    """The sweep runs every strategy in its lanes (threshold, remapping,
    genetic), and its checkpoint carries the genetic search; what it
    refuses, by name, is a restore that disagrees on the genetic
    strategy (tests/test_torch_sweep_strategies.py holds the lanes
    against the reference)."""
    monkeypatch.chdir(REPO)
    net_file, model_file, _ = prune_model(tmp_path)
    text = (f'{SOLVER} failure_strategy {{ type: "threshold" threshold: '
            f'0.005 }} failure_strategy {{ type: "remapping" '
            f'prune_order_file: "{order_file(tmp_path, [range(16)])}" }} '
            f'failure_strategy {{ type: "genetic" start: 1 period: 1 '
            f'prune_net_file: "{net_file}" prune_model_file: '
            f'"{model_file}" }}')
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    r = SweepRunner(s, n_configs=2, device="cpu")
    assert np.isfinite(r.step(2)[0]).all()
    assert len(r._genetics) == 2
    path = r.checkpoint(str(tmp_path / "sweep.ckpt.npz"))
    again = SweepRunner(TSolver(tproto.parse(text, "SolverParameter"),
                                device="cpu"), n_configs=2, device="cpu")
    again.restore(path)
    assert again.iter == 2
    for a, b in zip(again._genetics, r._genetics):
        assert a._rng.randint(1 << 30) == b._rng.randint(1 << 30)
        for x, y in zip(a.prune_weights, b.prune_weights):
            np.testing.assert_array_equal(x, y)
    plain = SweepRunner(TSolver(tproto.parse(SOLVER, "SolverParameter"),
                                device="cpu"), n_configs=2, device="cpu")
    with pytest.raises(ValueError, match="disagree on the genetic"):
        plain.restore(path)


def test_remap_slots_ride_through_the_state_helpers(monkeypatch, tmp_path):
    """A tracked solver's identity slots (int32, one group per hidden
    FC group) survive packing, the unpacked view, the flat .npz layout,
    the conversion to the reference's layout and back, and stay out of
    the broken census."""
    monkeypatch.chdir(REPO)
    text = strategy_solver_text(tmp_path, tracked=True)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 dtype_policy="ternary", fault_format="packed")
    state = ts.fault_state
    assert set(state) == {"life_q", "stuck_bits", "remap_slots"}
    assert torch.equal(state["remap_slots"]["0"],
                       torch.arange(16, dtype=torch.int32))
    view = tpacked.unpacked_view(state, ts.pack_spec, WEIGHTS_IP)
    assert view["remap_slots"] is state["remap_slots"]
    flat = tengine.state_to_arrays(state)
    assert "remap_slots/0" in flat
    back = tengine.state_from_arrays(flat)
    again = convert.fault_state_from_jax(convert.fault_state_to_jax(back))
    for g in state:
        for k, v in state[g].items():
            assert again[g][k].dtype == v.dtype
            assert torch.equal(again[g][k], v)
    assert tengine.broken_fraction(state) == tengine.broken_fraction(
        {"life_q": state["life_q"]})


# ---------------------------------------------------------------------------
# the Solver against the reference's step

THRESHOLD = 0.005       # zeroes about half of ip1's early updates
WEIGHTS_IP = ["ip1/0", "ip2/0"]


def strategy_solver_text(tmp_path, tracked, extra=""):
    perm = np.random.RandomState(11).permutation(16)
    return (f'{SOLVER} failure_strategy {{ type: "threshold" threshold: '
            f'{THRESHOLD} }} failure_strategy {{ type: "remapping" start: 1 '
            f'period: 2 prune_order_file: "{order_file(tmp_path, [perm])}" '
            f'track_identity: {"true" if tracked else "false"} }}{extra}')


def boundary_cells(upd, lr_mults, rate):
    """Cells whose |update| lies within 1e-5 relative of the cutoff."""
    out = {}
    for k, u in upd.items():
        cut = tstrat.threshold_cutoff(THRESHOLD, rate, lr_mults[k])
        out[k] = (u.abs() - cut).abs() <= 1e-5 * cut
    return out


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("fmt", ["f32", "packed"])
def test_strategy_step_matches_reference_in_lockstep(monkeypatch, tmp_path,
                                                     fmt, tracked):
    """Six steps; each starts both packages from the reference's state
    and batch: the reference's jitted make_train_step(hw_engine="pallas",
    dtype_policy="ternary", ...) and the port's step on engine "cuda"
    (the plain versions on the CPU), both given the reference's do_remap
    from _remap_due_at (start 1, period 2: steps 0, 2 and 4), which the
    port's _remap_due_at must also name. The fault updates before
    ApplyStrategy are read from the input of threshold_diffs."""
    monkeypatch.chdir(REPO)
    text = strategy_solver_text(tmp_path, tracked)
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, train_feed=jfeed._python_data_feed(
        JNet(sp.net_param, pb.TRAIN).layers[0]))
    opts = dict(dtype_policy="ternary", fault_format=fmt)
    state = {g: {k: np.asarray(v) for k, v in leaves.items()}
             for g, leaves in js.fault_state.items()}
    spec = None
    if fmt == "packed":
        spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                      pattern=sp.failure_pattern)
        state = jpacked.pack_state(state, spec)
        opts.update(pack_spec=spec, fused_epilogue=True)
    jstep = jax.jit(js.make_train_step(hw_engine="pallas", **opts))

    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 hw_engine="cuda", dtype_policy="ternary", fault_format=fmt,
                 fused_epilogue=True if fmt == "packed" else None)
    assert ts.pack_spec == spec
    assert (ts.strategies.remap_tracked, ts.strategies.threshold) == (
        tracked, pytest.approx(THRESHOLD))
    assert ("remap_slots" in ts.fault_state) == tracked
    step = ts.make_train_step(hw_engine="cuda", **opts)
    seen, threshold_diffs = [], tstrat.threshold_diffs
    monkeypatch.setattr(tstrat, "threshold_diffs", lambda diffs, *a: (
        seen.append(diffs), threshold_diffs(diffs, *a))[1])
    lr_mults = {f"{r.layer_name}/{r.slot}": r.lr_mult
                for r in ts._owner_refs}
    life_group = "life_q" if fmt == "packed" else "lifetimes"

    params, hist, jstate = js.params, js.history, to_jax(state)
    zeroed = []
    for it in range(6):
        ts.params = convert.params_from_jax(
            {k: [np.asarray(a) for a in v] for k, v in params.items()})
        ts.history = {k: {s: torch.from_numpy(np.array(a)) for s, a in
                          v.items()} for k, v in hist.items()}
        ts.fault_state = convert.fault_state_from_jax(
            jax.tree.map(np.asarray, jstate))
        view = (tpacked.unpacked_view(ts.fault_state, spec, WEIGHTS_IP)
                if fmt == "packed" else ts.fault_state)
        slots_before = ts.fault_state.get("remap_slots")
        batch = {k: np.asarray(v) for k, v in js.train_feed().items()}
        due = js._remap_due_at(it)
        assert due == (it % 2 == 0) == ts._remap_due_at(it)
        params, hist, jstate, loss, _, _ = jstep(
            params, hist, jstate, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
            jnp.int32(it), jax.random.fold_in(js._key, it), due)
        seen.clear()
        ts.params, ts.history, ts.fault_state, tloss, _ = step(
            ts.params, ts.history, ts.fault_state,
            {k: torch.from_numpy(v) for k, v in batch.items()}, it,
            prng.fold_in(ts._key, it), do_remap=due)
        assert float(tloss) == pytest.approx(float(loss), rel=1e-4)

        assert len(seen) == 1
        upd = seen[0]
        rate = ts._lr_fn(it)
        zeroed.append(float(np.mean([
            float((u.abs() <= tstrat.threshold_cutoff(
                THRESHOLD, rate, lr_mults[k])).float().mean())
            for k, u in upd.items()])))
        edge = boundary_cells(upd, lr_mults, rate)
        if due:                 # the mask moves with the remapped cells
            args = (edge, edge, view, ts.fc_pairs, ts.strategies.prune_orders)
            edge = (tstrat.remap_fc_neurons_tracked(*args, slots_before)[1]
                    if tracked else tstrat.remap_fc_neurons(*args)[1])
        for k, ref in jstate[life_group].items():
            mine = ts.fault_state[life_group][k].numpy()
            differ = mine != np.asarray(ref)
            assert not (differ & ~edge[k].numpy()).any(), (it, k)
        if tracked:
            for g, ref in jstate["remap_slots"].items():
                np.testing.assert_array_equal(
                    ts.fault_state["remap_slots"][g].numpy(),
                    np.asarray(ref))
        for ln, vals in params.items():
            for a, b in zip(vals, ts.params[ln]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-3, atol=1e-5)
    assert all(0 < z < 1 for z in zeroed), zeroed
    assert tengine.broken_fraction(ts.fault_state) > 0.01


PRUNE_NET = NET.replace("include { phase: TRAIN } ", "")


def prune_model(tmp_path):
    """The prune net's prototxt and a .caffemodel of it written by the
    reference's to_proto: ip1/ip2 magnitudes with the smaller half
    zero."""
    net_param = pb.NetParameter()
    text_format.Parse(PRUNE_NET, net_param)
    net_file = tmp_path / "prune.prototxt"
    net_file.write_text(PRUNE_NET)
    pn = JNet(net_param, pb.TRAIN)
    params = {k: [np.asarray(a) for a in v]
              for k, v in pn.init(jax.random.PRNGKey(1)).items()}
    for ln in ("ip1", "ip2"):
        w = np.abs(params[ln][0])
        params[ln][0] = np.where(w < np.median(w), 0.0, w).astype(F32)
    model_file = str(tmp_path / "prune.caffemodel")
    write_proto_binary(model_file, pn.to_proto(params))
    return str(net_file), model_file, [params["ip1"][0], params["ip2"][0]]


def test_genetic_prune_model_must_hold_the_fc_weights(monkeypatch,
                                                     tmp_path):
    """A prune model with weights for none of the prune net's FC layers
    (here renamed) raises instead of handing the search the fillers'
    draw as its masks."""
    monkeypatch.chdir(REPO)
    net_file, model_file, _ = prune_model(tmp_path)
    model = tproto.decode(open(model_file, "rb").read(), "NetParameter")
    for lp in model.layer:
        lp.name = "old_" + lp.name
    other = tmp_path / "renamed.caffemodel"
    other.write_bytes(tproto.encode(model))
    text = (f'{SOLVER} failure_strategy {{ type: "genetic" '
            f'prune_net_file: "{net_file}" prune_model_file: "{other}" }}')
    with pytest.raises(ValueError, match=r"holds weights for none of the "
                                         r"fault-target FC layers"):
        TSolver(tproto.parse(text, "SolverParameter"), device="cpu")


@pytest.mark.parametrize("fmt", ["f32", "packed"])
def test_genetic_solver_matches_reference(monkeypatch, tmp_path, fmt):
    """Six steps of Solver.step in both packages from one init (the
    reference's, carried over), genetic start 1, period 2 (applications
    before steps 0, 2 and 4), switch_time 50: the prune masks read from
    the reference-written .caffemodel, the lifetimes (or, under the
    port's packed banks, their counters against the reference's f32
    lifetimes packed) and the masks after every step exact, losses
    within 1e-4 relative, params within rtol 1e-3, atol 1e-5."""
    monkeypatch.chdir(REPO)
    net_file, model_file, masks = prune_model(tmp_path)
    text = (f'{SOLVER} failure_strategy {{ type: "genetic" start: 1 '
            f'period: 2 switch_time: 50 prune_net_file: "{net_file}" '
            f'prune_model_file: "{model_file}" }}')
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, train_feed=jfeed._python_data_feed(
        JNet(sp.net_param, pb.TRAIN).layers[0]))
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 fault_format=fmt)
    for mine, ref in zip(ts.strategies.genetic.prune_weights, masks):
        np.testing.assert_array_equal(mine, ref)
    ts.params = convert.params_from_jax(
        {k: [np.asarray(a) for a in v] for k, v in js.params.items()})
    f32_state = {g: {k: np.asarray(v) for k, v in leaves.items()}
                 for g, leaves in js.fault_state.items()}
    ts.fault_state = convert.fault_state_from_jax(
        jpacked.pack_state(f32_state, ts.pack_spec) if fmt == "packed"
        else f32_state)
    start_masks = [m.copy() for m in ts.strategies.genetic.prune_weights]
    for _ in range(6):
        js.step(1)
        ts.step(1)
        assert float(ts.last_loss) == pytest.approx(
            float(js.losses[-1]), rel=1e-4)
        ref_life = {k: np.asarray(v)
                    for k, v in js.fault_state["lifetimes"].items()}
        for k, v in ref_life.items():
            if fmt == "packed":
                np.testing.assert_array_equal(
                    ts.fault_state["life_q"][k].numpy(),
                    jpacked.pack_lifetimes(v, 100.0,
                                           ts.pack_spec["life_dtype"]))
            else:
                np.testing.assert_array_equal(
                    ts.fault_state["lifetimes"][k].numpy(), v)
        for a, b in zip(ts.strategies.genetic.prune_weights,
                        js.strategies.genetic.prune_weights):
            np.testing.assert_array_equal(a, b)
    assert ts.strategies.genetic.times == 6
    assert any(not np.array_equal(a, b) for a, b in
               zip(start_masks, ts.strategies.genetic.prune_weights))
    for ln, vals in js.params.items():
        for a, b in zip(vals, ts.params[ln]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                       atol=1e-5)
