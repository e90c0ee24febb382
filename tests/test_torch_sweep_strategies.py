"""The failure strategies over the sweep's config lanes in the port
(fault/strategies.py with a lane axis, parallel/sweep.py SweepRunner)
against the reference package's.

Held:
- the laned remap (tracked or not) equals the single-config call on each
  lane's tensors, and the reference's single-config call, bit for bit,
  at ip1's width (64 hidden neurons whose flag counts tie: the argsort
  must be stable);
- a port SweepRunner against the reference's SweepRunner on the small
  conv net of tests/test_torch_sweep.py at C = 3 lanes from one seed,
  the ternary read and packed banks: with threshold and tracked
  remapping (reference engine "pallas": its "jax" engine's read passes a
  straight-through gradient to broken cells, which the threshold then
  sees and the remap moves onto healthy cells, where its kernel and the
  port give them none), with the genetic search and under iter_size 2
  (engine "jax").
  After every step: life_q banks identical per lane, remap slots and
  prune masks identical, losses within 1e-4 relative, params within
  rtol 1e-3, atol 1e-5 (the two packages sum convolutions and products
  in other orders, as tests/test_torch_sweep.py holds them);
- a quarantined lane skips the genetic search and its generator does
  not advance;
- a checkpoint of a tracked-remap sweep restores across the packages,
  `remap_slots` included; a checkpoint of a genetic sweep carries the
  search state and restores, and a file without it is refused by name.
"""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import strategies as jstrat
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.utils.io import write_proto_binary
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import strategies as tstrat
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_sweep import MEANS, NET, SOLVER, STDS, batches, cycling

F32 = np.float32
C = 3
THRESHOLD = 0.01
HIDDEN = 12                       # ip1's outputs in the small net


def order_file(tmp_path, seed=11):
    path = tmp_path / "order.txt"
    path.write_text(" ".join(map(str, np.random.RandomState(seed)
                                 .permutation(HIDDEN))) + "\n")
    return str(path)


def prune_files(tmp_path):
    """The small net as the prune net, and a .caffemodel of it written by
    the reference's to_proto: ip1/ip2 magnitudes, the smaller half
    zero."""
    net_param = pb.NetParameter()
    text_format.Parse(NET, net_param)
    net_file = tmp_path / "prune.prototxt"
    net_file.write_text(NET)
    pn = JNet(net_param, pb.TEST)
    with jax.enable_x64(False):
        params = {k: [np.asarray(a) for a in v]
                  for k, v in pn.init(jax.random.PRNGKey(1)).items()}
    for ln in ("ip1", "ip2"):
        w = np.abs(params[ln][0])
        params[ln][0] = np.where(w < np.median(w), 0.0, w).astype(F32)
    model_file = str(tmp_path / "prune.caffemodel")
    write_proto_binary(model_file, pn.to_proto(params))
    return str(net_file), model_file


def strategy_text(tmp_path, kind):
    remap = (f' failure_strategy {{ type: "remapping" start: 1 period: 2 '
             f'track_identity: true prune_order_file: '
             f'"{order_file(tmp_path)}" }}')
    if kind == "tracked":
        return f"{SOLVER} {remap}"
    if kind == "remap":
        return (f'{SOLVER} failure_strategy {{ type: "threshold" threshold: '
                f'{THRESHOLD} }} {remap}')
    if kind == "genetic":
        net_file, model_file = prune_files(tmp_path)
        return (f'{SOLVER} failure_strategy {{ type: "genetic" start: 2 '
                f'period: 2 switch_time: 20 prune_net_file: "{net_file}" '
                f'prune_model_file: "{model_file}" }}')
    return f"{SOLVER} iter_size: 2"


def port_runner(text, bs, C=C):
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=cycling(bs))
    return TSweep(s, C, means=MEANS[:C], stds=STDS[:C], engine="cuda",
                  packed_state=True, dtype_policy="ternary", device="cpu")


def ref_runner(text, bs, C=C, engine="jax"):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        return JSweep(JSolver(sp, train_feed=cycling(bs)), C,
                      means=MEANS[:C], stds=STDS[:C], engine=engine,
                      packed_state=True, dtype_policy="ternary")


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def assert_lanes_agree(port, ref, losses, ref_losses):
    np.testing.assert_allclose(losses, np.asarray(ref_losses), rtol=1e-4)
    ref_state = host(ref.fault_states)
    for g in ("life_q", "remap_slots"):
        for k, v in ref_state.get(g, {}).items():
            np.testing.assert_array_equal(port.fault_states[g][k].numpy(),
                                          v, err_msg=f"{g}/{k}")
    for ln, vals in host(ref.params).items():
        for a, b in zip(vals, port.params[ln]):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# the laned remap

def remap_inputs(seed, shapes):
    rng = np.random.RandomState(seed)
    data = {k: rng.randn(C, *s).astype(F32) for k, s in shapes.items()}
    diffs = {k: rng.randn(C, *s).astype(F32) for k, s in shapes.items()}
    weights = [k for k in shapes if k.endswith("/0")]
    # few broken stuck-at-0 cells, so the flag counts tie
    state = {"lifetimes": {k: np.where(rng.rand(C, *shapes[k]) < 0.01,
                                       -50.0, 300.0).astype(F32)
                           for k in weights},
             "stuck": {k: rng.randint(-1, 2, (C,) + shapes[k]).astype(F32)
                       for k in weights}}
    return data, diffs, state


@pytest.mark.parametrize("tracked", [False, True])
def test_laned_remap_equals_single_config_per_lane(tracked):
    shapes = {"ip1/0": (64, 1024), "ip1/1": (64,), "ip2/0": (10, 64),
              "ip2/1": (10,)}
    fc = [("ip1/0", "ip1/1"), ("ip2/0", "ip2/1")]
    data, diffs, state = remap_inputs(2, shapes)
    prune = [np.random.RandomState(4).permutation(64).astype(np.int32)]
    slots = {"0": np.stack([np.random.RandomState(5 + c).permutation(64)
                            for c in range(C)]).astype(np.int32)}
    tt = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    tstate = {g: tt(v) for g, v in state.items()}
    args = (tt(data), tt(diffs), tstate, fc, prune)
    laned = (tstrat.remap_fc_neurons_tracked(*args, tt(slots)) if tracked
             else tstrat.remap_fc_neurons(*args))
    counts = [tstrat.sort_fc_neurons(tstate, ["ip1/0", "ip2/0"])[0]]
    assert counts[0].shape == (C, 64)
    for c in range(C):
        lane = lambda tree: {k: v[c] for k, v in tree.items()}
        one_args = (tt(lane(data)), tt(lane(diffs)),
                    {g: tt(lane(v)) for g, v in state.items()}, fc, prune)
        one = (tstrat.remap_fc_neurons_tracked(*one_args,
                                               tt(lane(slots)))
               if tracked else tstrat.remap_fc_neurons(*one_args))
        with jax.enable_x64(False):
            j_args = ({k: jnp.asarray(v[c]) for k, v in data.items()},
                      {k: jnp.asarray(v[c]) for k, v in diffs.items()},
                      {g: {k: jnp.asarray(v[c]) for k, v in leaves.items()}
                       for g, leaves in state.items()}, fc, prune)
            ref = (jstrat.remap_fc_neurons_tracked(
                *j_args, {g: jnp.asarray(v[c]) for g, v in slots.items()})
                if tracked else jstrat.remap_fc_neurons(*j_args))
        for got, single, want in zip(laned, one, ref):
            for k in want:
                assert torch.equal(got[k][c], single[k]), (c, k)
                np.testing.assert_array_equal(single[k].numpy(),
                                              np.asarray(want[k]))
    flags = (state["lifetimes"]["ip1/0"] < 0) & (state["stuck"]["ip1/0"]
                                                 == 0)
    per_neuron = flags.sum(-1)
    assert len(np.unique(per_neuron[0])) < 64          # ties to break


def test_threshold_under_lanes_is_elementwise():
    rng = np.random.RandomState(1)
    diffs = {"ip1/0": rng.randn(C, 5, 4).astype(F32) * F32(1e-3)}
    laned = tstrat.threshold_diffs({k: torch.from_numpy(v)
                                    for k, v in diffs.items()}, 0.05,
                                   {"ip1/0": 2.0}, THRESHOLD)
    for c in range(C):
        one = tstrat.threshold_diffs({"ip1/0": torch.from_numpy(
            diffs["ip1/0"][c])}, 0.05, {"ip1/0": 2.0}, THRESHOLD)
        assert torch.equal(laned["ip1/0"][c], one["ip1/0"])


# ---------------------------------------------------------------------------
# the sweep against the reference's

@pytest.mark.parametrize("kind", ["remap", "genetic", "iter_size"])
def test_strategy_sweep_matches_reference(tmp_path, monkeypatch, kind):
    text = strategy_text(tmp_path, kind)
    bs = batches(12, seed=3)
    port = port_runner(text, bs)
    ref = ref_runner(text, bs, engine="pallas" if kind == "remap" else "jax")
    zeroed = []
    orig = tstrat.threshold_diffs

    def record(diffs, rate, lr_mults, threshold):
        out = orig(diffs, rate, lr_mults, threshold)
        zeroed.append(float(np.mean([float((v == 0).float().mean())
                                     for v in out.values()])))
        return out
    monkeypatch.setattr(tstrat, "threshold_diffs", record)
    if kind == "remap":
        for g, v in port.fault_states["remap_slots"].items():
            assert torch.equal(v, torch.arange(HIDDEN, dtype=torch.int32)
                               .repeat(C, 1))
    for _ in range(6):                               # held every step
        losses = port.step(1)[0]
        with jax.enable_x64(False):
            ref_losses = ref.step(1)[0]
        assert_lanes_agree(port, ref, losses, ref_losses)
        if kind == "genetic":
            for mine, theirs in zip(port._genetics, ref._genetics):
                for a, b in zip(mine.prune_weights, theirs.prune_weights):
                    np.testing.assert_array_equal(a, b)
    assert port.iter == ref.iter == 6
    if kind == "remap":
        assert 0 < min(zeroed) and max(zeroed) < 1, zeroed
        slots = port.fault_states["remap_slots"]["0"]
        assert not torch.equal(slots[0], torch.arange(HIDDEN,
                                                      dtype=torch.int32))
    if kind == "genetic":
        start = port.solver.strategies.genetic.prune_weights
        assert all(any(not np.array_equal(a, b) for a, b in
                       zip(start, g.prune_weights))
                   for g in port._genetics)
    assert (port.broken_fractions() > 0.05).all()


def test_genetic_runs_between_chunks_before_its_iteration(tmp_path,
                                                          monkeypatch):
    """start 2, period 2: the search is due before iterations 1, 3, 5; a
    chunk of 5 is cut there, and each application sees the state the
    steps before it left."""
    text = strategy_text(tmp_path, "genetic")
    port = port_runner(text, batches(6, seed=3))
    seen = []
    orig = port._apply_genetic
    monkeypatch.setattr(port, "_apply_genetic",
                        lambda: (seen.append(port.iter), orig())[1])
    port.step(6, chunk=5)
    assert seen == [1, 3, 5]
    assert [port._genetic_due_at(i) for i in range(6)] == [
        False, True, False, True, False, True]


def test_quarantined_lane_skips_the_genetic_search(tmp_path):
    text = strategy_text(tmp_path, "genetic")
    port = port_runner(text, batches(6, seed=3))
    port.params["ip2"][0][1, 0, 0] = float("nan")
    port.step(1)
    assert port.quarantined().tolist() == [1]
    before = port.lane_state(1)[0]
    fresh = np.random.RandomState(port._genetics[1].seed).get_state()
    masks = [m.copy() for m in port._genetics[1].prune_weights]
    port.step(4, chunk=2)                      # searches before 1 and 3
    after = port.lane_state(1)[0]
    for ln, vals in before.items():
        for a, b in zip(vals, after[ln]):
            assert a is None or a.numpy().tobytes() == b.numpy().tobytes()
    state = port._genetics[1]._rng.get_state()
    assert state[2] == fresh[2] and np.array_equal(state[1], fresh[1])
    assert all(np.array_equal(a, b) for a, b in
               zip(masks, port._genetics[1].prune_weights))
    moved = port._genetics[0]._rng.get_state()
    assert moved[2] != fresh[2] or not np.array_equal(moved[1], fresh[1])
    assert np.isfinite(port.last_losses[[0, 2]]).all()


# ---------------------------------------------------------------------------
# checkpoints

def test_remap_slots_round_trip_across_the_packages(tmp_path):
    """A port checkpoint of a tracked-remap sweep restores in the
    reference and continues alike; the reference's restores in the
    port."""
    text = strategy_text(tmp_path, "tracked")
    bs = batches(10, seed=3)
    port = port_runner(text, bs)
    port.step(3, chunk=3)                 # remaps at 0 and 2
    path = port.checkpoint(str(tmp_path / "port.ckpt.npz"))
    with np.load(path) as z:
        assert {"fault/remap_slots/0"} <= set(z.files)
    ref = ref_runner(text, bs[3:] + bs[:3], engine="pallas")  # from 3 on
    with jax.enable_x64(False):
        ref.restore(path)
    for g, v in host(ref.fault_states)["remap_slots"].items():
        np.testing.assert_array_equal(port.fault_states["remap_slots"][g]
                                      .numpy(), v)
    losses = port.step(2, chunk=2)[0]     # a remap at 4
    with jax.enable_x64(False):
        ref_losses = ref.step(2, chunk=2)[0]
        back_path = ref.checkpoint(str(tmp_path / "ref.ckpt.npz"))
    assert_lanes_agree(port, ref, losses, ref_losses)
    back = port_runner(text, bs)
    back.restore(back_path)
    assert back.iter == 5
    for g, v in port.fault_states["remap_slots"].items():
        assert torch.equal(back.fault_states["remap_slots"][g], v)
    for k, v in port.fault_states["life_q"].items():
        assert torch.equal(back.fault_states["life_q"][k], v)


def test_genetic_checkpoint_raises_by_name(tmp_path):
    """A genetic sweep's checkpoint carries `__genetics__` (the reference's
    pickle, fault/genetic_state.py) and restores into a genetic runner,
    every lane's search included; a file without the search state is
    refused by name (tests/test_torch_genetic_checkpoint.py holds the
    bytes and the continuations against the reference)."""
    from rram_caffe_simulation_tpu_torch.fault import genetic_state
    text = strategy_text(tmp_path, "genetic")
    port = port_runner(text, batches(2))
    port.step(1)
    path = port.checkpoint(str(tmp_path / "g.ckpt.npz"))
    with np.load(path) as z:
        saved = genetic_state.loads(z["__genetics__"])
    back = port_runner(text, batches(2))
    back.restore(path)
    assert back.iter == 1 and len(back._genetics) == len(saved) == C
    for a, b in zip(back._genetics, port._genetics):
        assert a.times == b.times
        assert a._rng.randint(1 << 30) == b._rng.randint(1 << 30)
        for x, y in zip(a.prune_weights, b.prune_weights):
            np.testing.assert_array_equal(x, y)
    plain = port_runner(SOLVER, batches(2))
    path = plain.checkpoint(str(tmp_path / "plain.ckpt.npz"))
    with pytest.raises(ValueError, match="disagree on the genetic"):
        port.restore(path)
