"""The sweep's config_block and evaluate (parallel/sweep.py) in the port,
against the port's unblocked runner and the reference package's
SweepRunner.

Held (the blocked runner against the unblocked one, bit for bit, is in
tests/test_torch_config_block_lanes.py):
- the blocked port against the reference's blocked SweepRunner (engine
  "pallas", as tests/test_torch_sweep_strategies.py): per lane, banks
  and remap slots identical, losses within 1e-4 relative, params within
  rtol 1e-3, atol 1e-5 (that file's tolerances);
- the reference's divisibility ValueError; the lane keys derived once
  for all C (a block never derives its own);
- checkpoints cross block sizes both ways and continue bit for bit, a
  background write during a blocked run included;
- evaluate against the reference's, with and without adc_bits (outputs
  within 1e-5 relative: the two packages sum the products in other
  orders), the ADC changing the outputs, and lane i equal to a
  single-config forward of lane i's params (the same tolerance).
"""
import json

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver_mod

from test_torch_debug_trace import ListSink
from test_torch_sweep import MEANS, NET, SOLVER, STDS, batches, cycling
from test_torch_sweep_strategies import assert_lanes_agree, strategy_text

TIMING = ("wall_time", "step_latency_s", "iters_per_s")


def lanes(n, vals):
    return (vals * n)[:n]


def runner(text, bs, C, block=0, **kw):
    opts = dict(engine="cuda", packed_state=True, dtype_policy="ternary",
                device="cpu", means=lanes(C, MEANS), stds=lanes(C, STDS))
    opts.update(kw)
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=cycling(bs))
    sink = ListSink()
    if opts.pop("metrics", False):
        s.enable_metrics(sink)
    return TSweep(s, C, config_block=block, **opts), sink


def state_leaves(r):
    out = {}
    for ln, vals in r.params.items():
        for i, t in enumerate(vals):
            if t is not None:
                out[f"params/{ln}/{i}"] = t
    for k, slots in r.history.items():
        for sn, t in slots.items():
            out[f"history/{k}/{sn}"] = t
    for g, grp in r.fault_states.items():
        for k, t in grp.items():
            out[f"fault/{g}/{k}"] = t
    out["quarantine"] = r.quarantine
    return out


def bits_equal(x, y) -> bool:
    """Equal bit for bit (a NaN equals the same NaN)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def assert_same_state(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert bits_equal(la[k], lb[k]), k


def records_text(sink):
    return [json.dumps({k: v for k, v in r.items() if k not in TIMING},
                       sort_keys=True) for r in sink.records]


def test_blocked_matches_the_reference_blocked_runner(tmp_path):
    """Threshold and tracked remapping in blocks of 2 over 4 lanes, the
    port and the reference (engine "pallas", config_block 2), each
    drawing from one seed."""
    text = strategy_text(tmp_path, "remap")
    bs = batches(8, seed=3)
    port, _ = runner(text, bs, 4, 2, means=lanes(4, MEANS),
                     stds=lanes(4, STDS))
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        ref = JSweep(JSolver(sp, train_feed=cycling(bs)), 4,
                     means=lanes(4, MEANS), stds=lanes(4, STDS),
                     engine="pallas", packed_state=True,
                     dtype_policy="ternary", config_block=2)
    assert ref.config_block == port.config_block == 2
    for _ in range(4):
        losses = port.step(1)[0]
        with jax.enable_x64(False):
            ref_losses = ref.step(1)[0]
        assert_lanes_agree(port, ref, losses, ref_losses)
    assert (port.broken_fractions() > 0.05).all()


def test_config_block_values(tmp_path):
    bs = batches(1)
    with pytest.raises(ValueError, match="n_configs 8 not divisible by "
                                         "config_block 3"):
        runner(SOLVER, bs, 8, 3)
    for block, n_blocks in ((0, 1), (8, 1), (16, 1), (-2, 1), (4, 2),
                            (1, 8)):
        r, _ = runner(SOLVER, bs, 8, block)
        assert len(r._blocks) == n_blocks
        assert r.config_block == block and isinstance(r.config_block, int)


def test_lane_keys_are_derived_once_for_every_block(monkeypatch):
    """The blocks' keys are slices of the (C, 2) keys of the iteration,
    their noise found in the step's memo: the threefry derivations a run
    makes do not grow with the number of blocks."""
    counts = {}
    for block in (0, 2):
        calls = []
        orig = tsolver_mod.StepNoise._derive
        monkeypatch.setattr(tsolver_mod.StepNoise, "_derive",
                            lambda self, rng: (calls.append(rng.shape),
                                               orig(self, rng))[1])
        r, _ = runner(SOLVER, batches(3), 8, block)
        r.step(3)
        counts[block] = list(calls)
        monkeypatch.undo()
    assert counts[0] == counts[2] == [(64, 8, 2)]
    keys = r.lane_keys(1)
    assert keys.shape == (8, 2)
    nk, seeds = r._noise(keys[2:4])
    want_nk, want_seeds = r._noise(keys)
    np.testing.assert_array_equal(nk, want_nk[2:4])
    np.testing.assert_array_equal(seeds, want_seeds[2:4])


@pytest.mark.parametrize("write_block,read_block", [(4, 0), (0, 2), (4, 2)])
def test_checkpoint_crosses_block_sizes(tmp_path, write_block, read_block):
    """A checkpoint written by a runner in blocks of `write_block` (in
    the background, the run going on while the writer works) restores
    into a runner in blocks of `read_block`, and the next steps equal
    the writer's own, bit for bit; the file holds the state of its
    iteration."""
    bs = batches(8, seed=4)
    a, _ = runner(SOLVER, bs, 8, write_block)
    a.step(2)
    at_ckpt = {k: v.clone() for k, v in state_leaves(a).items()}
    path = str(tmp_path / "sweep.ckpt.npz")
    a.checkpoint(path, background=True)
    a.step(1)                   # writes the resident rows in place
    a.wait_for_writes()
    with np.load(path) as z:
        for k, v in at_ckpt.items():
            assert z[k].tobytes() == v.numpy().tobytes(), k
    cont_a = [a.step(1)[0].copy() for _ in range(2)]
    b, _ = runner(SOLVER, bs[2:] + bs[:2], 8, read_block)   # at iter 2
    b.restore(path)
    assert b.iter == 2
    b.step(1)
    cont_b = [b.step(1)[0].copy() for _ in range(2)]
    for x, y in zip(cont_a, cont_b):
        assert x.tobytes() == y.tobytes()
    assert_same_state(a, b)
    for r in (a, b):
        r.close()


def test_shared_bottom_conv_weight_gradient(monkeypatch):
    """The card's route for a bottom every lane shares (ops/vision.py
    _SharedBottomConv2d, run here on CPU tensors): one forward call, the
    weight gradient as batched im2col GEMMs of LANE_CHUNK lanes. Equal
    to autograd's conv within 1e-5 of the largest value (a GEMM sums in
    another order), and lanes [0, B) of a C-lane call equal a B-lane
    call bit for bit when LANE_CHUNK divides both."""
    from rram_caffe_simulation_tpu_torch.ops import vision
    monkeypatch.setattr(vision, "LANE_CHUNK", 2)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(4, 3, 9, 9).astype(np.float32))
    w = torch.from_numpy(rng.randn(6 * 5, 3, 3, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 6 * 5, 5, 5).astype(np.float32))

    def grads(lanes, conv):
        wl = w[:lanes * 5].clone().requires_grad_()
        y = conv(wl, lanes)
        return y.detach(), torch.autograd.grad(
            (y * g[:, :lanes * 5]).sum(), [wl])[0]
    route = lambda wl, lanes: vision._SharedBottomConv2d.apply(
        x, wl, (2, 2), (1, 1), (1, 1), lanes)
    y, gw = grads(6, route)
    y_ref, gw_ref = grads(6, lambda wl, _: torch.nn.functional.conv2d(
        x, wl, None, 2, 1))
    assert torch.equal(y, y_ref)
    np.testing.assert_allclose(gw.numpy(), gw_ref.numpy(), rtol=0,
                               atol=1e-5 * float(gw_ref.abs().max()))
    y4, gw4 = grads(4, route)
    assert torch.equal(gw4, gw[:20]) and torch.equal(y4, y[:, :20])


# ---------------------------------------------------------------------------
# evaluate

EVAL_NET = NET.replace(
    'layer { name: "loss"',
    'layer { name: "acc" type: "Accuracy" bottom: "ip2" bottom: "label" '
    'top: "acc" include { phase: TEST } }\nlayer { name: "loss"')


def eval_text(adc_bits):
    rf = f" rram_forward {{ adc_bits: {adc_bits} }}" if adc_bits else ""
    return (f'net_param {{ {EVAL_NET} }} base_lr: 0.05 momentum: 0.9 '
            'lr_policy: "fixed" display: 0 max_iter: 100 random_seed: 4 '
            'test_iter: 1 test_interval: 1000 failure_pattern { type: '
            f'"gaussian" mean: 300 std: 50 }}{rf}')


@pytest.mark.parametrize("adc_bits", [0, 3])
def test_evaluate_matches_the_reference(adc_bits):
    bs = batches(3, seed=7)
    text = eval_text(adc_bits)
    port, _ = runner(text, bs, 3, 0, means=MEANS, stds=STDS)
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        ref = JSweep(JSolver(sp, train_feed=cycling(bs)), 3, means=MEANS,
                     stds=STDS, engine="jax", packed_state=True,
                     dtype_policy="ternary")
    port.step(2)
    # one state for both: the port's, carried across
    p, h, f = convert.sweep_state_to_jax(port)
    ref.params = jax.tree.map(jnp.asarray, p)
    with jax.enable_x64(False):
        want = ref.evaluate(bs[2])
    got = port.evaluate(bs[2])
    assert sorted(got) == sorted(want) == ["acc", "loss"]
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape == (3,)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   err_msg=k)
    # lane i is the single-config forward of lane i's params
    net = port.solver.test_nets[0]
    feed = {k: torch.from_numpy(v) for k, v in bs[2].items()}
    for i in range(3):
        blobs, _ = net.apply(port.lane_state(i)[0], feed,
                             **port.solver._test_context())
        for k in got:
            np.testing.assert_allclose(got[k][i], blobs[k].numpy(),
                                       rtol=1e-5)


def test_evaluate_applies_adc_bits_and_tiles():
    """The ADC changes the outputs, as the reference's
    test_sweep_evaluate_applies_adc_bits holds; under a tile spec each
    lane is Solver.test's forward (per-tile ADCs) of its params."""
    rng = np.random.RandomState(5)
    b = {"data": rng.randn(4, 3, 8, 8).astype(np.float32),
         "label": rng.randint(0, 5, 4).astype(np.float32)}
    outs = {}
    for bits in (0, 3):
        r, _ = runner(eval_text(bits), [b], 2, 0)
        outs[bits] = r.evaluate(b)
    assert not np.allclose(outs[0]["loss"], outs[3]["loss"])
    text = eval_text(3).replace("adc_bits: 3", 'adc_bits: 3 tiles: "2x2"')
    r, _ = runner(text, [b], 2, 0)
    got = r.evaluate(b)
    net, ctx = r.solver.test_nets[0], r.solver._test_context()
    assert "tiles" in ctx
    for i in range(2):
        blobs, _ = net.apply(r.lane_state(i)[0],
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             **ctx)
        np.testing.assert_allclose(got["loss"][i], blobs["loss"].numpy(),
                                   rtol=1e-5)
    assert not np.allclose(got["loss"], outs[3]["loss"])
