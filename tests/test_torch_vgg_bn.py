"""The experiment template's VGG11-BN net in the port against the
reference package, on the CPU.

- Full width (models/cifar10_vgg11/cifar10_vgg11_template.prototxt and
  its net; the port's Solver drawing the reference's params from the
  seed is held in tests/test_torch_vgg_bn_full.py): one forward and
  backward at batch 8 matches: loss within 1e-5
  relative, every gradient and every moving statistic within 1e-4 of
  its tensor's largest value (a batch mean of mixed signs cancels).
  Batch 8, not 2: at batch 2
  the fc BatchNorms see m = 2 samples, where every output is +-1 and the
  backward is a difference of nearly equal terms (the packages' gradients
  part by 2% there, rounding alone). A bias that feeds a BatchNorm (every
  conv's, fc1's, fc2's) has a true gradient of zero: both packages' must
  be below 1e-5 of that layer's weight gradient.
- A narrow VGG-BN Solver (two conv-BN-Scale-ReLU blocks, fc-BN-Scale,
  fc; batch 8 from the in-repo LMDB; lifetimes N(250, 120) so cells
  break; packed banks, the ternary crossbar read, the fused epilogue)
  in lockstep with the reference's jitted step (Pallas in interpret
  mode), each step from the reference's state: life_q bit for bit
  (except on fc1's bias cells, which feed a BatchNorm: their true
  gradient is zero, both packages' updates there are rounding or an
  exact 0, and a cell counts a write on that; each such cell is
  checked to be one), scale_factor bit for bit, loss within 1e-5
  relative, params and history within rtol 1e-4 / atol 1e-6, the
  statistics within 1e-4 relative or of their largest value (XLA
  contracts the moving updates into fused multiply-adds and sums in
  another order). Ten
  steps at iter_size 1, five at iter_size 2.
- solve() to a shortened max_iter with BINARYPROTO snapshots: the
  reference restores the port's last snapshot and writes the same three
  files, byte for byte.
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
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver
from rram_caffe_simulation_tpu_torch.utils import io as tio

from test_torch_solver import REPO

F32 = np.float32
TEMPLATE = "models/cifar10_vgg11/cifar10_vgg11_template.prototxt"
REL, ATOL = 1e-4, 1e-6


def bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def host(a):
    return np.array(a, copy=True)


# ---------------------------------------------------------------------------
# full width

def template_param(mean=40.0, std=10.0):
    """The template as run_gaussian_exp.py patches it (a short-lifetime
    gaussian), with BINARYPROTO snapshots."""
    sp = tio.read_solver_param(f"{REPO}/{TEMPLATE}")
    sp.failure_pattern.mean = mean
    sp.failure_pattern.std = std
    sp.snapshot_format = tproto.BINARYPROTO
    return sp


def test_full_width_forward_backward_matches(monkeypatch):
    monkeypatch.chdir(REPO)
    text = open(f"{REPO}/models/cifar10_vgg11/"
                "cifar10_vgg11_fc1024_bn_scale_msra_fc_also.prototxt").read()
    text = text.replace("batch_size: 100", "batch_size: 8")
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    tp = tnet.init(prng.PRNGKey(11))
    rng = np.random.RandomState(0)
    batch = {"data": rng.rand(8, 3, 32, 32).astype(F32),
             "label": rng.randint(0, 10, 8).astype(F32)}
    with jax.enable_x64(False):
        jnet = JNet(jmsg, pb.TRAIN)
        jp = {k: [jnp.asarray(a) for a in v]
              for k, v in convert.params_to_jax(tp).items()}

        def f(p):
            _, loss, newp = jnet.apply(p, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, with_updates=True)
            return loss, newp
        (jloss, jnew), jg = jax.value_and_grad(f, has_aux=True)(jp)
    leaves = {k: [t.requires_grad_() for t in v] for k, v in tp.items()}
    _, tloss, tnew = tnet.apply(leaves, {k: torch.from_numpy(v) for k, v in
                                         batch.items()}, with_updates=True)
    flat = [(k, i, t) for k, v in leaves.items() for i, t in enumerate(v)]
    tg = torch.autograd.grad(tloss, [t for _, _, t in flat],
                             allow_unused=True)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for (k, i, t), g in zip(flat, tg):
        want = np.asarray(jg[k][i])
        got = np.zeros_like(want) if g is None else g.numpy()
        if k.startswith("bn_"):
            assert not got.any() and not want.any(), k
            stat = np.asarray(jnew[k][i])
            np.testing.assert_allclose(tnew[k][i].detach().numpy(), stat,
                                       rtol=0, atol=REL * np.abs(stat).max(),
                                       err_msg=k)
            continue
        if i == 1 and tnet.feeds_batchnorm(k):
            # a bias before a BatchNorm: zero up to rounding in both
            scale = float(np.abs(np.asarray(jg[k][0])).max())
            assert np.abs(want).max() < 1e-5 * scale, k
            assert np.abs(got).max() < 1e-5 * scale, k
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{k}/{i}")


# ---------------------------------------------------------------------------
# a narrow VGG-BN Solver in lockstep with the reference's step

def conv_block(i, bottom, n):
    c = f"conv{i}"
    return (f'layer {{ name: "{c}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{c}" param {{ lr_mult: 1 }} param {{ lr_mult: 2 }} '
            f'convolution_param {{ num_output: {n} pad: 1 kernel_size: 3 '
            'weight_filler { type: "msra" } bias_filler { type: "constant" '
            '} } }\n'
            f'layer {{ name: "bn_{c}" type: "BatchNorm" bottom: "{c}" '
            f'top: "{c}" }}\n'
            f'layer {{ name: "scale_{c}" type: "Scale" bottom: "{c}" '
            f'top: "{c}" scale_param {{ bias_term: true }} }}\n'
            f'layer {{ name: "relu_{c}" type: "ReLU" bottom: "{c}" '
            f'top: "{c}" }}\n'
            f'layer {{ name: "pool{i}" type: "Pooling" bottom: "{c}" '
            f'top: "pool{i}" pooling_param {{ pool: MAX kernel_size: 2 '
            'stride: 2 } }\n')


def fc(name, bottom, n, bn=True):
    out = (f'layer {{ name: "{name}" type: "InnerProduct" bottom: '
           f'"{bottom}" top: "{name}" param {{ lr_mult: 1 }} param {{ '
           f'lr_mult: 2 }} inner_product_param {{ num_output: {n} '
           'weight_filler { type: "msra" } bias_filler { type: "constant" '
           '} } }\n')
    if bn:
        out += (f'layer {{ name: "bn_{name}" type: "BatchNorm" bottom: '
                f'"{name}" top: "{name}" }}\n'
                f'layer {{ name: "scale_{name}" type: "Scale" bottom: '
                f'"{name}" top: "{name}" scale_param {{ bias_term: true }} '
                '}\n'
                f'layer {{ name: "relu_{name}" type: "ReLU" bottom: '
                f'"{name}" top: "{name}" }}\n')
    return out


DATA = ('layer { name: "cifar" type: "Data" top: "data" top: "label" '
        'include { phase: TRAIN } transform_param { scale: 0.00390625 } '
        'data_param { source: "examples/cifar10/cifar10_train_lmdb" '
        'batch_size: 8 backend: LMDB } }\n')
NARROW = ('name: "VGG_BN_narrow" ' + DATA + conv_block(1, "data", 4)
          + conv_block(2, "pool1", 8) + fc("fc1", "pool2", 16)
          + fc("fc2", "fc1", 10, bn=False)
          + 'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" '
            'bottom: "label" top: "loss" }\n')
SOLVER = (f'net_param {{ {NARROW} }} base_lr: 0.01 momentum: 0.9 '
          'weight_decay: 0.004 lr_policy: "fixed" display: 0 '
          'max_iter: 100 random_seed: 3 failure_pattern { type: "gaussian" '
          'mean: 250 std: 120 }')
STATS = [f"bn_{n}" for n in ("conv1", "conv2", "fc1")]


def ref_param(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return sp


def lockstep(monkeypatch, text, steps):
    """`steps` steps, each from the reference's state and batch. Returns
    the port Solver, its scale_factor sequence and the cells whose write
    the two packages decided apart (`Net.bn_fed_biases`: the port's
    update was an exact 0 where the reference wrote, or rounding-sized
    where it did not; such a cell's param may then be stuck in one
    package only and is left out of that step's param check)."""
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
    updates = []
    orig = tsolver.fused_update_fail_leaves
    monkeypatch.setattr(tsolver, "fused_update_fail_leaves",
                        lambda d, u, q, st, **kw: (updates.append(u),
                                                   orig(d, u, q, st,
                                                        **kw))[1])
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 hw_engine="cuda", dtype_policy="ternary",
                 fault_format="packed", fused_epilogue=True)
    assert ts.pack_spec == spec and ts._step_fn.fused_epilogue_resolved
    noisy = ts.net.bn_fed_biases(ts._fault_keys)
    rate = float(sp.base_lr)
    params, hist = js.params, js.history
    for ln, vals in params.items():        # one draw from the seed
        for a, b in zip(vals, ts.params[ln]):
            np.testing.assert_array_equal(bits(b.numpy()), bits(a))
    sfs, apart = [], 0
    for it in range(steps):
        ts.params = convert.params_from_jax(
            {k: [host(a) for a in v] for k, v in params.items()})
        ts.history = {k: {s: torch.from_numpy(host(a)) for s, a in
                          v.items()} for k, v in hist.items()}
        ts.fault_state = convert.fault_state_from_jax(
            jax.tree.map(host, jstate))
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
        assert float(tloss) == pytest.approx(float(loss), rel=1e-5), it
        upd = dict(zip(ts._fault_keys, updates[-1]))
        masks = {}
        for k, ref in jstate["life_q"].items():
            got, want = ts.fault_state["life_q"][k].numpy(), host(ref)
            differ = got != want
            if k in noisy:
                u = upd[k].numpy()
                assert (u[differ & (got > want)] == 0).all(), (it, k)
                assert (np.abs(u[differ & (got < want)])
                        <= 1e-6 * rate).all(), (it, k)
                apart += int(differ.sum())
                masks[k] = differ
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"step {it} {k}")
        for ln, vals in params.items():
            for i, (a, b) in enumerate(zip(vals, ts.params[ln])):
                if ln in STATS and i == 2:
                    np.testing.assert_array_equal(bits(b.numpy()), bits(a))
                    continue
                keep = ~masks.get(f"{ln}/{i}", np.zeros(a.shape, bool))
                # a statistic within 1e-4 of its largest (a batch mean
                # of mixed signs cancels)
                atol = (REL * float(np.abs(host(a)).max()) if ln in STATS
                        else ATOL)
                np.testing.assert_allclose(b.numpy()[keep], host(a)[keep],
                                           rtol=REL, atol=atol,
                                           err_msg=f"step {it} {ln}/{i}")
        for k, slots in hist.items():
            keep = ~masks.get(k, np.zeros(np.shape(params[k.split("/")[0]][
                int(k.split("/")[1])]), bool))
            for s, a in slots.items():
                np.testing.assert_allclose(ts.history[k][s].numpy()[keep],
                                           host(a)[keep], rtol=REL,
                                           atol=ATOL)
        sfs.append(float(ts.params["bn_fc1"][2]))
    assert ts.broken_fraction() > 0.01
    return ts, sfs, apart


@pytest.mark.parametrize("iter_size,steps", [(1, 10), (2, 5)])
def test_narrow_solver_matches_reference_in_lockstep(monkeypatch, iter_size,
                                                     steps):
    """Under iter_size 2 each sub-pass advances the statistics, so
    scale_factor takes two steps of its sequence per iteration."""
    monkeypatch.chdir(REPO)
    ts, sfs, apart = lockstep(monkeypatch, f"{SOLVER} iter_size: {iter_size}",
                              steps)
    assert ts.net.bn_fed_biases(ts._fault_keys) == {"fc1/1"}
    # a few of fc1's 16 bias cells a step at most
    assert apart <= 4 * steps
    want, sf = [], F32(0)
    for _ in range(steps * iter_size):
        sf = F32(np.float64(F32(0.999)) * np.float64(sf) + 1.0)   # fma
        want.append(float(sf))
    assert sfs == want[iter_size - 1::iter_size]
    for ln in STATS:
        assert ts.params[ln][1].min() > 0


def test_solve_snapshots_cross_to_the_reference(monkeypatch, tmp_path):
    """solve() to iteration 4 with a snapshot every 2 (BINARYPROTO): the
    reference restores the port's last snapshot and writes the same
    .caffemodel, .solverstate and .faultstate bytes; the port restores
    the reference's iteration-2 snapshot as the reference reads it."""
    monkeypatch.chdir(REPO)
    prefix = str(tmp_path / "vgg")
    text = (f'{SOLVER} snapshot: 2 snapshot_format: BINARYPROTO '
            f'snapshot_prefix: "{prefix}"').replace("max_iter: 100",
                                                   "max_iter: 4")
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 dtype_policy="ternary")
    ts.solve()
    assert ts.iter == 4
    exts = ("caffemodel", "solverstate", "faultstate")
    mine = {e: open(f"{prefix}_iter_4.{e}", "rb").read() for e in exts}
    with jax.enable_x64(False):
        js = JSolver(ref_param(text))
        js.restore(f"{prefix}_iter_4.solverstate")
        for ln, vals in js.params.items():
            for a, b in zip(vals, ts.params[ln]):
                np.testing.assert_array_equal(bits(a), bits(b.numpy()))
        js.snapshot()
    for e in exts:
        assert open(f"{prefix}_iter_4.{e}", "rb").read() == mine[e], e
    back = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                   dtype_policy="ternary")
    back.restore(f"{prefix}_iter_2.solverstate")
    assert back.iter == 2
    model = tio.read_net_param(f"{prefix}_iter_2.caffemodel")
    stats = {lp.name: [tio.blob_to_array(b) for b in lp.blobs]
             for lp in model.layer if lp.type == "BatchNorm"}
    assert sorted(stats) == sorted(STATS)
    for ln, arrs in stats.items():
        for a, b in zip(arrs, back.params[ln]):
            np.testing.assert_array_equal(a, b.numpy())
    assert float(back.params["bn_fc1"][2]) == float(
        F32(np.float64(F32(0.999)) * 1.0 + 1.0))


TEST_DATA = DATA.replace("phase: TRAIN", "phase: TEST").replace(
    "cifar10_train_lmdb", "cifar10_test_lmdb")
WITH_TEST = (SOLVER.replace(NARROW, NARROW.replace(DATA, DATA + TEST_DATA)
                            + 'layer { name: "acc" type: "Accuracy" '
                            'bottom: "fc2" bottom: "label" top: "acc" '
                            'include { phase: TEST } }\n')
             + ' test_iter: 2 test_interval: 0 test_compute_loss: true')


def test_test_net_reads_global_stats_and_advances_nothing(monkeypatch):
    """Solver.test: the TEST net's BatchNorms normalise by the stored
    sums over scale_factor (use_global_stats follows the phase); the
    scores equal the reference's test on the same params within 1e-5,
    and no param moves."""
    monkeypatch.chdir(REPO)
    assert WITH_TEST.count("cifar10_test_lmdb") == 1
    ts = TSolver(tproto.parse(WITH_TEST, "SolverParameter"), device="cpu",
                 dtype_policy="ternary")
    ts.step(3)
    assert all(ly.use_global_stats for ly in ts.test_nets[0].layers
               if ly.type_name == "BatchNorm")
    before = {k: [t.clone() for t in v] for k, v in ts.params.items()}
    scores = ts.test_all()[0]
    for ln, vals in before.items():
        for a, b in zip(vals, ts.params[ln]):
            assert torch.equal(a, b), ln
    with jax.enable_x64(False):
        js = JSolver(ref_param(WITH_TEST))
        js.params = {k: [jnp.asarray(a) for a in v] for k, v in
                     convert.params_to_jax(ts.params).items()}
        js.iter = ts.iter
        want = js.test(0)
    assert set(scores) == set(want) == {"acc", "loss"}
    for k in scores:
        assert scores[k] == pytest.approx(float(want[k]), rel=1e-5, abs=1e-6)


def test_convert_carries_the_statistics_and_scales():
    """params_to_jax / params_from_jax keep BatchNorm's three blobs and
    Scale's two, dtype and shape, bit for bit."""
    net = TNet(tproto.parse(NARROW, "NetParameter"), tproto.TRAIN,
               device="cpu")
    params = net.init(prng.PRNGKey(2))
    params["bn_fc1"][2] = torch.tensor([3.25])
    back = convert.params_from_jax(convert.params_to_jax(params))
    for ln in ("bn_conv1", "bn_fc1", "scale_conv2", "scale_fc1"):
        assert len(back[ln]) == len(params[ln]) == (3 if ln[:2] == "bn"
                                                    else 2)
        for a, b in zip(params[ln], back[ln]):
            assert b.dtype == a.dtype and torch.equal(a, b)


def test_reference_engines_agree_read_by_read_under_conv_also():
    """ROADMAP's check of the tiled read under an ADC: the narrow net
    with `conv_also` on 128x128 tiles and 8-bit ADCs, three steps of the
    reference's jitted step on its "jax" engine and on its "pallas"
    engine (interpret mode), both from the same state at each step (the
    "jax" engine's). Every forward top (debug_info's mean-abs vector)
    through fc1's read (the reads conv1, conv2, fc1) is equal bit for
    bit at the first step, and every top within 1e-6 relative at every
    step (where they differ, by one or two ulps of a mean |output|: the
    two engines sum some products in other orders): the reference's
    engines do not part read by read. They part in the backward (the
    "jax" engine's straight-through gradient of broken cells, ROADMAP
    §C). The port's kernel and plain tiled reads part on the card (phase
    16 (g): 97% of VGG11 fc1's outputs one ADC level apart)."""
    text = SOLVER.replace(
        'mean: 250 std: 120 }', 'mean: 250 std: 120 conv_also: true } '
        'rram_forward { adc_bits: 8 tiles: "cells=128x128" }')
    sp = ref_param(text)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=jfeed._python_data_feed(
            JNet(sp.net_param, pb.TRAIN).layers[0]))
        assert js.tile_spec.canonical() == "cells=128x128"
        assert {"conv1/0", "conv2/0", "fc1/0"} <= set(js._fault_keys)
        spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                      pattern=sp.failure_pattern)
        state = jax.tree.map(jnp.asarray, jpacked.pack_state(
            {g: {k: np.asarray(v) for k, v in leaves.items()}
             for g, leaves in js.fault_state.items()}, spec))
        steps = {}
        for engine in ("jax", "pallas"):
            steps[engine] = jax.jit(js.make_train_step(
                hw_engine=engine, dtype_policy="ternary",
                fault_format="packed", pack_spec=spec, fused_epilogue=False,
                with_debug=True))
            assert steps[engine].hw_engine_resolved == engine
        tops = [i for i, entry in enumerate(js.debug_spec.fwd)
                if entry[0] == "top"]
        last = [i for i in tops if js.debug_spec.fwd[i][1] == "fc2"]
        tops = [i for i in tops if i < last[0]]
        assert len(tops) == 16 and len(last) == 1
        p, h, st = js.params, js.history, state
        for it in range(3):
            batch = {k: jnp.asarray(np.asarray(v)) for k, v in
                     js.train_feed().items()}
            out = {e: step(p, h, st, batch, jnp.int32(it),
                           jax.random.fold_in(js._key, it), False)
                   for e, step in steps.items()}
            (p, h, st, la, _, ma), (_, _, _, lb, _, mb) = \
                out["jax"], out["pallas"]
            fa, fb = (np.asarray(m["debug"]["fwd"]) for m in (ma, mb))
            if it == 0:
                np.testing.assert_array_equal(bits(fa[tops]),
                                              bits(fb[tops]))
            np.testing.assert_allclose(fa[tops + last], fb[tops + last],
                                       rtol=1e-6, err_msg=str(it))
            np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
