"""The forward key (`Net.apply(rng=...)`, `LayerContext.rng`), Dropout,
DummyData and the LMDB writer in the port against the reference package,
on the CPU.

- Dropout (TRAIN and TEST, in place and not, ratio 0.5, 0.7 and 0) and
  DummyData (the `shape` and the legacy num/channels/height/width forms;
  constant, gaussian, uniform, xavier and msra fillers; one filler
  repeated for several tops; the default filler): tops bit for bit
  against the reference's Net.apply on the same key, and the gradient
  through Dropout bit for bit. positive_unitball's division by the row
  sum is held within 2 ulps, as tests/test_torch_cifar10_full.py holds
  the filler (XLA's CPU row sum adds in another order).
- A layer that draws refuses to run without a key, by name.
- Lanes: a Dropout over a shared bottom and over a laned one, and a random
  DummyData, over 4 lanes: each lane's top is the reference's
  single-config top on that lane's key, bit for bit (the products
  after an InnerProduct within 1e-5, the masks exact); those tops are
  laned, a constant DummyData's is not. The sweep over a net with two
  Dropouts and a random DummyData against the reference's sweep (losses
  within 1e-4 relative, banks bit for bit), in blocks of 2 against the
  unblocked runner bit for bit, and each lane against a single-config
  Solver from its state (loss within 1e-5 relative, banks identical).
- iter_size 2: each sub-pass draws from fold_in(step key, i); the
  Solver's step against the reference's (loss within 1e-5 relative,
  params within 1e-5).
- Solver.test: test batch i draws from fold_in(fold_in(key, iter), i);
  the scores against the reference's within 1e-6 relative.
- virtual_time: the two-wave self-healing scenario of
  tests/test_torch_virtual_time.py over a net with a Dropout, in
  lockstep with the reference through both refills (its checks: banks
  bit for bit, reports, the lane keys).
- `evaluate` passes no key, as the reference's: a random DummyData in
  the evaluated net raises.
- BulkWriter and array_to_datum: the same Datum bytes and the same LMDB
  file bytes as the reference's writer; an LMDB of either reads back
  record for record through the other's reader.
"""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.data import lmdb_py as jlmdb
from rram_caffe_simulation_tpu.data.db import array_to_datum as j_to_datum
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.data import lmdb_py as tlmdb
from rram_caffe_simulation_tpu_torch.data.feed import array_to_datum
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

import test_torch_virtual_time as vt
from test_torch_sweep import batches, cycling

F32 = np.float32


@pytest.fixture(autouse=True)
def no_x64():
    with jax.enable_x64(False):
        yield


def bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def jkey(key):
    return jnp.asarray(np.asarray(key, np.uint32))


def nets(text, phase):
    m = pb.NetParameter()
    text_format.Parse(text, m)
    return (JNet(m, phase),
            TNet(tproto.parse(text, "NetParameter"), phase, device="cpu"))


# ---------------------------------------------------------------------------
# Dropout

def dropout_text(ratio, in_place):
    top = "x" if in_place else "y"
    return f"""name: "drop"
layer {{ name: "in" type: "Input" top: "x" top: "t"
  input_param {{ shape {{ dim: 6 dim: 5 dim: 7 dim: 3 }}
                shape {{ dim: 6 dim: 105 }} }} }}
layer {{ name: "drop" type: "Dropout" bottom: "x" top: "{top}"
  dropout_param {{ dropout_ratio: {ratio} }} }}
layer {{ name: "flat" type: "Flatten" bottom: "{top}" top: "f" }}
layer {{ name: "loss" type: "EuclideanLoss" bottom: "f" bottom: "t"
  top: "loss" }}
"""


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("ratio", [0.5, 0.7, 0.0])
@pytest.mark.parametrize("phase", [0, 1])
def test_dropout_matches_the_reference(phase, ratio, in_place):
    jn, tn = nets(dropout_text(ratio, in_place), phase)
    rs = np.random.RandomState(3)
    x = rs.randn(6, 5, 7, 3).astype(F32)
    t = rs.randn(6, 105).astype(F32)
    key = prng.fold_in(prng.PRNGKey(11), 4)

    def loss_fn(xx):
        b, loss = jn.apply({}, {"x": xx, "t": jnp.asarray(t)},
                           rng=jkey(key))
        return loss, b["f"]
    (_, jf), jg = jax.value_and_grad(loss_fn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    blobs, loss = tn.apply({}, {"x": xt, "t": torch.from_numpy(t)}, rng=key)
    tg, = torch.autograd.grad(loss, xt)
    np.testing.assert_array_equal(bits(blobs["f"].detach()), bits(jf))
    np.testing.assert_array_equal(bits(tg), bits(jg))
    drops = phase == 0 and ratio > 0
    kept = (blobs["f"] != 0).float().mean().item()
    if drops:
        assert abs(kept - (1 - ratio)) < 0.1
    else:
        np.testing.assert_array_equal(bits(blobs["f"].detach()),
                                      bits(x.reshape(6, -1)))
    assert tn.layer_by_name["drop"].draws_tops() == (drops,)


# ---------------------------------------------------------------------------
# DummyData

DUMMY_CASES = {
    "shape, one filler repeated": (
        'data_filler { type: "gaussian" std: 2 mean: 0.5 } '
        "shape { dim: 4 dim: 3 dim: 5 dim: 5 } shape { dim: 4 dim: 7 } "
        'top: "b"'),
    "legacy form, two fillers": (
        'data_filler { type: "uniform" min: -2 max: 3 } '
        'data_filler { type: "constant" value: 1.5 } '
        "num: 2 channels: 3 height: 4 width: 5 "
        "num: 2 channels: 1 height: 1 width: 9 "
        'top: "b"'),
    "default filler": "shape { dim: 3 dim: 4 }",
    "xavier and msra": (
        'data_filler { type: "xavier" } data_filler { type: "msra" } '
        "shape { dim: 6 dim: 8 dim: 3 dim: 3 } "
        'top: "b"'),
    "sparse gaussian": (
        'data_filler { type: "gaussian" std: 1 sparse: 3 } '
        "shape { dim: 40 dim: 30 }"),
    "positive_unitball": (
        'data_filler { type: "positive_unitball" } '
        "shape { dim: 5 dim: 64 }"),
}


def dummy_text(case):
    body = DUMMY_CASES[case]
    tops = ['top: "a"'] + [p for p in ['top: "b"'] if p in body]
    body = body.replace('top: "b"', "")
    return (f'name: "dummy" layer {{ name: "dummy" type: "DummyData" '
            f'{" ".join(tops)} dummy_data_param {{ {body} }} }}')


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("case", list(DUMMY_CASES))
def test_dummydata_matches_the_reference(case, phase):
    jn, tn = nets(dummy_text(case), phase)
    key = prng.fold_in(prng.PRNGKey(2), 9)
    want, _ = jn.apply({}, {}, rng=jkey(key))
    got, _ = tn.apply({}, {}, rng=key)
    assert tn.blob_shapes == {k: tuple(v) for k, v in jn.blob_shapes.items()}
    for top in tn.layers[0].lp.top:
        g, w = bits(got[top]), bits(want[top])
        assert g.shape == w.shape, top
        if case == "positive_unitball":
            assert np.abs(g - w).max() <= 2
        else:
            np.testing.assert_array_equal(g, w, err_msg=top)
    types = tn.layers[0].filler_types
    assert tn.layers[0].draws_tops() == tuple(t != "constant" for t in types)


def test_a_layer_that_draws_needs_a_key():
    """Dropout in TRAIN and a random DummyData refuse to run without a
    key, by name (the reference asserts); a constant DummyData and
    Dropout in TEST need none."""
    jn, tn = nets(dropout_text(0.5, False), 0)
    batch = {"x": np.zeros((6, 5, 7, 3), F32), "t": np.zeros((6, 105), F32)}
    with pytest.raises(AssertionError, match="PRNG key"):
        jn.apply({}, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="Dropout 'drop' in TRAIN"):
        tn.apply({}, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, tn = nets(dropout_text(0.5, False), 1)
    tn.apply({}, {k: torch.from_numpy(v) for k, v in batch.items()})
    jn, tn = nets(dummy_text("xavier and msra"), 0)
    with pytest.raises(AssertionError, match="PRNG key"):
        jn.apply({}, {})
    with pytest.raises(ValueError, match="DummyData 'dummy'"):
        tn.apply({}, {})
    _, tn = nets(dummy_text("default filler"), 0)
    assert float(tn.apply({}, {})[0]["a"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# lanes

LANE_NET = """name: "lanes"
layer { name: "in" type: "Input" top: "x" input_param {
  shape { dim: 4 dim: 3 dim: 5 dim: 5 } } }
layer { name: "noise" type: "DummyData" top: "n" top: "zero"
  dummy_data_param { data_filler { type: "gaussian" std: 0.5 }
    data_filler { type: "constant" value: 0.25 }
    shape { dim: 4 dim: 3 dim: 5 dim: 5 } } }
layer { name: "shared" type: "Dropout" bottom: "x" top: "d0"
  dropout_param { dropout_ratio: 0.3 } }
layer { name: "sum" type: "Eltwise" bottom: "d0" bottom: "n" top: "s" }
layer { name: "ip" type: "InnerProduct" bottom: "s" top: "ip"
  inner_product_param { num_output: 16
    weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "own" type: "Dropout" bottom: "ip" top: "ip"
  dropout_param { dropout_ratio: 0.7 } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip" top: "out"
  inner_product_param { num_output: 3
    weight_filler { type: "gaussian" std: 0.2 } } }
"""
LANE_TOPS = ("n", "zero", "d0", "s", "ip", "out")


def test_each_lane_draws_from_its_own_key():
    """Over 4 lanes every drawn top is lane c's single-config top on key
    rng[c]: the shared bottom's Dropout and the DummyData's random top
    are laned, the constant top is not."""
    C = 4
    jn, tn = nets(LANE_NET, 0)
    assert tn.laned_blobs() == {"n", "d0", "s", "ip", "out"}
    params = tn.init(prng.PRNGKey(5))
    x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(F32)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(7), 3)[None],
                        np.arange(C))
    lane_params = {ln: [v.unsqueeze(0).expand((C,) + tuple(v.shape))
                        .clone() for v in vals]
                   for ln, vals in params.items()}
    got, _ = tn.apply(lane_params, {"x": torch.from_numpy(x)}, rng=keys,
                      lanes=C)
    jparams = {ln: [jnp.asarray(v.numpy()) for v in vals]
               for ln, vals in params.items()}
    laned = tn.laned_blobs()
    for c in range(C):
        want, _ = jn.apply(jparams, {"x": jnp.asarray(x)}, rng=jkey(keys[c]))
        for top in LANE_TOPS:
            lane = tn.lanes_first(top, got[top], C, top in laned)[c]
            if top in ("ip", "out"):
                # a product over lanes adds in another order than one
                # lane's: the values within rounding, the mask exact
                np.testing.assert_allclose(lane.numpy(), want[top],
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_array_equal(lane.numpy() == 0,
                                              np.asarray(want[top]) == 0)
            else:
                np.testing.assert_array_equal(
                    bits(lane), bits(want[top]), err_msg=f"{top} lane {c}")
    lanes_d0 = tn.lanes_first("d0", got["d0"], C, True)
    assert not torch.equal(lanes_d0[0], lanes_d0[1])


SWEEP_NET = """name: "sweep_drop"
layer { name: "in" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "noise" type: "DummyData" top: "noise"
  dummy_data_param { data_filler { type: "gaussian" std: 0.1 }
    shape { dim: 4 dim: 3 dim: 8 dim: 8 } } }
layer { name: "jitter" type: "Eltwise" bottom: "data" bottom: "noise"
  top: "jitter" }
layer { name: "drop0" type: "Dropout" bottom: "jitter" top: "jitter"
  dropout_param { dropout_ratio: 0.2 } }
layer { name: "conv1" type: "Convolution" bottom: "jitter" top: "conv1"
  convolution_param { num_output: 4 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 12
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "drop1" type: "Dropout" bottom: "ip1" top: "ip1"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""
SWEEP_SOLVER = (f'net_param {{ {SWEEP_NET} }} base_lr: 0.05 momentum: 0.9 '
                'weight_decay: 0.004 lr_policy: "fixed" display: 0 '
                'max_iter: 100 random_seed: 4 failure_pattern { '
                'type: "gaussian" mean: 250 std: 30 }')
MEANS, STDS = [250.0, 450.0, 300.0, 280.0], [30.0, 250.0, 120.0, 60.0]


def port_sweep(bs, C, block=0):
    s = TSolver(tproto.parse(SWEEP_SOLVER, "SolverParameter"), device="cpu",
                train_feed=cycling(bs))
    return TSweep(s, C, means=MEANS[:C], stds=STDS[:C], engine="cuda",
                  packed_state=True, dtype_policy="ternary", device="cpu",
                  config_block=block)


def host_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_sweep_with_dropout_matches_the_reference():
    """C = 4: the port's sweep against the reference's on one state (the
    reference's lanes are jax.vmap over the lane keys), 3 chunks of 2."""
    bs = batches(6, seed=5)
    port = port_sweep(bs, 4)
    sp = pb.SolverParameter()
    text_format.Parse(SWEEP_SOLVER, sp)
    ref = JSweep(JSolver(sp, train_feed=cycling(bs)), 4, means=MEANS,
                 stds=STDS, engine="jax", packed_state=True,
                 dtype_policy="ternary")
    p, h, f = convert.sweep_state_to_jax(port)
    ref.params, ref.history, ref.fault_states = (
        jax.tree.map(jnp.asarray, t) for t in (p, h, f))
    for _ in range(3):
        got = port.step(2, chunk=2)[0]
        want = np.asarray(ref.step(2, chunk=2)[0])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        want_banks = host_tree(ref.fault_states)["life_q"]
        for k, lq in port.fault_states["life_q"].items():
            np.testing.assert_array_equal(lq.numpy(), want_banks[k])
    assert (port.broken_fractions() > 0).all()
    port.close()


def test_sweep_blocks_and_lanes_with_dropout():
    """Blocks of 2 equal the unblocked runner bit for bit (a lane's key,
    and so its masks, does not depend on config_block); each lane equals
    a single-config Solver from its state on its own key."""
    from test_torch_config_block import assert_same_state
    bs = batches(4, seed=6)
    runs = []
    for block in (0, 2):
        r = port_sweep(bs, 4, block)
        runs.append((r, [r.step(1)[0].copy() for _ in range(3)]))
    (a, la), (b, lb) = runs
    for x, y in zip(la, lb):
        assert x.tobytes() == y.tobytes()
    assert_same_state(a, b)
    single = TSolver(tproto.parse(SWEEP_SOLVER, "SolverParameter"),
                     device="cpu", hw_engine="cuda", dtype_policy="ternary",
                     fault_format="packed", fused_epilogue=True,
                     train_feed=cycling(bs))
    batch, keys = a._batch(a.iter), a.lane_keys(a.iter)
    lanes = [a.lane_state(i) for i in range(4)]
    _, _, kf, kl, _ = a._step(a.params, a.history, a.fault_states, batch,
                              a.iter, keys)
    for i in range(4):
        _, _, sf, sl, _ = single._step_fn(*lanes[i], batch, a.iter, keys[i])
        assert float(sl) == pytest.approx(float(kl[i]), rel=1e-5), i
        for k in sf["life_q"]:
            assert torch.equal(sf["life_q"][k], kf["life_q"][k][i]), (i, k)
    for r in (a, b):
        r.close()


# ---------------------------------------------------------------------------
# the Solver's keys: iter_size, test

def test_iter_size_sub_passes_draw_their_own_keys():
    """iter_size 2: sub-pass i draws from fold_in(step key, i), as the
    reference's scan does; two steps against the reference's, each from
    the reference's state."""
    text = SWEEP_SOLVER[:SWEEP_SOLVER.index("failure_pattern")] \
        .replace("base_lr: 0.05", "base_lr: 0.05 iter_size: 2")
    bs = batches(4, seed=7)
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, train_feed=cycling(bs))
    jstep = jax.jit(js.make_train_step(hw_engine="jax"))
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 hw_engine="torch", train_feed=cycling(bs))
    params, hist = js.params, js.history
    for it in range(2):
        stacked = {k: np.stack([bs[2 * it][k], bs[2 * it + 1][k]])
                   for k in bs[0]}
        t_in = (convert.params_from_jax(host_tree(params)),
                {k: {s: torch.from_numpy(np.array(a)) for s, a in
                     v.items()} for k, v in hist.items()})
        params, hist, _, loss, _, _ = jstep(
            params, hist, None, {k: jnp.asarray(v)
                                 for k, v in stacked.items()},
            jnp.int32(it), jax.random.fold_in(js._key, it), False)
        tp, _, _, tl, _ = ts._step_fn(
            *t_in, None, {k: torch.from_numpy(v) for k, v in
                          stacked.items()}, it,
            ts._step_fn.noise.step_key(ts._key, it))
        assert float(tl) == pytest.approx(float(loss), rel=1e-5), it
        for ln, vals in host_tree(params).items():
            for a, b in zip(vals, tp[ln]):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                           atol=1e-6, err_msg=ln)


TEST_NET = """name: "test_keys"
layer { name: "in" type: "Input" top: "x" input_param {
  shape { dim: 4 dim: 6 } } }
layer { name: "noise" type: "DummyData" top: "n"
  dummy_data_param { data_filler { type: "uniform" min: -1 max: 1 }
    shape { dim: 4 dim: 6 } } }
layer { name: "sum" type: "Eltwise" bottom: "x" bottom: "n" top: "s" }
layer { name: "drop" type: "Dropout" bottom: "s" top: "s" }
layer { name: "ip" type: "InnerProduct" bottom: "s" top: "ip"
  inner_product_param { num_output: 3
    weight_filler { type: "gaussian" std: 0.5 } } }
"""


def test_solver_test_draws_per_test_batch():
    """Test batch i's forward key is fold_in(fold_in(key, iter), i): the
    scores (the mean of each output over 3 batches) equal the
    reference's."""
    text = (f'net_param {{ {TEST_NET} }} test_iter: 3 test_interval: 1000 '
            'base_lr: 0.1 lr_policy: "fixed" display: 0 random_seed: 9')
    rs = np.random.RandomState(2)
    bs = [{"x": rs.randn(4, 6).astype(F32)} for _ in range(3)]
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, train_feed=cycling(bs), test_feeds=[cycling(bs)])
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 train_feed=cycling(bs), test_feeds=[cycling(bs)])
    for it in (0, 5):
        js.iter = ts.iter = it
        want, got = js.test(0), ts.test(0)
        assert got.keys() == want.keys() == {"ip"}
        assert got["ip"] == pytest.approx(want["ip"], rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# virtual time; evaluate

def test_virtual_time_keys_reach_the_forward_after_a_refill(tmp_path):
    """The two-wave scenario over a net with a Dropout after ip1: lanes
    refilled with new configs draw their masks from fold_in(fold_in(key,
    t_c), cfg_c), in lockstep with the reference (banks, reports, keys)."""
    text = vt.solver_text(tmp_path).replace(
        'layer { name: "ip2"',
        'layer { name: "drop" type: "Dropout" bottom: "ip1" top: "ip1" '
        'dropout_param { dropout_ratio: 0.4 } }\nlayer { name: "ip2"')
    assert "drop" in text
    pr, rr = vt.lockstep(text, "jax")
    assert pr.iter == rr.iter == 8
    pr.close()


def test_evaluate_passes_no_key():
    """The reference's evaluate forwards without a key: a random
    DummyData in the evaluated net raises in both packages."""
    text = (f'net_param {{ {TEST_NET} }} base_lr: 0.1 lr_policy: "fixed" '
            'display: 0 random_seed: 9 failure_pattern { type: "gaussian" '
            'mean: 250 std: 30 }')
    bs = [{"x": np.ones((4, 6), F32)}]
    r = TSweep(TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                       train_feed=cycling(bs)), 2, device="cpu")
    with pytest.raises(ValueError, match="DummyData 'noise'"):
        r.evaluate(bs[0])
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    ref = JSweep(JSolver(sp, train_feed=cycling(bs)), 2)
    with pytest.raises(AssertionError, match="PRNG key"):
        ref.evaluate({"x": jnp.asarray(bs[0]["x"])})
    r.close()


# ---------------------------------------------------------------------------
# the LMDB writer

def test_array_to_datum_bytes_are_the_references():
    rs = np.random.RandomState(0)
    for arr, label in ((rs.randint(0, 256, (3, 5, 4), dtype=np.uint8), 7),
                       (rs.randint(0, 256, (1, 2, 2), dtype=np.uint8), 0),
                       (rs.randn(2, 3, 4).astype(F32), 999),
                       (rs.randn(1, 1, 3), -2)):
        assert tproto.encode(array_to_datum(arr, label)) == \
            j_to_datum(arr, label).SerializeToString()


@pytest.mark.parametrize("n,shape", [(4, (3, 256, 256)), (600, (1, 4, 4)),
                                     (2500, (3, 8, 8))])
def test_bulk_writer_reads_back_both_ways(tmp_path, n, shape):
    """Records written by each package's BulkWriter (overflow pages for
    the 256x256 images, several leaf pages, a branch level) read back
    record for record through the other's reader, and the files are the
    same bytes."""
    rs = np.random.RandomState(n)
    records = [(f"{i:08d}".encode(), tproto.encode(array_to_datum(
        rs.randint(0, 256, shape, dtype=np.uint8), int(rs.randint(1000)))))
        for i in range(n)]
    with tlmdb.BulkWriter(str(tmp_path / "port")) as w:
        for k, v in reversed(records):
            w.put(k, v)
    jw = jlmdb.BulkWriter(str(tmp_path / "ref"))
    for k, v in records:
        jw.put(k, v)
    jw.close()
    for writer, reader in (("port", jlmdb.Environment),
                           ("ref", tlmdb.Environment)):
        env = reader(str(tmp_path / writer))
        assert len(env) == n
        assert list(env.items()) == records
        assert env.get(records[n // 2][0]) == records[n // 2][1]
        env.close()
    assert (tmp_path / "port" / "data.mdb").read_bytes() == \
        (tmp_path / "ref" / "data.mdb").read_bytes()
    with pytest.raises(tlmdb.LmdbError, match="duplicate"):
        w = tlmdb.BulkWriter(str(tmp_path / "dup"))
        w.put(b"a", b"1")
        w.put(b"a", b"2")
        w.close()
