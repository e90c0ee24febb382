"""The port's Monte-Carlo sweep (parallel/sweep.py SweepRunner) against
the reference package's, and its parts: the per-config fault draws, the
config-sized pack spec, the batched crossbar read over C lanes, the
device-resident dataset order and the per-lane quarantine.

The sweep parity test runs a small conv net (conv -> MAX 3/2 pool ->
ReLU -> conv -> AVE pool -> IP -> IP -> SoftmaxWithLoss, 8x8 inputs,
batch 4) at C = 3 lanes with their own lifetime (mean, std) from
N(250, 30) to N(450, 250), so cells break all through the run, under
the ternary crossbar read,
packed banks and the fused epilogue. The reference runs with engine
"pallas" (interpret mode here) and "jax"; both start from the port's
draw, carried across with convert.py. Held after every chunk: life_q
banks identical, per-lane losses within 1e-4 relative (the two
packages sum convolutions and products in other orders; the tolerance
of tests/test_torch_solver.py), broken fractions equal."""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.parallel import sweep as tsweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_crossbar import assert_within_sum_bound, operands, t
from test_torch_solver import NET as CIFAR_NARROW

MEANS = [250.0, 450.0, 300.0]
STDS = [30.0, 250.0, 120.0]
BATCH = 4

NET = """name: "sweep_small"
layer { name: "in" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "pool1" top: "pool1" }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 6 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  inner_product_param { num_output: 12
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""
SOLVER = (f'net_param {{ {NET} }} base_lr: 0.05 momentum: 0.9 '
          'weight_decay: 0.004 lr_policy: "fixed" display: 0 max_iter: 100 '
          'random_seed: 4 failure_pattern { type: "gaussian" mean: 250 '
          'std: 30 }')


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(BATCH, 3, 8, 8).astype(np.float32),
             "label": rng.randint(0, 5, BATCH).astype(np.float32)}
            for _ in range(n)]


def cycling(bs):
    state = {"i": 0}

    def feed():
        b = bs[state["i"] % len(bs)]
        state["i"] += 1
        return b
    return feed


def port_solver(feed, text=SOLVER):
    return TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                   train_feed=feed)


def port_sweep(feed, C=3, means=MEANS, stds=STDS, **kw):
    opts = dict(engine="cuda", packed_state=True, dtype_policy="ternary",
                device="cpu")
    opts.update(kw)
    return TSweep(port_solver(feed), C, means=means and means[:C],
                  stds=stds and stds[:C], **opts)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the sweep against the reference SweepRunner

@pytest.mark.parametrize("ref_engine", ["pallas", "jax"])
def test_sweep_matches_reference(ref_engine):
    bs = batches(8)
    port = port_sweep(cycling(bs))
    assert port.engine_resolved == "cuda" and port.fused_epilogue_resolved

    sp = pb.SolverParameter()
    text_format.Parse(SOLVER, sp)
    js = JSolver(sp, train_feed=cycling(bs))
    ref = JSweep(js, 3, means=MEANS, stds=STDS, engine=ref_engine,
                 packed_state=True, dtype_policy="ternary")
    assert ref._pack_spec == port._pack_spec
    assert ref.engine_resolved == ref_engine
    # one draw for both: the port's state goes to the reference
    p, h, f = convert.sweep_state_to_jax(port)
    for group in ("params", "history", "fault_states"):
        assert jax.tree.structure(numpy_tree(getattr(ref, group))) == \
            jax.tree.structure({"params": p, "history": h,
                                "fault_states": f}[group])
    ref.params = jax.tree.map(jnp.asarray, p)
    ref.history = jax.tree.map(jnp.asarray, h)
    ref.fault_states = jax.tree.map(jnp.asarray, f)
    # the carried-back state is the same, dtype for dtype
    convert.sweep_state_from_jax(port, *map(numpy_tree, (ref.params,
                                                         ref.history,
                                                         ref.fault_states)))

    for _ in range(4):                                # 8 steps, chunk 2
        got = port.step(2, chunk=2)
        want = np.asarray(ref.step(2, chunk=2)[0])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        ref_banks = numpy_tree(ref.fault_states)["life_q"]
        for k, lq in port.fault_states["life_q"].items():
            np.testing.assert_array_equal(lq.numpy(), ref_banks[k])
        np.testing.assert_array_equal(port.broken_fractions(),
                                      np.asarray(ref.broken_fractions()))
    frac = port.broken_fractions()
    assert (frac > 0.05).all() and (frac < 1.0).any()   # cells broke
    assert port.iter == ref.iter == 8
    assert port.quarantined().size == 0


def test_convert_refuses_a_state_of_another_layout():
    port = port_sweep(cycling(batches(1)))
    p, h, f = convert.sweep_state_to_jax(port)
    p["ip1"][0] = p["ip1"][0][:2]                     # two lanes, not three
    with pytest.raises(ValueError, match="params"):
        convert.sweep_state_from_jax(port, p, h, f)


# ---------------------------------------------------------------------------
# lanes against single-config solvers; quarantine

def test_lane_equals_single_config_solver():
    """Lane i of the sweep against the port's Solver started from lane
    i's state, on the same batches: banks identical, losses within 1e-5
    relative (a grouped convolution sums in another order than one
    lane's), every step."""
    bs = batches(4, seed=1)
    sweep = port_sweep(cycling(bs), C=3)
    solvers = []
    for i in range(3):
        s = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                    train_feed=cycling(bs), dtype_policy="ternary",
                    fault_format="packed", hw_engine="cuda")
        s.params, s.history, s.fault_state = sweep.lane_state(i)
        solvers.append(s)
    for _ in range(4):
        losses = sweep.step(1)
        for i, s in enumerate(solvers):
            s.step(1)
            assert float(s.last_loss) == pytest.approx(float(losses[i]),
                                                       rel=1e-5)
            for k, lq in s.fault_state["life_q"].items():
                assert torch.equal(lq, sweep.fault_states["life_q"][k][i])


def test_quarantine_freezes_a_nan_lane():
    bs = batches(4, seed=2)
    clean = port_sweep(cycling(bs))
    poisoned = port_sweep(cycling(bs))
    poisoned.params["conv2"][0][1, 0, 0, 0, 0] = float("nan")
    before = poisoned.lane_state(1)
    for _ in range(2):
        clean.step(2, chunk=2)
        got = poisoned.step(2, chunk=2)
    assert list(poisoned.quarantined()) == [1]
    assert not np.isfinite(got[1])
    # the frozen lane kept its pre-step state
    after = poisoned.lane_state(1)
    for k, lq in before[2]["life_q"].items():
        assert torch.equal(after[2]["life_q"][k], lq)
    for ln, vals in before[0].items():
        for a, b in zip(vals, after[0][ln]):
            if a is not None:
                assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    # the other lanes train as if it were not there
    for i in (0, 2):
        assert got[i] == clean.last_losses[i]
        for k, lq in clean.fault_states["life_q"].items():
            assert torch.equal(poisoned.fault_states["life_q"][k][i], lq[i])
    assert clean.quarantined().size == 0


# ---------------------------------------------------------------------------
# the device-resident dataset

def test_device_dataset_follows_the_host_cursor_across_a_wrap(monkeypatch):
    """The in-repo CIFAR LMDB holds 200 records; at batch 64 the fourth
    batch wraps. Batch t gathered on the device equals the t-th batch
    of a fresh host cursor."""
    import os
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    net = CIFAR_NARROW.replace("batch_size: 8", "batch_size: 64")
    text = (f'net_param {{ {net} }} base_lr: 0.01 lr_policy: "fixed" '
            'random_seed: 3 failure_pattern { type: "gaussian" mean: 1e6 '
            'std: 1e5 }')
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    runner = TSweep(s, 2, device="cpu")
    assert runner._dataset is not None and runner._ds_n == 200
    host = s.train_feed
    for it in range(7):
        want = host()
        got = runner._batch(it)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    # preload=False reads the host feed: the same losses
    s2 = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    r2 = TSweep(s2, 2, device="cpu", preload=False)
    assert r2._dataset is None
    r2.fault_states = {g: {k: v.clone() for k, v in grp.items()}
                       for g, grp in runner.fault_states.items()}
    np.testing.assert_array_equal(runner.step(2, chunk=2),
                                  r2.step(2, chunk=2))
    assert runner.chunk_losses.shape == (2, 2)


# ---------------------------------------------------------------------------
# parts: draws, pack spec, the batched crossbar read

def test_stack_fault_states_reanchors_each_lane():
    pattern = tproto.parse("mean: 1000 std: 100", "FailurePattern")
    means, stds = [1000.0, 5000.0, 300.0], [100.0, 800.0, 50.0]
    shapes = {"ip1/0": (64, 128), "ip1/1": (64,)}
    st = tengine.stack_fault_states(torch.Generator().manual_seed(0),
                                    shapes, pattern, 3, means, stds)
    life = st["lifetimes"]["ip1/0"]
    assert life.shape == (3, 64, 128) and st["stuck"]["ip1/1"].shape == (3,
                                                                         64)
    for c in range(3):
        z = (life[c].double() - means[c]) / stds[c]
        assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03
    # lanes are independent draws, not one draw rescaled
    z0 = (life[0] - means[0]) / stds[0]
    z1 = (life[1] - means[1]) / stds[1]
    assert abs(float(torch.corrcoef(torch.stack([z0.flatten(),
                                                 z1.flatten()]))[0, 1])) < 0.05
    stuck = st["stuck"]["ip1/0"]
    assert set(torch.unique(stuck).tolist()) <= {-1.0, 0.0, 1.0}
    # default: the pattern's own (mean, std) on every lane
    d = tengine.stack_fault_states(torch.Generator().manual_seed(1), shapes,
                                   pattern, 2)["lifetimes"]["ip1/0"]
    assert abs(float(d.mean()) - 1000) < 5


def test_pack_spec_sized_from_every_config():
    state = {"lifetimes": {"w": torch.zeros((2, 3, 5))}}
    small = tpacked.make_pack_spec(state, 100.0, means=[300, 250],
                                   stds=[50, 30])
    big = tpacked.make_pack_spec(state, 100.0, means=[300, 1e8],
                                 stds=[50, 3e7])
    assert small["life_dtype"] == "int16" and big["life_dtype"] == "int32"
    assert small["last_dim"] == {"w": 5}
    # pack/unpack over (C, ...) leaves
    rng = np.random.RandomState(0)
    life = torch.from_numpy((rng.randn(3, 4, 7) * 300 + 200)
                            .astype(np.float32))
    stuck = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], (3, 4, 7))
                             .astype(np.float32))
    spec = tpacked.make_pack_spec({"lifetimes": {"w": life}}, 100.0,
                                  means=[200], stds=[300])
    packed = tpacked.pack_state({"lifetimes": {"w": life},
                                 "stuck": {"w": stuck}}, spec)
    assert packed["stuck_bits"]["w"].shape == (3, 4, 2)
    assert torch.equal(tpacked.unpack_stuck(packed["stuck_bits"]["w"], 7),
                       stuck)
    assert torch.equal(packed["life_q"]["w"] <= 0, life <= 0)


@pytest.mark.parametrize("q_bits", [0, 2, 8])
@pytest.mark.parametrize("x_per_lane", [False, True])
def test_batched_crossbar_matches_reference_vmap(q_bits, x_per_lane):
    """crossbar_matmul_lanes (one B2 launch for C lanes) against the
    reference crossbar_matmul under jax.vmap over the lanes, forward and
    backward, sigma 0, on odd per-lane operands (C = 3, 48x72x40)."""
    C, M, K, N = 3, 48, 72, 40
    rng = np.random.RandomState(50 + q_bits)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if x_per_lane else x
    g = rng.randn(C, M, N).astype(np.float32)

    def ref(a, ww):
        fn = lambda xa, wa, b, s, sd: jhw.crossbar_matmul(xa, wa, b, s, sd,
                                                          0.0, q_bits)
        return jax.vmap(fn, in_axes=(0 if x_per_lane else None, 0, 0, 0, 0))(
            a, ww, jnp.asarray(broken), jnp.asarray(stuck),
            jnp.asarray(seeds))
    y_ref, vjp = jax.vjp(ref, jnp.asarray(xin), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))

    xt, wt = t(xin).requires_grad_(), t(w).requires_grad_()
    y = thw.crossbar_matmul_lanes(xt, wt, t(broken), t(stuck), t(seeds), 0.0,
                                  q_bits)
    dx, dw = torch.autograd.grad(y, (xt, wt), t(g))
    levels = thw.q_levels(q_bits)
    w_eff = thw.effective_weight_plain(
        t(w), t(broken.astype(np.float32)), t(stuck), 0.0, None, levels,
        t(w).abs().amax(dim=(1, 2))).numpy()
    assert_within_sum_bound(y.detach().numpy(), y_ref, xin, w_eff)
    # dx against the lane's masked grid weights; dw straight-through,
    # zero on broken cells
    w_masked = w_eff          # sigma 0: the masked grid weights
    dx_each = np.matmul(g, np.swapaxes(w_masked, 1, 2))
    if x_per_lane:
        assert_within_sum_bound(dx.numpy(), dx_ref, g,
                                np.swapaxes(w_masked, 1, 2))
    else:
        bound = (K * 2.0 ** -24 * np.abs(np.matmul(np.abs(g), np.abs(
            np.swapaxes(w_masked, 1, 2)))).sum(0)
            + C * 2.0 ** -24 * np.abs(dx_each).sum(0) + 1e-30)
        assert (np.abs(dx.numpy() - np.asarray(dx_ref)) <= bound).all()
    xT = np.swapaxes(xin, -1, -2)
    assert_within_sum_bound(dw.numpy(), dw_ref, xT, g)
    assert (dw.numpy()[broken] == 0).all()


# ---------------------------------------------------------------------------
# refusals and the device default

@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("config_block", 2), ("remat_segments", 2),
    ("compute_dtype", "bfloat16"), ("pipeline_depth", 1),
    ("stall_timeout_s", 5.0), ("health_every", 4),
    ("conv_im2col", "implicit")])
def test_unported_options_raise_by_name(option, value):
    s = port_solver(cycling(batches(1)))
    with pytest.raises(NotImplementedError, match=option):
        TSweep(s, 2, device="cpu", **{option: value})


@pytest.mark.parametrize("method", ["enable_self_healing", "submit_configs",
                                    "checkpoint", "restore",
                                    "save_fault_states"])
def test_unported_methods_raise(method):
    r = port_sweep(cycling(batches(1)), C=2)
    with pytest.raises(NotImplementedError):
        getattr(r, method)("x")


def test_sweep_argument_errors():
    s = port_solver(cycling(batches(1)))
    with pytest.raises(TypeError, match="unexpected option"):
        TSweep(s, 2, device="cpu", frobnicate=True)
    with pytest.raises(ValueError, match="engine"):
        TSweep(s, 2, device="cpu", engine="pallas")
    with pytest.raises(ValueError, match="n_configs"):
        TSweep(s, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TSweep(s, 2)
    assert tsweep.SWEEP_ENGINES == ("auto", "cuda", "torch")


def test_bytes_per_step_counts_state_and_batch():
    r = port_sweep(cycling(batches(1)), C=2)
    state = sum(t.numel() * t.element_size() for t in r._state_tensors())
    assert r.bytes_per_step_est() == 2 * state       # no device dataset
    r4 = port_sweep(cycling(batches(1)), C=4, means=None, stds=None)
    assert r4.bytes_per_step_est() > r.bytes_per_step_est()
