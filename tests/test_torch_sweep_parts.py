"""The sweep's parts in the port (parallel/sweep.py SweepRunner) against
the reference package's: the device-resident dataset's order across a
wrap, the per-config fault draws and the config-sized pack spec, the
batched crossbar read over C lanes against the reference's vmap. The
sweep parity test, the per-lane quarantine, the lane-against-Solver
checks and the refusals are in tests/test_torch_sweep.py, whose helpers
these tests share."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_crossbar import assert_within_sum_bound, operands, t
from test_torch_solver import NET as CIFAR_NARROW


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
    np.testing.assert_array_equal(runner.step(2, chunk=2)[0],
                                  r2.step(2, chunk=2)[0])
    assert runner.chunk_losses.shape == (2, 2)


# ---------------------------------------------------------------------------
# parts: draws, pack spec, the batched crossbar read

def test_stack_fault_states_reanchors_each_lane():
    pattern = tproto.parse("mean: 1000 std: 100", "FailurePattern")
    means, stds = [1000.0, 5000.0, 300.0], [100.0, 800.0, 50.0]
    shapes = {"ip1/0": (64, 128), "ip1/1": (64,)}
    st = tengine.stack_fault_states(prng.PRNGKey(0), shapes, pattern, 3,
                                    means, stds)
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
    d = tengine.stack_fault_states(prng.PRNGKey(1), shapes, pattern,
                                   2)["lifetimes"]["ip1/0"]
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
