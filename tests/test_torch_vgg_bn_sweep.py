"""A BatchNorm net's Monte-Carlo sweep in the port (parallel/sweep.py,
Net.apply under lanes) against the reference package's SweepRunner, on
the CPU.

The net: a BatchNorm on the (shared, unlaned) input, then conv -> BN ->
Scale -> ReLU -> MAX pool, fc -> BN -> Scale -> ReLU, fc, softmax loss;
8x8 inputs, batch 4, C = 3 lanes with their own lifetime (mean, std)
from N(250, 30) to N(450, 250), the ternary crossbar read, packed banks.
Each lane keeps its own statistics, mean and variance (C, ch) and
scale_factor (C, 1).

Held: the port's sweep against the reference's (engine "jax"), from
one state: per-lane losses within 1e-4 relative, scale_factor bit for
bit, statistics within 1e-4 relative or of their largest value, life_q
identical on every leaf but fc1's bias (it feeds a BatchNorm, so its
true gradient is zero and each package's update there is rounding or an
exact 0: a cell counts a write on that, and the bias then has no effect
downstream). A v6 checkpoint with the statistics crosses between the
packages in both directions, every leaf bit for bit, and the runs go on
together.
"""
import json

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_sweep import MEANS, STDS, batches
from test_torch_vgg_bn import bits

C = 3
STEPS = 3
BS = batches(3 * STEPS, seed=9)
REL = 1e-4

NET = """name: "sweep_bn"
layer { name: "in" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "bn_data" type: "BatchNorm" bottom: "data" top: "data_n" }
layer { name: "conv1" type: "Convolution" bottom: "data_n" top: "conv1"
  convolution_param { num_output: 4 pad: 1 kernel_size: 3
    weight_filler { type: "msra" } bias_filler { type: "constant" } } }
layer { name: "bn_conv1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "scale_conv1" type: "Scale" bottom: "conv1" top: "conv1"
  scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool1" top: "fc1"
  inner_product_param { num_output: 12
    weight_filler { type: "msra" } bias_filler { type: "constant" } } }
layer { name: "bn_fc1" type: "BatchNorm" bottom: "fc1" top: "fc1" }
layer { name: "scale_fc1" type: "Scale" bottom: "fc1" top: "fc1"
  scale_param { bias_term: true } }
layer { name: "relu_fc1" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 5
    weight_filler { type: "msra" } bias_filler { type: "constant" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" bottom: "label"
  top: "loss" }
"""
SOLVER = (f'net_param {{ {NET} }} base_lr: 0.05 momentum: 0.9 '
          'weight_decay: 0.004 lr_policy: "fixed" display: 0 max_iter: 100 '
          'random_seed: 6 failure_pattern { type: "gaussian" mean: 250 '
          'std: 30 }')
STATS = ("bn_data", "bn_conv1", "bn_fc1")


def feed_from(start):
    state = {"i": start}

    def feed():
        b = BS[state["i"] % len(BS)]
        state["i"] += 1
        return b
    return feed


def port_runner(start=0):
    s = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                train_feed=feed_from(start))
    return TSweep(s, C, means=MEANS, stds=STDS, engine="cuda",
                  packed_state=True, dtype_policy="ternary", device="cpu")


def ref_runner(start=0):
    sp = pb.SolverParameter()
    text_format.Parse(SOLVER, sp)
    return JSweep(JSolver(sp, train_feed=feed_from(start)), C, means=MEANS,
                  stds=STDS, engine="jax", packed_state=True,
                  dtype_policy="ternary")


def host_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def assert_close_states(port, ref_params, ref_banks, noisy):
    """The port runner against the reference's params and banks."""
    for ln, vals in ref_params.items():
        for i, (a, b) in enumerate(zip(vals, port.params[ln])):
            if f"{ln}/{i}" in noisy:
                continue
            if ln in STATS and i == 2:
                np.testing.assert_array_equal(bits(b.numpy()), bits(a))
                continue
            atol = REL * float(np.abs(a).max()) if ln in STATS else 1e-6
            np.testing.assert_allclose(b.numpy(), a, rtol=REL, atol=atol,
                                       err_msg=f"{ln}/{i}")
    for k, q in port.fault_states["life_q"].items():
        if k not in noisy:
            np.testing.assert_array_equal(q.numpy(), ref_banks["life_q"][k],
                                          err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's sweep and the reference's from the port's draw, STEPS
    steps each; then each checkpoints, and a fresh runner of the other
    package restores it and takes STEPS more beside the writer."""
    tmp = tmp_path_factory.mktemp("bn_sweep")
    port = port_runner()
    with jax.enable_x64(False):
        ref = ref_runner()
        p, h, f = convert.sweep_state_to_jax(port)
        ref.params = jax.tree.map(jax.numpy.asarray, p)
        ref.history = jax.tree.map(jax.numpy.asarray, h)
        ref.fault_states = jax.tree.map(jax.numpy.asarray, f)
        got, want = [], []
        for _ in range(STEPS):
            got.append(port.step(1)[0].copy())
            want.append(np.asarray(ref.step(1)[0]).copy())
        out = {"got": got, "want": want, "port": port,
               "ref_params": host_tree(ref.params),
               "ref_banks": host_tree(ref.fault_states)}
        out["port_path"] = port.checkpoint(str(tmp / "port.ckpt.npz"))
        ref_path = str(tmp / "ref.ckpt.npz")
        ref.checkpoint(ref_path)
        out["ref_path"] = ref_path
        # the reference restores the port's checkpoint; both go on
        back = ref_runner(start=STEPS)
        back.restore(out["port_path"])
        out["ref_from_port"] = {"iter": back.iter,
                                "params": host_tree(back.params),
                                "history": host_tree(back.history),
                                "banks": host_tree(back.fault_states)}
        out["ref_cont"] = [np.asarray(back.step(1)[0]).copy()
                           for _ in range(STEPS)]
        out["ref_cont_params"] = host_tree(back.params)
        out["ref_cont_banks"] = host_tree(back.fault_states)
        back.close()
        ref.close()
    out["port_cont"] = [port.step(1)[0].copy() for _ in range(STEPS)]
    return out


def test_sweep_matches_reference(runs):
    port = runs["port"]
    noisy = port.solver.net.bn_fed_biases(port.solver._fault_keys)
    assert noisy == {"fc1/1"}
    for got, want in zip(runs["got"], runs["want"]):
        np.testing.assert_allclose(got, want, rtol=REL)
    # the run's state after STEPS, before the continuation
    fresh = port_runner(start=STEPS)
    fresh.restore(runs["port_path"])
    assert_close_states(fresh, runs["ref_params"], runs["ref_banks"], noisy)
    assert [tuple(t.shape) for t in fresh.params["bn_conv1"]] == [
        (C, 4), (C, 4), (C, 1)]
    assert [tuple(t.shape) for t in fresh.params["bn_data"]] == [
        (C, 3), (C, 3), (C, 1)]
    # the unlaned input's statistics are the same in every lane
    mean = fresh.params["bn_data"][0]
    assert torch.equal(mean[0], mean[1]) and torch.equal(mean[0], mean[2])
    # each lane's own statistics past the first conv
    assert not torch.equal(fresh.params["bn_fc1"][1][0],
                           fresh.params["bn_fc1"][1][1])
    assert (port.broken_fractions() > 0.01).all()


def test_port_checkpoint_restores_into_the_reference(runs):
    port = runs["port"]
    r = runs["ref_from_port"]
    assert r["iter"] == STEPS
    with np.load(runs["port_path"]) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(bytes(bytearray(data["__meta__"])).decode())
    assert meta["version"] == 6 and meta["iter"] == STEPS
    for ln in STATS:
        for i in range(3):
            a = data[f"params/{ln}/{i}"]
            assert a.tobytes() == np.asarray(r["params"][ln][i]).tobytes()
    for ln, vals in r["params"].items():
        for i, a in enumerate(vals):
            assert a.tobytes() == data[f"params/{ln}/{i}"].tobytes(), ln
    for k, q in r["banks"]["life_q"].items():
        assert q.tobytes() == data[f"fault/life_q/{k}"].tobytes(), k
    for got, want in zip(runs["port_cont"], runs["ref_cont"]):
        np.testing.assert_allclose(got, want, rtol=REL)
    noisy = port.solver.net.bn_fed_biases(port.solver._fault_keys)
    assert_close_states(port, runs["ref_cont_params"],
                        runs["ref_cont_banks"], noisy)


def test_reference_checkpoint_restores_into_the_port(runs):
    """Every leaf of the reference's file lands bit for bit, the
    statistics per lane included, and the port goes on from it as the
    reference's own state would."""
    r = port_runner(start=STEPS)
    r.restore(runs["ref_path"])
    assert r.iter == STEPS
    with np.load(runs["ref_path"]) as z:
        data = {k: z[k] for k in z.files}
    leaves = {k: v.detach().numpy() for k, v in r._state_arrays().items()}
    assert set(leaves) == set(data) - {"__meta__"}
    for k, v in leaves.items():
        assert v.dtype == data[k].dtype and v.tobytes() == data[k].tobytes(), k
    assert data["params/bn_fc1/2"].shape == (C, 1)
    losses = r.step(1)[0]
    assert np.isfinite(losses).all()


def test_lanes_equal_single_config_solvers():
    """Lanes 0 and 2 against single-config Solvers started from their
    state each step, on the same batch: losses within 1e-5 relative,
    statistics within 1e-5 of their largest value, scale_factor and the
    banks (fc1's bias aside, as above) bit for bit."""
    sweep = port_runner()
    noisy = sweep.solver.net.bn_fed_biases(sweep.solver._fault_keys)
    solvers = {i: TSolver(tproto.parse(SOLVER, "SolverParameter"),
                          device="cpu", train_feed=feed_from(0),
                          dtype_policy="ternary", fault_format="packed",
                          hw_engine="cuda") for i in (0, 2)}
    for _ in range(STEPS):
        states = {i: sweep.lane_state(i) for i in solvers}
        losses = sweep.step(1)[0]
        for i, s in solvers.items():
            s.params, s.history, s.fault_state = states[i]
            s.step(1)
            assert float(s.last_loss) == pytest.approx(float(losses[i]),
                                                       rel=1e-5)
            for ln in STATS:
                for j, (a, b) in enumerate(zip(s.params[ln],
                                               sweep.params[ln])):
                    if j == 2:
                        assert torch.equal(a, b[i])
                    else:
                        torch.testing.assert_close(
                            a, b[i], rtol=0,
                            atol=1e-5 * float(b[i].abs().max()))
            for k, q in s.fault_state["life_q"].items():
                if k not in noisy:
                    assert torch.equal(q, sweep.fault_states["life_q"][k][i])
