"""The port's training step against the reference's on a narrowed
CIFAR-10-quick (the slice's net with a few channels, batch 8, read from
the in-repo LMDB): one init drawn by the reference and carried over with
convert.py, packed fault banks at a low lifetime mean so cells break
within the run, the ternary crossbar read and the fused epilogue
(reference: make_train_step(hw_engine="pallas", dtype_policy="ternary",
fault_format="packed", fused_epilogue=True), Pallas in interpret mode).

Held: the life_q banks equal at every step (fault transitions are exact
in both), and the losses within 1e-4 relative (the two packages sum
convolutions and products in other orders; the gap stays at f32
rounding level over the run)."""
import os

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
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4


def conv(name, bottom, n, std):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{name}" param {{ lr_mult: 1 }} param {{ lr_mult: 2 }} '
            f'convolution_param {{ num_output: {n} pad: 2 kernel_size: 5 '
            f'stride: 1 weight_filler {{ type: "gaussian" std: {std} }} '
            'bias_filler { type: "constant" } } }\n')


def pool(name, bottom, kind):
    return (f'layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" '
            f'top: "{name}" pooling_param {{ pool: {kind} kernel_size: 3 '
            'stride: 2 } }\n')


def relu(name, blob):
    return (f'layer {{ name: "{name}" type: "ReLU" bottom: "{blob}" '
            f'top: "{blob}" }}\n')


def ip(name, bottom, n):
    return (f'layer {{ name: "{name}" type: "InnerProduct" bottom: '
            f'"{bottom}" top: "{name}" param {{ lr_mult: 1 }} param {{ '
            f'lr_mult: 2 }} inner_product_param {{ num_output: {n} '
            'weight_filler { type: "gaussian" std: 0.1 } bias_filler { '
            'type: "constant" } } }\n')


NET = (
    'name: "CIFAR10_quick_narrow" layer { name: "cifar" type: "Data" '
    'top: "data" top: "label" include { phase: TRAIN } transform_param { '
    'mean_file: "examples/cifar10/mean.binaryproto" } data_param { '
    'source: "examples/cifar10/cifar10_train_lmdb" batch_size: 8 '
    'backend: LMDB } }\n'
    + conv("conv1", "data", 4, 0.01) + pool("pool1", "conv1", "MAX")
    + relu("relu1", "pool1") + conv("conv2", "pool1", 4, 0.05)
    + relu("relu2", "conv2") + pool("pool2", "conv2", "AVE")
    + conv("conv3", "pool2", 8, 0.05) + relu("relu3", "conv3")
    + pool("pool3", "conv3", "AVE") + ip("ip1", "pool3", 16)
    + ip("ip2", "ip1", 10)
    + 'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" '
      'bottom: "label" top: "loss" }\n')

SOLVER = (f'net_param {{ {NET} }} base_lr: 0.01 momentum: 0.9 '
          'weight_decay: 0.004 lr_policy: "fixed" display: 0 max_iter: 100 '
          'random_seed: 3 failure_pattern { type: "gaussian" mean: 250 '
          'std: 120 }')


def test_slice_step_matches_reference(monkeypatch):
    monkeypatch.chdir(REPO)
    sp = pb.SolverParameter()
    text_format.Parse(SOLVER, sp)
    feed_net = JNet(sp.net_param, pb.TRAIN)
    js = JSolver(sp, train_feed=jfeed._python_data_feed(feed_net.layers[0]))
    spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                  pattern=sp.failure_pattern)
    assert spec["life_dtype"] == "int16"
    jstate = jpacked.pack_state(
        {g: {k: np.asarray(v) for k, v in leaves.items()}
         for g, leaves in js.fault_state.items()}, spec)
    jstep = jax.jit(js.make_train_step(
        hw_engine="pallas", dtype_policy="ternary", fault_format="packed",
        pack_spec=spec, fused_epilogue=True))

    ts = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                 hw_engine="cuda", dtype_policy="ternary",
                 fault_format="packed", fused_epilogue=True)
    assert ts.pack_spec == spec
    assert ts._step_fn.fused_epilogue_resolved
    ts.params = convert.params_from_jax(
        {k: [np.asarray(a) for a in v] for k, v in js.params.items()})
    ts.fault_state = convert.fault_state_from_jax(jstate)

    params, hist = js.params, js.history
    state = jax.tree.map(jnp.asarray, jstate)
    broke = 0.0
    for it in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in js.train_feed().items()}
        params, hist, state, loss, _, _ = jstep(
            params, hist, state, batch, jnp.int32(it),
            jax.random.fold_in(js._key, it), False)
        ts.step(1)
        assert float(ts.last_loss) == pytest.approx(float(loss), rel=1e-4)
        for k in state["life_q"]:
            np.testing.assert_array_equal(
                ts.fault_state["life_q"][k].numpy(),
                np.asarray(state["life_q"][k]))
        broke = ts.broken_fraction()
    assert 0.05 < broke < 1.0          # cells broke within the run
    for ln, vals in js.params.items():
        for a, b in zip(params[ln], ts.params[ln]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                       atol=1e-5)


def test_engines_agree_on_cpu():
    """"torch" (plain versions by name) and "cuda" (the wrappers, which
    take the plain versions on CPU tensors) run the same step."""
    runs = []
    for engine in ("torch", "cuda"):
        s = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                    hw_engine=engine, dtype_policy="ternary",
                    fault_format="packed")
        s.step(2)
        runs.append((float(s.last_loss), s.fault_state["life_q"]))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k])


@pytest.mark.parametrize("kw,match", [
    ({"hw_engine": "tpu"}, "hw_engine"),
    ({"dtype_policy": "fp4"}, "dtype_policy"),
    ({"fault_format": "origami"}, "fault_format"),
    ({"fused_epilogue": True}, "cannot engage"),
])
def test_step_configuration_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu", **kw)


LR_POLICIES = [
    'lr_policy: "fixed"',
    'lr_policy: "step" gamma: 0.5 stepsize: 3',
    'lr_policy: "multistep" gamma: 0.3 stepvalue: 2 stepvalue: 5',
    'lr_policy: "exp" gamma: 0.97',
    'lr_policy: "inv" gamma: 0.01 power: 0.75',
    'lr_policy: "poly" power: 2 max_iter: 20',
    'lr_policy: "sigmoid" gamma: -0.5 stepsize: 4',
]


@pytest.mark.parametrize("policy", LR_POLICIES)
def test_lr_policies_match_reference(policy):
    from rram_caffe_simulation_tpu.solver.lr_policies import \
        host_learning_rate_fn
    from rram_caffe_simulation_tpu_torch.solver.lr_policies import \
        learning_rate_fn
    text = f"base_lr: 0.01 {policy}"
    ref = pb.SolverParameter()
    text_format.Parse(text, ref)
    jfn = host_learning_rate_fn(ref)
    tfn = learning_rate_fn(tproto.parse(text, "SolverParameter"))
    for it in range(12):
        assert tfn(it) == jfn(it)


def test_sgd_rule_matches_reference():
    from rram_caffe_simulation_tpu.solver import updates as jU
    from rram_caffe_simulation_tpu_torch.solver import updates as tU
    rng = np.random.RandomState(0)
    diff, h = (rng.randn(7, 5).astype(np.float32) for _ in range(2))
    text = "momentum: 0.9"
    ref = pb.SolverParameter()
    text_format.Parse(text, ref)
    rate = float(np.float32(0.01) * np.float32(2.0))
    ju, jh = jU.sgd(jnp.asarray(diff), {"h": jnp.asarray(h)},
                    jnp.float32(0.01) * 2.0, jU.Hyper(ref), 1)
    tu, th = tU.sgd(torch.from_numpy(diff), {"h": torch.from_numpy(h)}, rate,
                    tU.Hyper(tproto.parse(text, "SolverParameter")), 1)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(th["h"].numpy(), np.asarray(jh["h"]))
