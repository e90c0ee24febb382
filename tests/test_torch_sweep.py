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
of tests/test_torch_solver.py), broken fractions equal.

The sweep's parts (the device dataset's order, the draws and pack
spec, the batched read) are held in tests/test_torch_sweep_parts.py."""
import os

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
from rram_caffe_simulation_tpu_torch.parallel import sweep as tsweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver


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


def lmdb_solver_text(root, records=20, extra=""):
    """SOLVER with the Input layer replaced by a Data layer over a small
    LMDB written under `root` (`records` 3x8x8 images, labels 0-4): a
    net whose dataset can live on the device. `extra` is appended to
    the solver text."""
    from rram_caffe_simulation_tpu.data import lmdb_py
    from rram_caffe_simulation_tpu.data.db import array_to_datum
    db = os.path.join(str(root), "db")
    if not os.path.exists(db):
        rng = np.random.RandomState(0)
        with lmdb_py.BulkWriter(db) as w:
            for i in range(records):
                img = rng.randint(0, 255, (3, 8, 8), dtype=np.uint8)
                w.put(b"%08d" % i, array_to_datum(
                    img, int(img.mean() // 52)).SerializeToString())
    data = (f'layer {{ name: "data" type: "Data" top: "data" top: "label" '
            f'data_param {{ source: "{db}" batch_size: {BATCH} }} '
            'transform_param { scale: 0.00390625 } }')
    net = NET.replace(NET[NET.index("layer { name: \"in\""):
                          NET.index("layer { name: \"conv1\"")], data + "\n")
    return SOLVER.replace(NET, net) + " " + extra


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
        got = port.step(2, chunk=2)[0]
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
        losses = sweep.step(1)[0]
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
        got = poisoned.step(2, chunk=2)[0]
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
# refusals and the device default

@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("remat_segments", 2),
    ("compute_dtype", "bfloat16")])
def test_unported_options_raise_by_name(option, value):
    s = port_solver(cycling(batches(1)))
    with pytest.raises(NotImplementedError, match=option):
        TSweep(s, 2, device="cpu", **{option: value})


@pytest.mark.parametrize("method,kwargs,match", [
    pytest.param("enable_self_healing", {"budget": 4, "virtual_time": True},
                 "device-resident dataset", id="enable_self_healing"),
    pytest.param("submit_configs", {
        "budget": 4, "virtual_time": True,
        "extra_configs": [{"mean": 300.0, "std": 20.0}]},
        "device-resident dataset", id="submit_configs"),
    pytest.param("checkpoint", {"distributed": True}, "distributed",
                 id="checkpoint-distributed"),
])
def test_unported_methods_raise(method, kwargs, match, tmp_path):
    """What stays refused: writing the distributed checkpoint layout (by
    name), and self-healing's per-lane clocks (`virtual_time`) on a host
    feed, with the reference's ValueError (nothing is armed and its
    queued configs are never submitted). Over a device-resident dataset
    the same call arms the clocks and the sweep runs to completion."""
    r = port_sweep(cycling(batches(1)), C=2, pipeline_depth=0)
    exc = NotImplementedError if method == "checkpoint" else ValueError
    with pytest.raises(exc, match=match):
        if method == "checkpoint":
            r.checkpoint(str(tmp_path / "x"), **kwargs)
        else:
            r.enable_self_healing(**kwargs)
    assert not os.listdir(tmp_path)
    assert r._healing is None and not r._virtual_time
    if method == "submit_configs":
        with pytest.raises(ValueError, match="enable_self_healing"):
            r.submit_configs(kwargs["extra_configs"])
    r.close()
    if method == "checkpoint":
        return
    s = port_solver(None, text=lmdb_solver_text(tmp_path / "lmdb"))
    r = TSweep(s, 2, packed_state=True, dtype_policy="ternary",
               device="cpu", pipeline_depth=0)
    assert r.enable_self_healing(**kwargs) is r and r._virtual_time
    while not r.healing_complete():
        r.step(2, chunk=2)
    rep = r.config_report()
    assert sorted(rep["completed"]) == (
        [0, 1, 2] if method == "submit_configs" else [0, 1])
    assert all(e["iter"] >= 4 for e in rep["completed"].values())
    r.close()


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
