"""The in-repo CIFAR-10 "full" nets and the siamese net in the port
against the reference package, on the CPU.

- The fillers positive_unitball and bilinear: the same bytes as the
  reference's from one key (bilinear bit for bit; positive_unitball's
  uniform draw bit for bit, its values within 2 ulps after the division
  by the row sum: XLA's CPU row reduction adds in another order).
- examples/cifar10/cifar10_full_train_test.prototxt and its two sigmoid
  nets build in TRAIN and TEST with the reference's blob shapes; each
  trains from its own solver file (cifar10_full_solver.prototxt, the
  sigmoid solver, the BN-sigmoid solver) in lockstep with the
  reference's jitted step (Pallas in interpret mode), each step from the
  reference's state: faults on ip1 with lifetimes N(250, 120) so cells
  break, packed int16 banks, the ternary crossbar read, the fused
  epilogue; losses within 1e-4 relative, fault transitions and packed
  bytes exact (a cell whose write rests on an exact-0 update in one
  package only is checked to be one and counted), params and history
  within rtol 1e-4 / atol 1e-6 (the BatchNorm statistics within 1e-4 of
  their largest value, scale_factor bit for bit). The nets keep their
  widths; the batch is cut from 100 to 8 and the run to 3 steps, so the
  file stays under a minute.
- Lanes: a sweep over each new lane rule (LRN both regions, Slice and
  Concat on axis 1, Eltwise's three operations, Softmax, Flatten,
  Reshape, Split, Sigmoid, TanH, EuclideanLoss, ContrastiveLoss) at
  C = 4: blocks of 2 equal the unblocked runner bit for bit, and each
  lane equals a single-config Solver started from its state (loss
  within 1e-5 relative, banks identical).
- The siamese TRAIN net (its Data layers fed as Input tops: its LMDB is
  not in the repository): three shared InnerProduct weights read six
  times through the crossbar read, forward and backward against the
  reference.
- The solver files ask for HDF5 snapshots: without h5py they are
  refused by name before any step.
"""
import re
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.core import fillers as jfillers
from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import fillers as tfillers
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver

from test_torch_config_block import assert_same_state, runner
from test_torch_solver import REPO
from test_torch_sweep import cycling

F32 = np.float32
REL, ATOL = 1e-4, 1e-6
NETS = {
    "full": ("examples/cifar10/cifar10_full_solver.prototxt",
             "examples/cifar10/cifar10_full_train_test.prototxt"),
    "sigmoid": ("examples/cifar10/cifar10_full_sigmoid_solver.prototxt",
                "examples/cifar10/cifar10_full_sigmoid_train_test.prototxt"),
    "sigmoid_bn": (
        "examples/cifar10/cifar10_full_sigmoid_solver_bn.prototxt",
        "examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt"),
}
SIAMESE = "examples/siamese/mnist_siamese_train_test.prototxt"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    processes (tests/test_torch_experiment_drivers.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_x64():
    with jax.enable_x64(False):
        yield


def bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def host(a):
    return np.array(a, copy=True)


# ---------------------------------------------------------------------------
# fillers

@pytest.mark.parametrize("filler,shape", [
    ('type: "positive_unitball"', (10, 1024)),
    ('type: "positive_unitball"', (8, 3, 5, 5)),
    ('type: "bilinear"', (4, 2, 4, 4)),
    ('type: "bilinear"', (3, 1, 5, 5)),
])
def test_fillers_match_the_reference(filler, shape):
    f = pb.FillerParameter()
    text_format.Parse(filler, f)
    want = np.asarray(jfillers.make_filler(f)(
        jax.random.PRNGKey(5), shape))
    got = tfillers.make_filler(tproto.parse(filler, "FillerParameter"))(
        prng.PRNGKey(5), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    if "bilinear" in filler:
        np.testing.assert_array_equal(bits(got), bits(want))
        return
    draw = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), shape))
    np.testing.assert_array_equal(
        bits(prng.uniform(prng.PRNGKey(5), shape).numpy()), bits(draw))
    assert np.abs(bits(got) - bits(want)).max() <= 2
    np.testing.assert_allclose(got.reshape(shape[0], -1).sum(1), 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the nets build

def siamese_text(batch=64):
    """The siamese TRAIN/TEST net with its Data layers as one Input layer
    of their tops' shapes (pair_data 2x28x28, sim)."""
    text = open(f"{REPO}/{SIAMESE}").read()
    blocks = re.split(r"(?m)^(?=layer \{)", text)
    keep = [b for b in blocks if 'type: "Data"' not in b]
    assert len(keep) == len(blocks) - 2
    feed = ('layer { name: "pair_data" type: "Input" top: "pair_data" '
            f'top: "sim" input_param {{ shape {{ dim: {batch} dim: 2 '
            f'dim: 28 dim: 28 }} shape {{ dim: {batch} }} }} }}\n')
    return keep[0] + feed + "".join(keep[1:])


@pytest.mark.parametrize("name", list(NETS) + ["siamese"])
@pytest.mark.parametrize("phase", [0, 1])
def test_nets_build_with_the_reference_shapes(monkeypatch, name, phase):
    monkeypatch.chdir(REPO)
    text = siamese_text() if name == "siamese" else open(
        f"{REPO}/{NETS[name][1]}").read()
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, phase)
    tnet = TNet(tproto.parse(text, "NetParameter"), phase, device="cpu")
    assert [ly.name for ly in tnet.layers] == [ly.name for ly in jnet.layers]
    want = {k: tuple(v) for k, v in jnet.blob_shapes.items()}
    assert tnet.blob_shapes == want
    assert [r.key for r in tnet.failure_param_refs] == [
        r.key for r in jnet.failure_param_refs]


# ---------------------------------------------------------------------------
# the Solver, in lockstep with the reference's step

def solver_text(name, batch=8, mean=250.0, std=120.0):
    """The net's solver file with its net inlined at `batch`, faults on
    ip1 at N(mean, std), a seed, no display, no test."""
    solver, net = NETS[name]
    body = open(f"{REPO}/{solver}").read()
    net_text = open(f"{REPO}/{net}").read().replace(
        "batch_size: 100", f"batch_size: {batch}")
    body = re.sub(r'(?m)^net: .*$', f"net_param {{ {net_text} }}", body)
    body = re.sub(r"(?m)^(display|test_iter|test_interval): .*$", "", body)
    return (body + " display: 0 test_interval: 0 random_seed: 3 "
            f'failure_pattern {{ type: "gaussian" mean: {mean} std: {std} }}')


def lockstep(monkeypatch, text, steps):
    """`steps` steps of the port's Solver, each from the reference's
    state and batch, held as the module docstring says. Returns the port
    Solver and the cells whose write rests on an exact-0 update in one
    package only."""
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp, train_feed=jfeed._python_data_feed(
        JNet(sp.net_param, pb.TRAIN).layers[0]))
    spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                  pattern=sp.failure_pattern)
    jstate = jax.tree.map(jnp.asarray, jpacked.pack_state(
        {g: {k: np.asarray(v) for k, v in leaves.items()}
         for g, leaves in js.fault_state.items()}, spec))
    jstep = jax.jit(js.make_train_step(
        hw_engine="pallas", dtype_policy="ternary", fault_format="packed",
        pack_spec=spec, fused_epilogue=True))
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
    assert spec["life_dtype"] == "int16"
    assert ts._fault_keys == ["ip1/0", "ip1/1"]
    stats = [ly.name for ly in ts.net.layers if ly.type_name == "BatchNorm"]
    rate = float(sp.base_lr)
    params, hist = js.params, js.history
    for ln, vals in params.items():        # one draw from the seed
        for a, b in zip(vals, ts.params[ln]):
            np.testing.assert_array_equal(bits(b.numpy()), bits(a))
    apart = 0
    for it in range(steps):
        ts.params = convert.params_from_jax(
            {k: [host(a) for a in v] for k, v in params.items()})
        ts.history = {k: {s: torch.from_numpy(host(a)) for s, a in
                          v.items()} for k, v in hist.items()}
        ts.fault_state = convert.fault_state_from_jax(
            jax.tree.map(host, jstate))
        batch = {k: np.asarray(v) for k, v in js.train_feed().items()}
        params, hist, jstate, loss, _, _ = jstep(
            params, hist, jstate, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
            jnp.int32(it), jax.random.fold_in(js._key, it), False)
        ts.params, ts.history, ts.fault_state, tloss, _ = ts._step_fn(
            ts.params, ts.history, ts.fault_state,
            {k: torch.from_numpy(v) for k, v in batch.items()}, it,
            ts._step_fn.noise.step_key(ts._key, it))
        assert float(tloss) == pytest.approx(float(loss), rel=REL), it
        upd = dict(zip(ts._fault_keys, updates[-1]))
        masks = {}
        for k, ref in jstate["life_q"].items():
            got, want = ts.fault_state["life_q"][k].numpy(), host(ref)
            differ = got != want
            # the port wrote no decrement where the reference did: its
            # update was an exact 0; it wrote where the reference did
            # not: a rounding-sized update
            u = upd[k].numpy()
            assert (u[differ & (got > want)] == 0).all(), (it, k)
            assert (np.abs(u[differ & (got < want)])
                    <= 1e-6 * rate).all(), (it, k)
            apart += int(differ.sum())
            masks[k] = differ
            if not differ.any():
                # the stuck codes, four cells a byte
                np.testing.assert_array_equal(
                    ts.fault_state["stuck_bits"][k].numpy(),
                    host(jstate["stuck_bits"][k]), err_msg=f"{it} {k}")
        for ln, vals in params.items():
            for i, (a, b) in enumerate(zip(vals, ts.params[ln])):
                if ln in stats and i == 2:
                    np.testing.assert_array_equal(bits(b.numpy()), bits(a))
                    continue
                keep = ~masks.get(f"{ln}/{i}", np.zeros(a.shape, bool))
                atol = (REL * float(np.abs(host(a)).max()) if ln in stats
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
    return ts, apart


@pytest.mark.parametrize("name", list(NETS))
def test_solver_matches_the_reference_in_lockstep(monkeypatch, name):
    monkeypatch.chdir(REPO)
    ts, apart = lockstep(monkeypatch, solver_text(name), 3)
    assert ts.broken_fraction() > 0.01
    # ip1's 10250 cells: exact-0 writes in one package only are rare
    assert apart <= 10


# ---------------------------------------------------------------------------
# lanes

SYNTH = """name: "lanes"
layer { name: "in" type: "Input" top: "data" top: "target" top: "sim"
  input_param { shape { dim: 4 dim: 3 dim: 6 dim: 6 } shape { dim: 4 dim: 5 }
                shape { dim: 4 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 6 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "across" type: "LRN" bottom: "conv" top: "across"
  lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 } }
layer { name: "within" type: "LRN" bottom: "across" top: "within"
  lrn_param { local_size: 3 alpha: 0.3 beta: 0.75
              norm_region: WITHIN_CHANNEL } }
layer { name: "slice" type: "Slice" bottom: "within" top: "s0" top: "s1"
  slice_param { slice_point: 2 } }
layer { name: "concat" type: "Concat" bottom: "s1" bottom: "s0" top: "cat" }
layer { name: "sum" type: "Eltwise" bottom: "cat" bottom: "within"
  top: "sum" eltwise_param { operation: SUM coeff: 0.5 coeff: -1.5 } }
layer { name: "prod" type: "Eltwise" bottom: "sum" bottom: "conv"
  top: "prod" eltwise_param { operation: PROD } }
layer { name: "max" type: "Eltwise" bottom: "prod" bottom: "data6"
  top: "max" eltwise_param { operation: MAX } }
layer { name: "softmax" type: "Softmax" bottom: "max" top: "softmax" }
layer { name: "split" type: "Split" bottom: "softmax" top: "sa" top: "sb" }
layer { name: "sig" type: "Sigmoid" bottom: "sa" top: "sig" }
layer { name: "tanh" type: "TanH" bottom: "sb" top: "tanh" }
layer { name: "flat" type: "Flatten" bottom: "sig" top: "flat" }
layer { name: "reshape" type: "Reshape" bottom: "tanh" top: "rs"
  reshape_param { shape { dim: 0 dim: 12 dim: -1 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "flat" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "ip2" type: "InnerProduct" bottom: "rs" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" } } }
layer { name: "euclid" type: "EuclideanLoss" bottom: "ip1" bottom: "target"
  top: "euclid" }
layer { name: "contrast" type: "ContrastiveLoss" bottom: "ip1"
  bottom: "ip2" bottom: "sim" top: "contrast"
  contrastive_loss_param { margin: 2 } }
"""
# MAX's second bottom: the data every lane shares, cut to conv's width
SYNTH = SYNTH.replace(
    'layer { name: "max"',
    'layer { name: "pad" type: "Concat" bottom: "data" bottom: "data" '
    'top: "data6" }\nlayer { name: "max"')
SYNTH_SOLVER = (f'net_param {{ {SYNTH} }} base_lr: 0.05 momentum: 0.9 '
                'weight_decay: 0.004 lr_policy: "fixed" display: 0 '
                'max_iter: 100 random_seed: 4 failure_pattern { '
                'type: "gaussian" mean: 250 std: 120 }')


def synth_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(4, 3, 6, 6).astype(F32),
             "target": rng.randn(4, 5).astype(F32),
             "sim": rng.randint(0, 2, 4).astype(F32)} for _ in range(n)]


def lane_cases():
    return {"synthetic": (SYNTH_SOLVER, synth_batches(4)),
            "full": (solver_text("full", batch=4), None),
            "sigmoid_bn": (solver_text("sigmoid_bn", batch=4), None)}


@pytest.mark.parametrize("case", ["synthetic", "full", "sigmoid_bn"])
def test_lanes_against_blocks_and_the_lane_alone(monkeypatch, case):
    """C = 4: blocks of 2 equal the unblocked runner bit for bit; each
    lane, one step at a time, equals a single-config Solver started from
    its state (loss within 1e-5 relative, banks identical)."""
    monkeypatch.chdir(REPO)
    text, bs = lane_cases()[case]
    if bs is None:
        sp = pb.SolverParameter()
        text_format.Parse(text, sp)
        feed = jfeed._python_data_feed(JNet(sp.net_param, pb.TRAIN)
                                       .layers[0])
        bs = [{k: np.asarray(v) for k, v in feed().items()}
              for _ in range(3)]
    C = 4
    runs = []
    for block in (0, 2):
        r, _ = runner(text, bs, C, block)
        losses = [r.step(1)[0].copy() for _ in range(2)]
        runs.append((r, losses))
    (a, la), (b, lb) = runs
    for x, y in zip(la, lb):
        assert x.tobytes() == y.tobytes()
    assert_same_state(a, b)
    single = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                     hw_engine="cuda", dtype_policy="ternary",
                     fault_format="packed", fused_epilogue=True,
                     train_feed=cycling(bs))
    assert single.pack_spec == a._pack_spec
    batch = a._batch(a.iter)
    keys = a.lane_keys(a.iter)
    lanes = [a.lane_state(i) for i in range(C)]
    _, _, kf, kl, _ = a._step(a.params, a.history, a.fault_states, batch,
                              a.iter, keys)
    for i in range(C):
        _, _, sf, sl, _ = single._step_fn(*lanes[i], batch, a.iter, keys[i])
        assert float(sl) == pytest.approx(float(kl[i]), rel=1e-5), i
        for k in sf["life_q"]:
            assert torch.equal(sf["life_q"][k], kf["life_q"][k][i]), (i, k)
    for r in (a, b):
        r.close()


def test_lanes_refuse_what_they_cannot_fold():
    """Flatten from axis 0 and a Reshape of the batch axis would move the
    lane-folded channel axis: they raise by name under lanes."""
    for layer in ('type: "Flatten" bottom: "ip" top: "out" '
                  'flatten_param { axis: 0 }',
                  'type: "Reshape" bottom: "ip" top: "out" '
                  'reshape_param { shape { dim: 2 dim: -1 } }'):
        text = ('name: "r" layer { name: "in" type: "Input" top: "data" '
                'input_param { shape { dim: 4 dim: 3 } } } '
                'layer { name: "ip" type: "InnerProduct" bottom: "data" '
                'top: "ip" inner_product_param { num_output: 6 } } '
                f'layer {{ name: "out" {layer} }}')
        net = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                   device="cpu")
        params = {"ip": [torch.zeros(2, 6, 3), torch.zeros(2, 6)]}
        with pytest.raises(NotImplementedError, match="'out'"):
            net.apply(params, {"data": torch.zeros(4, 3)}, lanes=2)


# ---------------------------------------------------------------------------
# the siamese net

def siamese_crossbar(net, broken, stuck, lib, seed=11, q_bits=2):
    """The crossbar read armed on every InnerProduct read: each of the
    six layers reads its owner's weight (ip1, ip2, feat) with the owner's
    broken and stuck cells."""
    out = {}
    for ly in net.layers:
        if ly.type_name != "InnerProduct":
            continue
        owner = ly.name.replace("_p", "")
        entry = (lib(broken[owner]), lib(stuck[owner]), seed, 0.0, q_bits)
        out[ly.name] = entry + ((True,) if lib is torch.from_numpy else ())
    return out


def test_siamese_forward_backward_matches_with_shared_fault_targets():
    """Three owners (ip1, ip2, feat), six reads through the crossbar read
    (ternary, broken cells at their stuck values), the contrastive loss
    over seeded pairs; loss within 1e-5 relative, every gradient within
    1e-4 of its largest value (the shared weights' two reads sum)."""
    text = siamese_text(batch=8)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    assert [r.key for r in tnet.failure_param_refs] == [
        ("ip1", 0), ("ip1", 1), ("ip2", 0), ("ip2", 1), ("feat", 0),
        ("feat", 1)]
    reads = [ly.name for ly in tnet.layers if ly.type_name == "InnerProduct"]
    assert len(reads) == 6
    tp = tnet.init(prng.PRNGKey(2))
    assert sorted(tp) == ["conv1", "conv2", "feat", "ip1", "ip2"]
    rng = np.random.RandomState(0)
    broken = {k: rng.rand(*tp[k][0].shape) < 0.1 for k in
              ("ip1", "ip2", "feat")}
    stuck = {k: rng.choice([-1.0, 0.0, 1.0], size=tp[k][0].shape)
             .astype(F32) for k in broken}
    batch = {"pair_data": rng.rand(8, 2, 28, 28).astype(F32),
             "sim": rng.randint(0, 2, 8).astype(F32)}
    jp = {k: [jnp.asarray(a) for a in v]
          for k, v in convert.params_to_jax(tp).items()}
    jcb = siamese_crossbar(tnet, broken, stuck, jnp.asarray)

    def f(p):
        return jnet.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          crossbar=jcb)[1]
    jloss, jg = jax.value_and_grad(f)(jp)
    leaves = {k: [t.requires_grad_() for t in v] for k, v in tp.items()}
    _, tloss = tnet.apply(leaves, {k: torch.from_numpy(v) for k, v in
                                   batch.items()},
                          crossbar=siamese_crossbar(tnet, broken, stuck,
                                                    torch.from_numpy))
    flat = [(k, i, t) for k, v in leaves.items() for i, t in enumerate(v)]
    tg = torch.autograd.grad(tloss, [t for _, _, t in flat])
    tloss = float(tloss.detach())
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    assert tloss > 0
    for (k, i, _), g in zip(flat, tg):
        want = np.asarray(jg[k][i])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{k}/{i}")


# ---------------------------------------------------------------------------
# HDF5

@pytest.mark.parametrize("name", list(NETS))
def test_hdf5_solver_files_are_refused_without_h5py(monkeypatch, capsys,
                                                    name):
    """The solver files as they are (snapshot_format: HDF5), with no
    h5py to import: solve() raises by name before any step."""
    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "h5py", None)
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    sp = read_solver_param(NETS[name][0])
    assert sp.snapshot_format == tproto.HDF5
    sp.max_iter = 1
    s = TSolver(sp, device="cpu")
    with pytest.raises(NotImplementedError, match=r"solve\(\).*h5py"):
        s.solve()
    assert s.iter == 0
    assert "Iteration" not in capsys.readouterr().out
