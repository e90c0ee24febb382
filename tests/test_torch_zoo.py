"""The published ImageNet-width zoo nets and examples/pycaffe's
generated_net in the port against the reference package, on the CPU.

The zoo nets' Data layers read examples/imagenet/ilsvrc12_*_lmdb, which
are not in the repository: both Data layers read a stand-in LMDB of four
3x256x256 Datums written from a seed by the port's BulkWriter (the
reference's test writes the same with its own), and `mean_file` is
replaced by `mean_value: 104 117 123`, as the reference's
tests/test_zoo_models.py does.

- Each net builds at its published width in TRAIN and TEST with the
  reference's layer names, blob shapes and parameter shapes and count
  (the draws stubbed to empty tensors on the meta device: a full-width
  draw on the CPU would take minutes);
  ResNet-50's count lies within 25.5M-25.7M, as the reference pins it;
  GoogLeNet has its three weighted losses and, in TEST, top-1 and top-5
  Accuracy on every head.
- R-CNN's deploy net forwards to its 200 raw scores, against the
  reference's forward on the same params (within 1e-5 of the largest).
- finetune_flickr_style's TRAIN net (Input in place of ImageData, as the
  reference's test swaps it) copies a CaffeNet trunk from a .caffemodel
  the port writes and keeps fc8_flickr at its filler; the reference
  reads the same file to the same params; its Solver steps.
- Grouped convolutions on tiles: the Solver refuses AlexNet's conv2
  (group 2) as a conv_also fault target on tiles, by name; a tiled read
  of it is refused at the forward in both packages.
- generated_net (examples/pycaffe/generated_net.prototxt as the
  reference's run_pycaffe.py writes it with its NetSpec: the file is
  generated, not in the repository; random DummyData data, constant
  labels) trains 3 steps in lockstep with the reference's Solver, and
  over 4 lanes: each lane against a single-config Solver from its
  state, blocks of 2 against the unblocked runner bit for bit;
  chip_smoke.py carries the same net.

The 3-step Solver lockstep of the zoo nets at narrow widths is in
tests/test_torch_zoo_alexnet.py, _googlenet.py and _resnet.py; the
helpers here serve them.
"""
import re

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
from rram_caffe_simulation_tpu_torch.data.feed import array_to_datum
from rram_caffe_simulation_tpu_torch.data.lmdb_py import BulkWriter
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver
from rram_caffe_simulation_tpu_torch.utils.io import write_proto_binary

from test_torch_config_block import assert_same_state
from test_torch_solver import REPO

F32 = np.float32
REL, ATOL = 1e-4, 1e-6
# `lockstep`'s `kinks`: a leaf's relative norm gap, and all leaves'
KINK_LEAF, KINK_ALL = 1e-1, 5e-2
# a narrow net's widths: every num_output divided by NARROW, the
# classifiers' (1000 classes, R-CNN's 200, flickr's 20) kept
NARROW = 16
CLASSES = (1000, 200, 20)
ZOO = {
    "alexnet": ("models/bvlc_alexnet/solver.prototxt",
                "models/bvlc_alexnet/train_val.prototxt"),
    "caffenet": ("models/bvlc_reference_caffenet/solver.prototxt",
                 "models/bvlc_reference_caffenet/train_val.prototxt"),
    "googlenet": ("models/bvlc_googlenet/quick_solver.prototxt",
                  "models/bvlc_googlenet/train_val.prototxt"),
    "resnet50": ("models/resnet50/solver.prototxt",
                 "models/resnet50/resnet50_train_val.prototxt"),
}
RCNN = "models/bvlc_reference_rcnn_ilsvrc13/deploy.prototxt"
FLICKR = "models/finetune_flickr_style/train_val.prototxt"
CAFFENET_DEPLOY = "models/bvlc_reference_caffenet/deploy.prototxt"


@pytest.fixture(autouse=True)
def no_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    processes (tests/test_torch_experiment_drivers.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def host(a):
    return np.array(a, copy=True)


def standin_lmdb(path, n=4):
    """Four 3x256x256 Datums with labels below 1000 from RandomState(0),
    the reference test's stand-in for the ILSVRC12 LMDBs."""
    rng = np.random.RandomState(0)
    with BulkWriter(str(path)) as w:
        for i in range(n):
            arr = rng.randint(0, 256, size=(3, 256, 256), dtype=np.uint8)
            w.put(f"{i:08d}".encode(), tproto.encode(
                array_to_datum(arr, int(rng.randint(1000)))))
    return str(path)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    return standin_lmdb(tmp_path_factory.mktemp("zoo") / "ilsvrc_lmdb")


def narrow(text, factor=NARROW):
    if factor == 1:
        return text
    return re.sub(r"num_output: (\d+)", lambda m: "num_output: %d" % (
        int(m.group(1)) if int(m.group(1)) in CLASSES
        else max(1, int(m.group(1)) // factor)), text)


def generated_text():
    """examples/pycaffe/generated_net.prototxt as the reference's
    examples/pycaffe/run_pycaffe.py `generate_with_net_spec` writes it
    (the file is generated, not in the repository)."""
    from rram_caffe_simulation_tpu.api.net_spec import NetSpec
    from rram_caffe_simulation_tpu.api.net_spec import layers as L
    from rram_caffe_simulation_tpu.api.net_spec import params as P
    n = NetSpec()
    n.data, n.label = L.DummyData(
        ntop=2, shape=[dict(dim=[8, 1, 8, 8]), dict(dim=[8])],
        data_filler=[dict(type="gaussian"), dict(type="constant")])
    n.conv = L.Convolution(n.data, kernel_size=3, num_output=4,
                           weight_filler=dict(type="xavier"))
    n.relu = L.ReLU(n.conv, in_place=True)
    n.pool = L.Pooling(n.conv, pool=P.Pooling.MAX, kernel_size=2, stride=2)
    n.ip = L.InnerProduct(n.pool, num_output=10,
                          weight_filler=dict(type="xavier"))
    n.loss = L.SoftmaxWithLoss(n.ip, n.label)
    return str(n.to_proto())


def zoo_net_text(path, db=None, batch=None, factor=1):
    """A zoo prototxt (a path, or "generated_net") with its Data layers
    on `db`, the mean file as mean values, `batch` images a batch and
    `factor`-narrow widths."""
    text = (generated_text() if path == "generated_net"
            else open(f"{REPO}/{path}").read())
    if db is not None:
        text = re.sub(r'source: "[^"]*"', f'source: "{db}"', text)
    text = re.sub(r'mean_file: "[^"]*"',
                  "mean_value: 104 mean_value: 117 mean_value: 123", text)
    if batch is not None:
        text = re.sub(r"batch_size: \d+", f"batch_size: {batch}", text)
    return narrow(text, factor)


def zoo_solver_text(name, db, batch=2, factor=NARROW, mean=250.0,
                    std=120.0):
    """The net's own solver file with its net inlined (`zoo_net_text`),
    faults on its InnerProduct layers at N(mean, std), a seed, no display
    and no test."""
    solver, net = ZOO[name]
    body = open(f"{REPO}/{solver}").read()
    body = re.sub(r"(?m)^net: .*$", "net_param { %s }" % zoo_net_text(
        net, db, batch, factor), body)
    body = re.sub(r"(?m)^(display|test_iter|test_interval|average_loss|"
                  r"test_initialization): .*$", "", body)
    return (body + " display: 0 test_interval: 0 random_seed: 3 "
            f'failure_pattern {{ type: "gaussian" mean: {mean} std: {std} }}')


def lockstep(monkeypatch, text, steps, kinks=False):
    """`steps` steps of the port's Solver on the CPU, each from the
    reference's state, batch and key, against the reference's jitted
    step (Pallas in interpret mode): faults on every InnerProduct, packed
    banks, the ternary crossbar read, the fused epilogue. Losses within
    1e-4 relative; the banks exact but for cells whose write rests on an
    exact-0 update in one package (checked, counted; their stuck codes
    are then not compared); params and history within rtol 1e-4 / atol
    1e-6 elsewhere, BatchNorm's statistics within 1e-4 of their largest
    value and its scale_factor bit for bit.

    `kinks`: a deep net's float32 forward parts from a float64 one by
    ~1e-4 of a blob's largest value (both packages alike,
    tests/test_torch_zoo_resnet.py), so a pre-activation that close to
    zero passes a ReLU in one package only and every gradient below it
    moves. Then the fault targets (above every ReLU) and BatchNorm's
    statistics (forward only) are held as above, and every other leaf's
    step update and history by its relative norm gap to the reference's:
    each leaf within KINK_LEAF, all of them together within KINK_ALL (a
    wrong backward rule moves a leaf's gradient by its own size).
    Returns (the port Solver, the cells apart in the banks, and under
    `kinks` each step's (largest leaf gap, overall gap) of the updates
    and of the history)."""
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    jnet = JNet(sp.net_param, pb.TRAIN)
    feed = (jfeed._python_data_feed(jnet.layers[0])
            if jnet.layers[0].is_data_source else (lambda: {}))
    js = JSolver(sp, train_feed=feed)
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
    assert ts._fault_keys == [
        f"{r.layer_name}/{r.slot}" for r in jnet.failure_param_refs]
    stats = [ly.name for ly in ts.net.layers if ly.type_name == "BatchNorm"]
    rate = float(sp.base_lr)
    params, hist = js.params, js.history
    for ln, vals in params.items():        # one draw from the seed
        for a, b in zip(vals, ts.params[ln]):
            np.testing.assert_array_equal(bits(b.numpy()), bits(a))
    targets = {ln for ln, _ in (k.rsplit("/", 1) for k in ts._fault_keys)}
    apart = 0
    readings = {"update": [], "history": []} if kinks else None

    def kink_gap(sums, got, want, what):
        d, r = float(np.sum((got - want) ** 2)), float(np.sum(want ** 2))
        leaf = (d / r) ** 0.5 if r else d ** 0.5
        assert np.isfinite(got).all() and leaf <= KINK_LEAF, (what, leaf)
        sums[0], sums[1], sums[2] = max(sums[0], leaf), sums[1] + d, \
            sums[2] + r
    for it in range(steps):
        old = {k: [host(a) for a in v] for k, v in params.items()}
        ts.params = convert.params_from_jax(old)
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
        assert np.isfinite(float(loss))
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
                np.testing.assert_array_equal(
                    ts.fault_state["stuck_bits"][k].numpy(),
                    host(jstate["stuck_bits"][k]), err_msg=f"{it} {k}")
        sums = {"update": [0.0] * 3, "history": [0.0] * 3}
        for ln, vals in params.items():
            for i, (a, b) in enumerate(zip(vals, ts.params[ln])):
                if ln in stats and i == 2:
                    np.testing.assert_array_equal(bits(b.numpy()), bits(a))
                    continue
                if kinks and ln not in targets and ln not in stats:
                    kink_gap(sums["update"], b.numpy() - old[ln][i],
                             host(a) - old[ln][i], f"step {it} {ln}/{i}")
                    continue
                keep = ~masks.get(f"{ln}/{i}", np.zeros(a.shape, bool))
                atol = (REL * float(np.abs(host(a)).max()) if ln in stats
                        else ATOL)
                np.testing.assert_allclose(
                    b.numpy()[keep], host(a)[keep], rtol=REL, atol=atol,
                    err_msg=f"step {it} {ln}/{i}")
        for k, slots in hist.items():
            ln, i = k.rsplit("/", 1)
            keep = ~masks.get(k, np.zeros(np.shape(params[ln][int(i)]),
                                          bool))
            for s, a in slots.items():
                if kinks and ln not in targets:
                    kink_gap(sums["history"], ts.history[k][s].numpy(),
                             host(a), f"step {it} {k} {s}")
                    continue
                np.testing.assert_allclose(
                    ts.history[k][s].numpy()[keep], host(a)[keep], rtol=REL,
                    atol=ATOL, err_msg=f"step {it} {k} {s}")
        for kind, (leaf, d, r) in (sums.items() if kinks else ()):
            overall = (d / r) ** 0.5
            assert overall <= KINK_ALL, (it, kind, overall)
            readings[kind].append((leaf, overall))
    return ts, apart, readings


# ---------------------------------------------------------------------------
# the nets build at their published widths

BUILDS = {name: net for name, (_, net) in ZOO.items()}
BUILDS.update({"rcnn": RCNN, "generated_net": "generated_net"})
PARAMS = {"alexnet": 60965224, "caffenet": 60965224, "googlenet": 13378280,
          "resnet50": 25610205, "rcnn": 57687624, "generated_net": 410}


def shape_only(monkeypatch):
    """prng's bulk draws as empty tensors of their shape on the meta
    device: Net.init then gives each param's shape at once (the values
    are the lockstep tests' business)."""
    def empty(key, shape):
        return torch.empty(np.asarray(key).shape[:-1] + tuple(shape),
                           device="meta")
    monkeypatch.setattr(prng, "normal", lambda key, shape, device="cpu":
                        empty(key, shape))
    monkeypatch.setattr(prng, "uniform", lambda key, shape, *a:
                        empty(key, shape))
    monkeypatch.setattr(prng, "bernoulli", lambda key, p, shape,
                        device="cpu": empty(key, shape))


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("name", list(BUILDS))
def test_zoo_nets_build_at_their_published_widths(monkeypatch, standin,
                                                  name, phase):
    shape_only(monkeypatch)
    text = zoo_net_text(BUILDS[name], standin)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, phase)
    tnet = TNet(tproto.parse(text, "NetParameter"), phase, device="meta")
    assert [ly.name for ly in tnet.layers] == [ly.name for ly in jnet.layers]
    assert tnet.blob_shapes == {k: tuple(v) for k, v in
                                jnet.blob_shapes.items()}
    assert tnet.loss_weights == dict(jnet.loss_weights)
    assert [r.key for r in tnet.failure_param_refs] == [
        r.key for r in jnet.failure_param_refs]
    params = tnet.init(prng.PRNGKey(0))
    shapes = {ln: [tuple(v.shape) for v in vals if v is not None]
              for ln, vals in params.items()}
    want = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    assert shapes == {ln: [tuple(v.shape) for v in vals if v is not None]
                      for ln, vals in want.items()}
    count = sum(int(np.prod(s)) for v in shapes.values() for s in v)
    assert count == PARAMS[name]
    if name == "resnet50":
        assert 25_500_000 < count < 25_700_000
        assert sum(ly.type_name == "BatchNorm" for ly in tnet.layers) == 53
        assert sum(ly.type_name == "Eltwise" for ly in tnet.layers) == 16
    if name == "googlenet":
        assert sorted(tnet.loss_weights.values()) == pytest.approx(
            [0.3, 0.3, 1.0])
        names = set(tnet.layer_by_name)
        for head in ("loss1", "loss2", "loss3"):
            assert ({f"{head}/top-1", f"{head}/top-5"} <= names) == \
                (phase == 1)
    if name in ("alexnet", "caffenet", "googlenet", "resnet50"):
        crop = 224 if name in ("googlenet", "resnet50") else 227
        batch = {"alexnet": (256, 50), "caffenet": (256, 50),
                 "googlenet": (32, 50), "resnet50": (32, 25)}[name][phase]
        assert tnet.blob_shapes["data"] == (batch, 3, crop, crop)


# ---------------------------------------------------------------------------
# R-CNN, flickr_style, the tiled refusal

def test_rcnn_forwards_to_its_raw_scores():
    text = zoo_net_text(RCNN, factor=NARROW).replace("dim: 10", "dim: 2", 1)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TEST)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TEST,
                device="cpu")
    assert all(ly.type_name != "Softmax" for ly in tnet.layers)
    x = np.random.RandomState(1).randn(2, 3, 227, 227).astype(F32)
    params = tnet.init(prng.PRNGKey(0))
    jparams = {ln: [jnp.asarray(v.numpy()) for v in vals]
               for ln, vals in params.items()}
    got = tnet.apply(params, {"data": torch.from_numpy(x)})[0]["fc-rcnn"]
    want = np.asarray(jax.jit(lambda p, b: jnet.apply(p, b)[0]["fc-rcnn"])(
        jparams, {"data": jnp.asarray(x)}))
    assert got.shape == (2, 200) and (got < 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def flickr_text(batch=2):
    """finetune_flickr_style's train_val with one Input layer of `data`
    (batch x 3x227x227) and `label` in place of its ImageData layers."""
    text = zoo_net_text(FLICKR, factor=NARROW)
    blocks = re.split(r"(?m)^(?=layer \{)", text)
    keep = [b for b in blocks if 'type: "ImageData"' not in b]
    assert len(keep) == len(blocks) - 2
    feed = ('layer { name: "data" type: "Input" top: "data" top: "label" '
            f'input_param {{ shape {{ dim: {batch} dim: 3 dim: 227 '
            f'dim: 227 }} shape {{ dim: {batch} }} }} }}\n')
    return keep[0] + feed + "".join(keep[1:])


def test_flickr_copies_the_caffenet_trunk(tmp_path):
    """copy_trained_from a CaffeNet .caffemodel (written by the port)
    fills the trunk and keeps fc8_flickr at its filler, in both
    packages; fc8_flickr learns at 10x and 20x; the Solver steps."""
    text = flickr_text()
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    fc8 = tnet.layer_by_name["fc8_flickr"]
    assert [p.lr_mult for p in fc8.lp.param] == [10, 20]
    params = tnet.init(prng.PRNGKey(0))
    donor = TNet(tproto.parse(zoo_net_text(CAFFENET_DEPLOY, factor=NARROW),
                              "NetParameter"), tproto.TEST, device="cpu")
    dparams = donor.init(prng.PRNGKey(1))
    dparams["conv1"][0] = torch.full_like(dparams["conv1"][0], 0.125)
    path = str(tmp_path / "caffenet.caffemodel")
    write_proto_binary(path, donor.to_proto(dparams))
    head = params["fc8_flickr"][0].clone()
    copied = tnet.copy_trained_from(params, path)
    assert torch.equal(copied["conv1"][0], dparams["conv1"][0])
    assert torch.equal(copied["fc7"][0], dparams["fc7"][0])
    assert torch.equal(copied["fc8_flickr"][0], head)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    jcopied = jnet.copy_trained_from(jnet.init(jax.random.PRNGKey(0)), path)
    for ln, vals in copied.items():
        for a, b in zip(vals, jcopied[ln]):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    rs = np.random.RandomState(4)
    batch = {"data": rs.randn(2, 3, 227, 227).astype(F32) * 50,
             "label": rs.randint(0, 20, 2).astype(F32)}
    s = TSolver(tproto.parse(
        f"net_param {{ {text} }} base_lr: 0.001 momentum: 0.9 "
        'lr_policy: "fixed" display: 0 random_seed: 3', "SolverParameter"),
        device="cpu", train_feed=lambda: batch)
    s.params = copied
    s.step(2)
    assert np.isfinite(float(s.last_loss))
    assert not torch.equal(s.params["fc8_flickr"][0], head)


def test_grouped_convolutions_are_refused_on_tiles(standin):
    """conv_also on tiles: the Solver refuses AlexNet's grouped conv2
    (group 2) as a fault target by name, and the layer refuses a tiled
    read of it at the forward, as the reference's does."""
    text = zoo_solver_text("alexnet", standin).replace(
        'failure_pattern { type: "gaussian"',
        'rram_forward { tiles: "cells=128x128" } failure_pattern { '
        'conv_also: true type: "gaussian"')
    refusal = ("cannot map fault-target layer 'conv2': grouped "
               r"convolution \(group=2\)")
    with pytest.raises(ValueError, match=refusal):
        TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    net_text = zoo_net_text(ZOO["alexnet"][1], standin, 2, NARROW)
    tnet = TNet(tproto.parse(net_text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    jmsg = pb.NetParameter()
    text_format.Parse(net_text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    params = tnet.init(prng.PRNGKey(0))
    batch = {"data": np.zeros((2, 3, 227, 227), F32),
             "label": np.zeros(2, F32)}
    refusal = r"'conv2': grouped convolution \(group=2\) is not mappable"
    with pytest.raises(ValueError, match=refusal):
        tnet.apply(params, {k: torch.from_numpy(v) for k, v in
                            batch.items()},
                   rng=prng.PRNGKey(1), tiles={"conv2": (16, 8)})
    with pytest.raises(ValueError, match=refusal):
        jnet.apply({ln: [jnp.asarray(v.numpy()) for v in vals]
                    for ln, vals in params.items()},
                   {k: jnp.asarray(v) for k, v in batch.items()},
                   rng=jax.random.PRNGKey(1), tiles={"conv2": (16, 8)})


# ---------------------------------------------------------------------------
# generated_net

def generated_solver_text(mean=250.0, std=120.0, seed=5):
    net = generated_text()
    return (f"net_param {{ {net} }} base_lr: 0.05 momentum: 0.9 "
            'weight_decay: 0.0005 lr_policy: "fixed" display: 0 '
            f"max_iter: 100 random_seed: {seed} failure_pattern {{ "
            f'type: "gaussian" mean: {mean} std: {std} }}')


def test_chip_smoke_carries_generated_net():
    """chip_smoke.py (no JAX there, and no NetSpec in the port) carries
    generated_net's text: the same NetParameter as the reference's
    NetSpec writes."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_text", f"{REPO}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = pb.NetParameter()
    text_format.Parse(generated_text(), want)
    got = pb.NetParameter()
    text_format.Parse(smoke.GENERATED_NET, got)
    assert got == want


def test_generated_net_trains_in_lockstep(monkeypatch):
    ts, apart, _ = lockstep(monkeypatch, generated_solver_text(), 3)
    assert ts._fault_keys == ["ip/0", "ip/1"]
    assert ts.broken_fraction() > 0 and apart <= 5


def test_generated_net_over_lanes():
    """C = 4: lane i against a single-config Solver from its state on
    its own key (the data drawn per lane), blocks of 2 against the
    unblocked runner bit for bit."""
    C = 4
    text = generated_solver_text()
    runs = []
    for block in (0, 2):
        s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
        r = TSweep(s, C, engine="cuda", packed_state=True,
                   dtype_policy="ternary", device="cpu", config_block=block,
                   means=[250.0, 300.0, 350.0, 400.0],
                   stds=[120.0, 60.0, 30.0, 90.0])
        runs.append((r, [r.step(1)[0].copy() for _ in range(2)]))
    (a, la), (b, lb) = runs
    for x, y in zip(la, lb):
        assert x.tobytes() == y.tobytes()
    assert len(set(la[-1].tolist())) == C
    assert_same_state(a, b)
    single = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                     hw_engine="cuda", dtype_policy="ternary",
                     fault_format="packed", fused_epilogue=True)
    batch, keys = a._batch(a.iter), a.lane_keys(a.iter)
    assert batch == {}
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


# ---------------------------------------------------------------------------
# ReLU at zero

def test_relu_splits_a_tie_at_zero_as_the_reference():
    """The reference's ReLU is jnp.maximum(x, 0): at x == 0 it passes half
    the cotangent (JAX's rule for a tie), where Caffe passes none. The
    port follows the reference, bit for bit at 0, +-0, below, above and
    NaN, with cotangents of both signs; a negative slope passes slope * g
    at 0 in both."""
    x = np.array([0.0, -0.0, 1.5, -2.0, 3e-30, -3e-30, np.nan, 0.0],
                 np.float32)
    g = np.array([1.0, -3.0, 2.0, -5.0, 7.0, 1.0, 4.0, -0.0], np.float32)
    for slope in ("", " relu_param { negative_slope: 0.25 }"):
        text = ('name: "r" layer { name: "in" type: "Input" top: "x" '
                'input_param { shape { dim: 8 } } } layer { name: "relu" '
                f'type: "ReLU" bottom: "x" top: "y"{slope} }}')
        jmsg = pb.NetParameter()
        text_format.Parse(text, jmsg)
        jnet = JNet(jmsg, pb.TRAIN)
        tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                    device="cpu")
        jy, vjp = jax.vjp(lambda v: jnet.apply({}, {"x": v})[0]["y"],
                          jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        ty = tnet.apply({}, {"x": xt})[0]["y"]
        tg, = torch.autograd.grad(ty, xt, torch.from_numpy(g))
        np.testing.assert_array_equal(bits(tg), bits(vjp(jnp.asarray(g))[0]))
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    assert float(tg[0]) == 0.25
