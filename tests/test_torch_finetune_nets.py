"""The nets that train from their own data layers in the port's Solver,
against the reference package's, on the CPU: finetune_flickr_style
(ImageData), pascal's finetune net (WindowData) and
examples/pycaffe/linreg.prototxt (the Python layer).

The flickr_style images, the PASCAL window files and VOC images and
data/ilsvrc12/imagenet_mean.binaryproto are not in the repository: the
data layers read stand-ins written from a seed with numpy (PNGs of
assorted sizes, a `path label` list, a window file with foreground and
background windows, a 1x3x256x256 mean file), both packages the same
files. Widths are narrow (every num_output divided by 16 but the
classifiers' 20 and 21), batches small (flickr 2, pascal 4: a quarter of
it foreground).

- Each net trains 3 steps in lockstep from its own solver file (faults
  on its InnerProduct layers, packed banks, the ternary crossbar read,
  the fused epilogue), each port step from the reference's state, batch
  and key: losses within 1e-4 relative, banks exact but for cells on
  exact-0 writes (tests/test_torch_zoo.py `lockstep`). The port
  Solver's own feed (through its data layer), and a prefetching feed
  over its net, then give the reference's batches bit for bit.
- Pascal's TEST net: `Solver.test` in both packages from one seed on the
  TEST WindowData layer, its outputs within 1e-4 relative.
- Pascal's net at C = 2: each lane's step equals a single-config
  Solver's from the lane's state (loss within 1e-5 relative, banks
  identical).
- The Python layer (examples/pycaffe/pyloss.py, a numpy example):
  forward and gradients equal the reference's; a class without
  `backward` passes zero gradients.
"""
import re

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.data import feed as tfeed
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_data_sources import assert_batches_equal
from test_torch_solver import REPO
from test_torch_windows import write_images, write_mean, write_windows
from test_torch_zoo import lockstep

NARROW = 16
CLASSES = (20, 21)             # flickr's styles, pascal's 20 classes + bg
FLICKR = "models/finetune_flickr_style/solver.prototxt"
PASCAL = "examples/finetune_pascal_detection/pascal_finetune_solver.prototxt"
LINREG = "examples/pycaffe/linreg.prototxt"


@pytest.fixture(autouse=True)
def no_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reference_raw_feeds(monkeypatch):
    """lockstep builds the reference's feed with `_python_data_feed`
    (the Data layer's): take each layer type's own raw feed instead."""
    monkeypatch.setattr(jfeed, "_python_data_feed",
                        lambda layer: jfeed.FEED_BUILDERS[layer.type_name](
                            layer))


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """Stand-ins for the flickr_style lists, the PASCAL window files and
    the ILSVRC12 mean file, from seeds."""
    tmp = tmp_path_factory.mktemp("finetune")
    out = {"mean": write_mean(tmp / "imagenet_mean.binaryproto")}
    rng = np.random.RandomState(25)
    for split, seed in (("train", 1), ("test", 2)):
        images = write_images(tmp, 6, ((30, 70), (30, 90)), seed,
                              prefix=f"flickr_{split}")
        path = tmp / f"flickr_{split}.txt"
        path.write_text("".join(f"{p} {rng.randint(20)}\n"
                                for p, _ in images))
        out[f"flickr_{split}"] = str(path)
        images = write_images(tmp, 4, ((40, 80), (50, 100)), seed + 2,
                              prefix=f"voc_{split}")
        out[f"window_{split}"] = write_windows(
            tmp / f"window_{split}.txt", images, 8, seed + 4)
    return out


def narrow(text):
    return re.sub(r"num_output: (\d+)", lambda m: "num_output: %d" % (
        int(m.group(1)) if int(m.group(1)) in CLASSES
        else max(1, int(m.group(1)) // NARROW)), text)


def solver_text(solver, standins, batch, test_iter=0, mean=250.0,
                std=120.0):
    """`solver` with its net inlined: narrow, its data layers on the
    stand-ins at `batch`, faults on its InnerProduct layers at N(mean,
    std), a seed, no display; a test of `test_iter` batches, or none."""
    body = open(f"{REPO}/{solver}").read()
    net_path = re.search(r'(?m)^net: "([^"]+)"', body).group(1)
    net = open(f"{REPO}/{net_path}").read()
    net = re.sub(r'mean_file: "[^"]*"', f'mean_file: "{standins["mean"]}"',
                 net)
    for src, key in (("data/flickr_style/train.txt", "flickr_train"),
                     ("data/flickr_style/test.txt", "flickr_test"),
                     ("window_file_2007_trainval.txt", "window_train"),
                     ("window_file_2007_test.txt", "window_test")):
        net = re.sub(r'source: "[^"]*%s"' % re.escape(src),
                     f'source: "{standins[key]}"', net)
    net = re.sub(r"batch_size: \d+", f"batch_size: {batch}", net)
    body = re.sub(r"(?m)^net: .*$", "net_param { %s }" % narrow(net), body)
    body = re.sub(r"(?m)^(display|test_iter|test_interval): .*$", "", body)
    test = (f"test_iter: {test_iter} test_interval: 1000 " if test_iter
            else "test_interval: 0 ")
    return (body + f" display: 0 {test}random_seed: 3 failure_pattern {{ "
            f'type: "gaussian" mean: {mean} std: {std} }}')


def reference_feed(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return jfeed.build_feed(JNet(sp.net_param, pb.TRAIN), prefetch=False)


@pytest.mark.parametrize("name,solver,batch", [("flickr_style", FLICKR, 2),
                                               ("pascal", PASCAL, 4)])
def test_finetune_net_trains_in_lockstep(monkeypatch, standins, name,
                                         solver, batch):
    text = solver_text(solver, standins, batch)
    ts, apart, _ = lockstep(monkeypatch, text, 3)
    data = ts.net.layers[0]
    assert data.type_name == {"flickr_style": "ImageData",
                              "pascal": "WindowData"}[name]
    assert ts.net.blob_shapes["data"] == (batch, 3, 227, 227)
    assert [k for k in ts._fault_keys if k.endswith("/0")] == [
        "fc6/0", "fc7/0", "fc8_flickr/0" if name == "flickr_style"
        else "fc8_pascal/0"]
    assert ts.broken_fraction() > 0 and apart <= 20
    jf = reference_feed(text)
    pf = tfeed.build_feed(ts.net, device="cpu")
    for _ in range(3):              # the Solver's own feed, and prefetching
        want = jf()
        assert_batches_equal(ts.train_feed(), want)
        assert_batches_equal(pf(), want)
    pf.close()


def test_pascal_solver_test_matches_the_reference(standins):
    text = solver_text(PASCAL, standins, 4, test_iter=2)
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    js = JSolver(sp)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    assert [ly.type_name for ly in ts.test_nets[0].layers][0] == "WindowData"
    got, want = ts.test(0), js.test(0)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_pascal_lanes_equal_their_solvers(standins):
    """C = 2 on the sweep's own raw feed: each lane's step against a
    single-config Solver from the lane's state and key."""
    C = 2
    text = solver_text(PASCAL, standins, 4)
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                hw_engine="cuda", dtype_policy="ternary",
                fault_format="packed", fused_epilogue=True)
    r = TSweep(s, C, engine="cuda", packed_state=True,
               dtype_policy="ternary", device="cpu",
               means=[250.0, 300.0], stds=[120.0, 60.0])
    assert r._dataset is None
    jf = reference_feed(text)
    for _ in range(2):
        batch, keys = r._batch(r.iter), r.lane_keys(r.iter)
        assert_batches_equal(batch, jf())
        lanes = [r.lane_state(i) for i in range(C)]
        kp, kh, kf, kl, _ = r._step(r.params, r.history, r.fault_states,
                                    batch, r.iter, keys)
        for i in range(C):
            _, _, sf, sl, _ = s._step_fn(*lanes[i], batch, r.iter, keys[i])
            assert float(sl) == pytest.approx(float(kl[i]), rel=1e-5), i
            for k in sf["life_q"]:
                assert torch.equal(sf["life_q"][k], kf["life_q"][k][i]), \
                    (i, k)
        r._commit(kp, kh, kf, kl)
        r.iter += 1
    r.close()


# ---------------------------------------------------------------------------
# the Python layer

def linreg_text(mean=250.0, std=120.0):
    net = open(f"{REPO}/{LINREG}").read()
    return (f"net_param {{ {net} }} base_lr: 0.01 momentum: 0.9 "
            'weight_decay: 0.0005 lr_policy: "fixed" display: 0 '
            f"max_iter: 100 random_seed: 5 failure_pattern {{ "
            f'type: "gaussian" mean: {mean} std: {std} }}')


@pytest.fixture
def pyloss_path(monkeypatch):
    monkeypatch.syspath_prepend(f"{REPO}/examples/pycaffe")


def test_linreg_trains_in_lockstep(monkeypatch, pyloss_path):
    ts, apart, _ = lockstep(monkeypatch, linreg_text(), 3)
    assert ts._fault_keys == ["ipx/0", "ipx/1", "ipy/0", "ipy/1"]
    assert ts.net.layer_by_name["loss"].type_name == "Python"
    assert ts.net.loss_weights == {"loss": 1.0}
    assert ts.broken_fraction() > 0 and apart <= 5


def python_net_text(module, cls):
    return ('layer { name: "in" type: "Input" top: "a" top: "b" '
            "input_param { shape { dim: 4 dim: 6 } } } "
            'layer { name: "loss" type: "Python" bottom: "a" bottom: "b" '
            f'top: "loss" python_param {{ module: "{module}" '
            f'layer: "{cls}" }} loss_weight: 1 }}')


def test_python_layer_matches_the_reference(pyloss_path, tmp_path,
                                            monkeypatch):
    rng = np.random.RandomState(3)
    a, b = (rng.randn(4, 6).astype(np.float32) for _ in range(2))
    text = python_net_text("pyloss", "EuclideanLossLayer")
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda x, y: jnet.apply({}, {"a": x, "b": y})[1], argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    tloss = tnet.apply({}, {"a": ta, "b": tb})[1]
    tloss.backward()
    assert tnet.blob_shapes["loss"] == (1,)
    assert float(tloss.detach()) == float(jloss)
    for g, want in zip((ta.grad, tb.grad), jgrads):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    (tmp_path / "nobackward.py").write_text(
        "import numpy as np\n"
        "class Half:\n"
        "    def setup(self, bottom, top): pass\n"
        "    def reshape(self, bottom, top): top[0].reshape(1)\n"
        "    def forward(self, bottom, top):\n"
        "        top[0].data[...] = np.sum(bottom[0].data) / 2\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    tnet = TNet(tproto.parse(python_net_text("nobackward", "Half"),
                             "NetParameter"), tproto.TRAIN, device="cpu")
    ta = torch.from_numpy(a).requires_grad_()
    loss = tnet.apply({}, {"a": ta, "b": torch.from_numpy(b)})[1]
    assert float(loss.detach()) == pytest.approx(float(a.sum()) / 2,
                                                 rel=1e-6)
    loss.backward()
    assert torch.equal(ta.grad, torch.zeros_like(ta))
