"""The HDF5 snapshot formats in the port (utils/io.py `write_net_hdf5`,
`read_net_hdf5`, `write_solver_state_hdf5`, `read_solver_state_hdf5`,
`read_net_param`'s `.h5`/`.hdf5` route; `Solver.snapshot`/`restore`
under `snapshot_format: HDF5`) against the reference package's, on the
CPU, where h5py is installed.

- Files written by either package are read by the other: every array
  bit for bit with its dtype (float32 blobs, a float64 blob, the history),
  the iteration, the model's name and current_step equal.
- A port Solver restored from the reference's `.solverstate.h5` (and a
  reference Solver from the port's) continues in lockstep with the
  package that wrote it: losses within 1e-4 relative, lifetimes bit for
  bit; both write the same snapshot file names.
- Without h5py (`sys.modules["h5py"] = None`), every HDF5 function
  raises NotImplementedError naming h5py; a Solver and the runner refuse
  an HDF5 template by name before training, never switching to
  BINARYPROTO.
"""
import os
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.utils import io as jio
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_gaussian_exp as texp
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.utils import io as tio

from test_torch_experiment_drivers import (  # noqa: F401 (autouse)
    net_text, one_torch_thread, template_text)
from test_torch_group_prefetch import build_db

REL = 1e-4


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return build_db(tmp_path_factory.mktemp("hdf5") / "db")


def net_proto(db):
    """The harness net's params (seeded) as a port NetParameter, with a
    float64 blob on a layer of its own."""
    net = TNet(tproto.parse(net_text(db), "NetParameter"), tproto.TRAIN,
               device="cpu")
    out = net.to_proto(net.init(prng.PRNGKey(2)))
    extra = tproto.Message("LayerParameter")
    extra.name = "f64"
    extra.blobs = [tio.array_to_blob(
        np.random.RandomState(0).randn(3, 2).astype(np.float64))]
    out.layer.append(extra)
    return out


def port_arrays(net_param):
    return {lp.name: [tio.blob_to_array(b) for b in lp.blobs]
            for lp in net_param.layer}


def ref_arrays(net_param):
    return {lp.name: [jio.blob_to_array(b) for b in lp.blobs]
            for lp in net_param.layer}


def same_arrays(a, b):
    assert list(a) == list(b) or sorted(a) == sorted(b)
    for k in a:
        assert len(a[k]) == len(b[k])
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_net_hdf5_crosses_packages(db, tmp_path, writer):
    mine = net_proto(db)
    theirs = pb.NetParameter.FromString(tproto.encode(mine))
    path = str(tmp_path / "m.caffemodel.h5")
    if writer == "port":
        tio.write_net_hdf5(mine, path)
        got = ref_arrays(jio.read_net_hdf5(path))
    else:
        jio.write_net_hdf5(theirs, path)
        got = port_arrays(tio.read_net_hdf5(path))
    want = port_arrays(mine)
    same_arrays(got, want)
    assert got["f64"][0].dtype == np.float64
    # the .h5/.hdf5 route of read_net_param
    for name in ("m.caffemodel.h5", "m.hdf5"):
        if name != "m.caffemodel.h5":
            os.rename(path, str(tmp_path / name))
            path = str(tmp_path / name)
        same_arrays(port_arrays(tio.read_net_param(path)), want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_solver_state_hdf5_crosses_packages(tmp_path, writer):
    rng = np.random.RandomState(1)
    history = [rng.randn(4, 64).astype(np.float32),
               rng.randn(4).astype(np.float32),
               rng.randn(2, 3).astype(np.float64)]
    path = str(tmp_path / "s.solverstate.h5")
    write = (tio if writer == "port" else jio).write_solver_state_hdf5
    write(path, 7, "x/s_iter_7.caffemodel.h5", 2, history)
    for read in (tio.read_solver_state_hdf5, jio.read_solver_state_hdf5):
        it, learned, cur, hist = read(path)
        assert (it, learned, cur) == (7, "x/s_iter_7.caffemodel.h5", 2)
        assert len(hist) == 3
        for a, b in zip(hist, history):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def solver_text(db, prefix):
    return template_text(db).replace(
        'snapshot_prefix: "fail/"',
        f'snapshot_prefix: "{prefix}" snapshot_format: HDF5').replace(
        'mean: 5000000 std: 1000000', "mean: 300 std: 60").replace(
        "display: 2", "display: 0").replace("test_interval: 3",
                                            "test_interval: 0")


def make(package, text):
    if package == "port":
        return TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return JSolver(sp)


def losses(s):
    return float(s.losses[-1])


def lifetimes(s):
    return {k: np.asarray(v) for k, v in
            s.fault_state["lifetimes"].items()}


@pytest.mark.parametrize("writer, reader", [("reference", "port"),
                                            ("port", "reference")])
def test_restored_solver_continues_in_lockstep(db, tmp_path, writer,
                                               reader):
    """The writer's Solver runs 2 steps and snapshots (HDF5); a Solver of
    the other package restores that snapshot and runs 3 more steps beside
    the writer's own restored Solver: losses within 1e-4 relative, the
    lifetimes bit for bit at every step."""
    prefix = str(tmp_path / "w" / "s")
    first = make(writer, solver_text(db, prefix))
    first.step(2)
    model = first.snapshot()
    assert model == prefix + "_iter_2.caffemodel.h5"
    assert sorted(os.listdir(tmp_path / "w")) == [
        "s_iter_2.caffemodel.h5", "s_iter_2.faultstate",
        "s_iter_2.solverstate.h5"]
    state = prefix + "_iter_2.solverstate.h5"
    same = make(writer, solver_text(db, str(tmp_path / "a" / "s")))
    other = make(reader, solver_text(db, str(tmp_path / "b" / "s")))
    for s in (same, other):
        s.restore(state)
        assert s.iter == 2
    for k, v in lifetimes(first).items():
        assert v.tobytes() == lifetimes(other)[k].tobytes()
    for ln, vals in first.params.items():
        for a, b in zip(vals, other.params[ln]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for _ in range(3):
        same.step(1)
        other.step(1)
        assert losses(other) == pytest.approx(losses(same), rel=REL)
        want = lifetimes(same)
        for k, v in lifetimes(other).items():
            assert v.tobytes() == want[k].tobytes()
    assert float(np.sum([(v <= 0).sum() for v in want.values()])) > 0
    # both packages write the same snapshot files: the template's
    # `snapshot: 4`, then one more
    for s in (same, other):
        s.snapshot()
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b")) == [
            f"s_iter_{i}.{ext}" for i in (4, 5)
            for ext in ("caffemodel.h5", "faultstate", "solverstate.h5")]


def test_copy_trained_from_reads_hdf5_weights(db, tmp_path):
    net = TNet(tproto.parse(net_text(db), "NetParameter"), tproto.TRAIN,
               device="cpu")
    params = net.init(prng.PRNGKey(4))
    path = str(tmp_path / "w.caffemodel.h5")
    jio.write_net_hdf5(pb.NetParameter.FromString(
        tproto.encode(net.to_proto(params))), path)
    got = net.copy_trained_from(net.init(prng.PRNGKey(9)), path)
    for ln, vals in params.items():
        for a, b in zip(vals, got[ln]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# without h5py

@pytest.fixture
def no_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)


@pytest.mark.parametrize("call", [
    lambda p: tio.write_net_hdf5(tproto.Message("NetParameter"), p),
    lambda p: tio.read_net_hdf5(p),
    lambda p: tio.write_solver_state_hdf5(p, 1, "m", 0, []),
    lambda p: tio.read_solver_state_hdf5(p),
    lambda p: tio.read_net_param(p),
], ids=["write_net", "read_net", "write_state", "read_state",
        "read_net_param"])
def test_hdf5_functions_name_h5py(no_h5py, tmp_path, call):
    path = str(tmp_path / "x.h5")
    with pytest.raises(NotImplementedError, match="HDF5.*h5py"):
        call(path)
    assert not os.path.exists(path)


def test_solver_refuses_hdf5_before_training(no_h5py, db, tmp_path,
                                             capsys):
    s = make("port", solver_text(db, str(tmp_path / "s")).replace(
        "max_iter: 6", "max_iter: 2"))
    with pytest.raises(NotImplementedError, match=r"solve\(\).*h5py"):
        s.solve()
    assert s.iter == 0 and os.listdir(tmp_path) == []
    assert "Iteration" not in capsys.readouterr().out


def test_runner_refuses_an_hdf5_template_by_name(no_h5py, db, tmp_path,
                                                 monkeypatch):
    """The template's HDF5 snapshots without h5py: the runner raises by
    name and its log holds the solver text and no Iteration line; nothing
    is snapshotted in another format."""
    template = tmp_path / "t.prototxt"
    template.write_text(template_text(db).replace(
        'snapshot_prefix: "fail/"', "snapshot_format: HDF5"))
    monkeypatch.setattr(texp, "HERE", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="h5py"):
        texp.main(["300", "60", "0", "-y", "--cpu", "--template",
                   str(template)])
    snap = tmp_path / "snapshot_300.0_60.0"
    assert os.listdir(snap) == ["log"]
    log = (snap / "log").read_text()
    assert "snapshot_format: HDF5" in log and "Iteration" not in log
