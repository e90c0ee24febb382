"""The Solver's snapshot, restore and solve() in the port
(solver/solver.py) against the reference package's.

A two-layer FC net (12 -> 6 -> 3, batch 8, one fixed batch), SGD with
momentum, lifetimes N(250, 30) at decrement 100 so cells die from the
third write on. Held: the three snapshot files byte for byte what the
reference writes for the same state (at iteration 0 both packages hold
the same draw), the `.faultstate` and `.solverstate` encodings equal to
protobuf's, a snapshot of either package restored in the other continues
as the writer's own run does (lifetimes identical, params and losses
within 1e-5 relative: the packages sum the products in other orders),
and within the port a restored run equals the run that never stopped
bit for bit, f32 and packed banks alike.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.solver.lr_policies import \
    current_step_fn as j_current_step_fn
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver.lr_policies import \
    current_step_fn as t_current_step_fn
from rram_caffe_simulation_tpu_torch.utils import io as tio

from test_torch_seeded import TINY_NET, tiny_batch

REL = 1e-5
BATCH = tiny_batch()


def solver_text(prefix, extra="", policy='lr_policy: "fixed"'):
    return (f'net_param {{ {TINY_NET} }} base_lr: 0.05 momentum: 0.9 '
            f'weight_decay: 0.004 {policy} random_seed: 7 '
            f'max_iter: 4 snapshot_prefix: "{prefix}" failure_pattern {{ '
            f'type: "gaussian" mean: 250 std: 30 }} {extra}')


def port_solver(prefix, extra="", policy='lr_policy: "fixed"', **kw):
    return TSolver(tproto.parse(solver_text(prefix, extra, policy),
                                "SolverParameter"),
                   device="cpu", train_feed=lambda: BATCH, **kw)


def ref_solver(prefix, extra=""):
    sp = pb.SolverParameter()
    text_format.Parse(solver_text(prefix, extra), sp)
    with jax.enable_x64(False):
        return JSolver(sp, train_feed=lambda: BATCH)


def ref_step(js, n):
    with jax.enable_x64(False):
        js.step(n)


def host(a):
    return np.array(a, copy=True)


def files(prefix, it):
    return {ext: f"{prefix}_iter_{it}.{ext}"
            for ext in ("caffemodel", "solverstate", "faultstate")}


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_continues_as(port, ref):
    """A port solver and a reference solver after the same steps from the
    same state."""
    for ln, vals in ref.params.items():
        for i, a in enumerate(vals):
            np.testing.assert_allclose(port.params[ln][i].numpy(), host(a),
                                       rtol=REL, atol=1e-7)
    for k, v in ref.fault_state["lifetimes"].items():
        np.testing.assert_array_equal(port.fault_state["lifetimes"][k]
                                      .numpy(), host(v))
    assert port.smoothed_loss == pytest.approx(ref.smoothed_loss, rel=REL)


# ---------------------------------------------------------------------------
# the formats

@pytest.mark.parametrize("remap", [False, True], ids=["plain", "remap_slots"])
def test_faultstate_bytes_equal_the_reference(remap):
    rng = np.random.RandomState(1)
    shapes = {"fc1/0": (6, 12), "fc1/1": (6,), "fc2/0": (3, 6)}
    state = {"lifetimes": {k: (rng.randn(*s) * 300).astype(np.float32)
                           for k, s in shapes.items()},
             "stuck": {k: rng.randint(-1, 2, s).astype(np.float32)
                       for k, s in shapes.items()}}
    if remap:
        state["remap_slots"] = {"0": rng.permutation(6).astype(np.int32),
                                "1": np.arange(3, dtype=np.int32)}
    want = jengine.fault_state_to_proto(state).SerializeToString()
    tstate = {g: {k: torch.from_numpy(v) for k, v in leaves.items()}
              for g, leaves in state.items()}
    msg = tengine.fault_state_to_proto(tstate)
    assert tproto.encode(msg) == want
    back = tengine.fault_state_from_proto(tproto.decode(want, "NetParameter"))
    assert list(back) == list(state)
    for g, leaves in state.items():
        for k, v in leaves.items():
            assert back[g][k].dtype == torch.from_numpy(v).dtype
            np.testing.assert_array_equal(back[g][k].numpy(), v)


def test_snapshot_files_equal_the_reference_at_the_same_state(tmp_path):
    """At iteration 0 both packages hold the same draw from the seed: the
    .caffemodel, .solverstate and .faultstate they write are the same
    bytes."""
    prefix = str(tmp_path / "snap")
    js = ref_solver(prefix)
    js.snapshot()
    want = {ext: read(p) for ext, p in files(prefix, 0).items()}
    for p in files(prefix, 0).values():
        os.remove(p)
    ts = port_solver(prefix)
    assert ts.snapshot() == files(prefix, 0)["caffemodel"]
    for ext, p in files(prefix, 0).items():
        assert read(p) == want[ext], ext


def test_solverstate_bytes_equal_protobuf_after_steps(tmp_path):
    prefix = str(tmp_path / "s")
    ts = port_solver(prefix,
                     policy='lr_policy: "step" stepsize: 2 gamma: 0.5')
    ts.step(3)
    ts.snapshot()
    st = pb.SolverState(iter=3, learned_net=files(prefix, 3)["caffemodel"],
                        current_step=1)
    for k in ("fc1/0", "fc1/1", "fc2/0", "fc2/1"):
        arr = ts.history[k]["h"].numpy()
        blob = st.history.add()
        blob.shape.dim[:] = arr.shape
        blob.data.extend(arr.reshape(-1).tolist())
    assert read(files(prefix, 3)["solverstate"]) == st.SerializeToString()
    assert np.abs(ts.history["fc1/0"]["h"].numpy()).max() > 0


@pytest.mark.parametrize("policy", [
    'lr_policy: "step" stepsize: 3',
    'lr_policy: "multistep" stepvalue: 2 stepvalue: 5 stepvalue: 9',
    'lr_policy: "multistep"',
    'lr_policy: "fixed"',
], ids=["step", "multistep", "multistep-empty", "fixed"])
def test_current_step_follows_the_reference(policy):
    text = f"base_lr: 0.1 gamma: 0.5 {policy}"
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    ref = j_current_step_fn(sp)
    port = t_current_step_fn(tproto.parse(text, "SolverParameter"))
    got = [port(it) for it in range(12)]
    assert got == [int(ref(jnp.int32(it))) for it in range(12)]
    assert all(type(v) is int for v in got)


# ---------------------------------------------------------------------------
# across the packages

def test_port_snapshot_restores_into_the_reference(tmp_path):
    prefix = str(tmp_path / "port")
    ts = port_solver(prefix)
    ts.step(2)
    ts.snapshot()
    ts.step(2)
    assert ts.broken_fraction() > 0.0
    js = ref_solver(str(tmp_path / "ref"))
    with jax.enable_x64(False):
        js.restore(files(prefix, 2)["solverstate"])
    assert js.iter == 2
    ref_step(js, 2)
    assert_continues_as(ts, js)


def test_reference_snapshot_restores_into_the_port(tmp_path):
    prefix = str(tmp_path / "ref")
    js = ref_solver(prefix)
    ref_step(js, 2)
    js.snapshot()
    ref_step(js, 2)
    for packed in (False, True):
        ts = port_solver(str(tmp_path / "port"),
                         fault_format="packed" if packed else "f32")
        ts.restore(files(prefix, 2)["solverstate"])
        assert ts.iter == 2
        ts.step(2)
        if packed:
            # the banks against the reference's lifetimes: broken alike
            for k, v in js.fault_state["lifetimes"].items():
                np.testing.assert_array_equal(
                    ts.fault_state["life_q"][k].numpy() <= 0, host(v) <= 0)
            assert ts.smoothed_loss == pytest.approx(js.smoothed_loss,
                                                     rel=REL)
        else:
            assert_continues_as(ts, js)


@pytest.mark.parametrize("fault_format", ["f32", "packed"])
def test_restored_run_is_bit_identical(tmp_path, fault_format):
    prefix = str(tmp_path / "snap")
    full = port_solver(prefix, fault_format=fault_format)
    full.step(2)
    full.snapshot()
    losses = []
    for _ in range(2):
        full.step(1)
        losses.append(float(full.last_loss))
    fresh = port_solver(str(tmp_path / "other"), fault_format=fault_format)
    fresh.restore(files(prefix, 2)["solverstate"])
    got = []
    for _ in range(2):
        fresh.step(1)
        got.append(float(fresh.last_loss))
    assert got == losses
    for ln, vals in full.params.items():
        for i, t in enumerate(vals):
            assert torch.equal(fresh.params[ln][i], t)
    for k, slots in full.history.items():
        assert torch.equal(fresh.history[k]["h"], slots["h"])
    for g, leaves in full.fault_state.items():
        for k, v in leaves.items():
            assert fresh.fault_state[g][k].dtype == v.dtype
            assert torch.equal(fresh.fault_state[g][k], v)
    # the file holds the f32 view whatever the banks are
    saved = tengine.fault_state_from_proto(tio.read_proto_binary(
        files(prefix, 2)["faultstate"], "NetParameter"))
    assert list(saved) == ["lifetimes", "stuck"]


def test_background_snapshot_writes_the_same_files(tmp_path):
    a = port_solver(str(tmp_path / "a"))
    b = port_solver(str(tmp_path / "b"))
    a.step(2)
    b.step(2)
    a.snapshot()
    b.enable_background_snapshots()
    b.snapshot()
    b.wait_for_snapshots()
    for ext in ("caffemodel", "faultstate"):
        assert read(files(str(tmp_path / "a"), 2)[ext]) == \
            read(files(str(tmp_path / "b"), 2)[ext])
    a_state = tio.read_proto_binary(files(str(tmp_path / "a"), 2)
                                    ["solverstate"], "SolverState")
    b_state = tio.read_proto_binary(files(str(tmp_path / "b"), 2)
                                    ["solverstate"], "SolverState")
    assert a_state.history == b_state.history and b_state.iter == 2


# ---------------------------------------------------------------------------
# solve()

def _solve_lines(text, prefix):
    keep = ("Solving", "Snapshotting", "Optimization Done", "Iteration")
    return [ln.replace(prefix, "<prefix>") for ln in text.splitlines()
            if ln.startswith(keep)]


@pytest.mark.parametrize("extra,iters", [
    ("snapshot: 2", [2, 4]),
    ("snapshot: 3", [3, 4]),
    ("snapshot: 3 snapshot_after_train: false", [3]),
    ("", [4]),
], ids=["aligned", "after-train", "no-after-train", "final-only"])
def test_solve_prints_and_writes_as_the_reference(tmp_path, capsys, extra,
                                                  iters):
    rp, tp = str(tmp_path / "ref" / "s"), str(tmp_path / "port" / "s")
    js = ref_solver(rp, extra + " display: 2")
    capsys.readouterr()
    with jax.enable_x64(False):
        js.solve()
    want = _solve_lines(capsys.readouterr().out, rp)
    ts = port_solver(tp, extra + " display: 2")
    ts.solve()
    got = _solve_lines(capsys.readouterr().out, tp)
    num = re.compile(r"= -?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    assert [num.sub("= #", g) for g in got] == \
        [num.sub("= #", w) for w in want]
    assert got[0] == "Solving tiny" and got[-1] == "Optimization Done."
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == sorted(
        os.path.basename(p) for it in iters for p in files(tp, it).values())
    assert ts.iter == js.iter == 4


def test_solve_resumes_from_a_snapshot(tmp_path, capsys):
    prefix = str(tmp_path / "s")
    full = port_solver(prefix, "snapshot: 2")
    full.solve()
    capsys.readouterr()
    fresh = port_solver(str(tmp_path / "r" / "s"), "snapshot: 2")
    fresh.solve(resume_file=files(prefix, 2)["solverstate"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "Solving tiny"
    assert f"Snapshotting to {tmp_path}/r/s_iter_4.caffemodel" in out
    assert f"{tmp_path}/r/s_iter_2" not in out
    assert fresh.iter == 4
    for ln, vals in full.params.items():
        for i, t in enumerate(vals):
            assert torch.equal(fresh.params[ln][i], t)
    assert read(files(prefix, 4)["faultstate"]) == \
        read(files(str(tmp_path / "r" / "s"), 4)["faultstate"])


def test_solve_refuses_fused_chunk(tmp_path):
    s = port_solver(str(tmp_path / "s"))
    with pytest.raises(NotImplementedError, match="fused_chunk"):
        s.solve(fused_chunk=2)
    assert s.iter == 0


# ---------------------------------------------------------------------------
# refusals and the warning

def test_hdf5_raises_by_name(tmp_path, monkeypatch):
    """Without h5py (an import that fails), HDF5 snapshots, restores and
    solves raise by name (tests/test_torch_hdf5.py covers them with
    h5py)."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    s = port_solver(str(tmp_path / "s"), "snapshot: 2 snapshot_format: HDF5")
    s.step(1)
    with pytest.raises(NotImplementedError, match="HDF5.*h5py"):
        s.step(1)
    assert s.iter == 2 and not os.path.exists(tmp_path / "s_iter_2.caffemodel")
    with pytest.raises(NotImplementedError, match="HDF5.*h5py"):
        s.restore(str(tmp_path / "s_iter_2.solverstate.h5"))
    with pytest.raises(NotImplementedError, match="HDF5.*h5py"):
        s.solve()


@pytest.mark.parametrize("extra, refused", [
    ("", True),                                   # snapshot_after_train
    ("snapshot: 2 snapshot_after_train: false", True),
    ("snapshot_after_train: false", False),       # no snapshot is due
])
def test_hdf5_solve_refuses_before_training(tmp_path, capsys, monkeypatch,
                                            extra, refused):
    monkeypatch.setitem(sys.modules, "h5py", None)
    s = port_solver(str(tmp_path / "s"), f"snapshot_format: HDF5 {extra}")
    if refused:
        with pytest.raises(NotImplementedError, match="solve.*HDF5.*h5py"):
            s.solve()
        assert s.iter == 0 and "Solving" not in capsys.readouterr().out
    else:
        s.solve()
        assert s.iter == 4 and not os.listdir(tmp_path)


def test_missing_faultstate_warns_as_the_reference(tmp_path, capsys):
    prefix = str(tmp_path / "s")
    s = port_solver(prefix)
    s.step(2)
    s.snapshot()
    os.remove(files(prefix, 2)["faultstate"])
    js = ref_solver(str(tmp_path / "ref"))
    capsys.readouterr()
    with jax.enable_x64(False):
        js.restore(files(prefix, 2)["solverstate"])
    want = capsys.readouterr().err.strip().splitlines()
    fresh = port_solver(str(tmp_path / "p"))
    drawn = {k: v.clone() for k, v in fresh.fault_state["lifetimes"].items()}
    fresh.restore(files(prefix, 2)["solverstate"])
    got = capsys.readouterr().err.strip().splitlines()
    assert got == [ln for ln in want if ln.startswith("WARNING")]
    assert "RE-DRAWN at iteration 2" in got[0]
    for k, v in drawn.items():
        assert torch.equal(fresh.fault_state["lifetimes"][k], v)
    assert fresh.iter == 2


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


@pytest.mark.parametrize("tiles", [None, "2x2"])
def test_missing_faultstate_logs_the_reference_redraw_record(tmp_path,
                                                             capsys, tiles):
    """With sinks attached, a restore whose .faultstate is missing logs
    one `fault_redraw` record equal to the reference's (every field but
    wall_time; `tiles` under a non-default grid), valid under the port's
    schema; the stderr WARNING and the CaffeLogSink line are the
    reference's."""
    from rram_caffe_simulation_tpu.observe import schema as jschema
    from rram_caffe_simulation_tpu.observe import sink as jsink
    from rram_caffe_simulation_tpu_torch.observe import schema as tschema
    from rram_caffe_simulation_tpu_torch.observe import sink as tsink
    extra = f'rram_forward {{ tiles: "{tiles}" }}' if tiles else ""
    prefix = str(tmp_path / "s")
    s = port_solver(prefix, extra)
    s.step(2)
    s.snapshot()
    os.remove(files(prefix, 2)["faultstate"])
    runs = []
    for make, mod, name in ((port_solver, tsink, "p"),
                            (ref_solver, jsink, "r")):
        solver = make(str(tmp_path / name), extra)
        sink, log = _ListSink(), str(tmp_path / f"{name}.log")
        caffe = mod.CaffeLogSink(log, net_name=solver.net.name)
        solver.enable_metrics(sink, caffe)
        capsys.readouterr()
        with jax.enable_x64(False):
            solver.restore(files(prefix, 2)["solverstate"])
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("WARNING")]
        caffe.close()
        lines = [ln.split("] ", 1)[1] for ln in open(log).read()
                 .splitlines() if "] " in ln]
        runs.append((sink.records, err, lines))
    (got, got_err, got_log), (want, want_err, want_log) = runs
    assert [r["type"] for r in got] == [r["type"] for r in want] == \
        ["fault_redraw"]
    drop = lambda r: {k: v for k, v in r.items() if k != "wall_time"}
    assert drop(got[0]) == drop(want[0])
    assert got[0]["iter"] == 2 and got[0].get("tiles") == (
        None if tiles is None else want[0]["tiles"])
    assert tschema.validate_record(got[0]) == []
    assert jschema.validate_record(got[0]) == []
    assert got_err == want_err and len(got_err) == 1
    assert got_log == want_log and len(got_log) == 2


def _edit_faultstate(path, edit):
    msg = tio.read_proto_binary(path, "NetParameter")
    edit(msg)
    tio.write_proto_binary(path, msg)


@pytest.mark.parametrize("case,match", [
    ("drop_key", "covers params"),
    ("extra_group", "state groups"),
    ("history", "Incorrect length of history blobs"),
])
def test_restore_refusals(tmp_path, case, match):
    prefix = str(tmp_path / "s")
    s = port_solver(prefix)
    s.step(1)
    s.snapshot()
    paths = files(prefix, 1)
    if case == "drop_key":
        _edit_faultstate(paths["faultstate"],
                         lambda m: m.layer.pop(0))
    elif case == "extra_group":
        def add(m):
            lp = tproto.Message("LayerParameter")
            lp.name, lp.type = "fc1/0", "FaultLeaf:drift_age"
            lp.blobs = [tio.array_to_blob(np.zeros((6, 12), np.float32))]
            m.layer.append(lp)
        _edit_faultstate(paths["faultstate"], add)
    else:
        st = tio.read_proto_binary(paths["solverstate"], "SolverState")
        st.history = st.history[:3]
        tio.write_proto_binary(paths["solverstate"], st)
    with pytest.raises(ValueError, match=match):
        port_solver(str(tmp_path / "p")).restore(paths["solverstate"])
