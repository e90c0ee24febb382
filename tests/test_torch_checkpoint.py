"""The sweep's durability layer in the port (parallel/sweep.py
checkpoint, restore, save_fault_states) against the reference package's.

The small conv net of tests/test_torch_sweep.py at C = 3 lanes, their
lifetimes from N(250, 30) to N(450, 250) so cells break all through the
run, the ternary crossbar read, f32 and packed banks. Within the port a
continued run equals the run that never stopped bit for bit (losses,
params, history, banks, quarantine). Across the packages, a checkpoint
either one writes restores in the other, and the continuations agree:
banks identical, losses within 1e-5 relative (the packages sum
convolutions and products in other orders). The feed is a list of
batches indexed by the iteration, so a restored run reads what the
uninterrupted one read.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import async_exec
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.parallel import sweep as tsweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_sweep import MEANS, STDS, SOLVER, batches, port_sweep

STEPS = 3          # before the checkpoint, and after it
BS = batches(2 * STEPS + 2, seed=5)
REL = 1e-5


def feed_from(start):
    """Batch `start`, then the next ones: the feed of a run restored at
    iteration `start`."""
    state = {"i": start}

    def feed():
        b = BS[state["i"] % len(BS)]
        state["i"] += 1
        return b
    return feed


def port(start=0, packed=True, **kw):
    return port_sweep(feed_from(start), packed_state=packed, **kw)


def state_of(r) -> dict:
    """Every checkpointed leaf of a port runner as host arrays."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in r._state_arrays().items()}


def assert_same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


def ref_solver(feed):
    sp = pb.SolverParameter()
    text_format.Parse(SOLVER, sp)
    return JSolver(sp, train_feed=feed)


def ref_runner(start=0, packed=True):
    return JSweep(ref_solver(feed_from(start)), 3, means=MEANS, stds=STDS,
                  engine="jax", packed_state=packed, dtype_policy="ternary")


def host_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# within the port

@pytest.mark.parametrize("packed", [True, False], ids=["packed", "f32"])
def test_continuation_is_bit_identical(tmp_path, packed):
    full = port(packed=packed)
    full.step(STEPS, chunk=STEPS)
    path = full.checkpoint(str(tmp_path / "sweep.ckpt.npz"))
    want = [full.step(1)[0].copy() for _ in range(STEPS)]
    fresh = port(start=STEPS, packed=packed)
    assert fresh.restore(path) is fresh and fresh.iter == STEPS
    got = [fresh.step(1)[0].copy() for _ in range(STEPS)]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert_same_state(state_of(fresh), state_of(full))
    for leaf in fresh._state_arrays().values():
        assert leaf.is_contiguous()
    assert float(full.broken_fractions().min()) > 0.0


def test_checkpoint_meta_has_every_reference_key(tmp_path):
    r = port()
    r.step(2, chunk=2)
    path = r.checkpoint(str(tmp_path / "c.npz"))
    data = read_npz(path)
    meta = json.loads(bytes(bytearray(data.pop("__meta__"))).decode())
    assert meta == {
        "version": 6, "iter": 2, "n_configs": 3, "fault_format": "packed",
        "pack_spec": r._pack_spec, "fault_process": "endurance_stuck_at",
        "tile_spec": "1x1",
        "key": [int(x) for x in r.solver._key], "seed": 4,
        "virtual_time": False, "quarantined": [], "lane_map": [0, 1, 2],
        "lane_done": [2, 2, 2]}
    assert list(data) == list(r._state_arrays())
    assert "params/conv1/0" in data and "history/conv1/0/h" in data
    assert "fault/life_q/ip1/0" in data and data["quarantine"].dtype == bool


# ---------------------------------------------------------------------------
# across the packages

@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """One reference runner and the port's, both from seed 4: the
    reference runs STEPS, checkpoints, runs STEPS more; then restores the
    port's checkpoint of the same iteration and runs STEPS again."""
    tmp = tmp_path_factory.mktemp("cross")
    with jax.enable_x64(False):
        ref = ref_runner()
        ref.step(STEPS, chunk=STEPS)
        ref_path = str(tmp / "ref.ckpt.npz")
        ref.checkpoint(ref_path)
        ref_cont = [np.asarray(ref.step(1, chunk=1)[0]).copy()
                    for _ in range(STEPS)]
        ref_banks = host_tree(ref.fault_states)
        ref_faults = str(tmp / "ref_faults.npz")
        ref.save_fault_states(ref_faults, background=False)

        p = port()
        p.step(STEPS, chunk=STEPS)
        port_path = p.checkpoint(str(tmp / "port.ckpt.npz"))
        port_cont = [p.step(1)[0].copy() for _ in range(STEPS)]
        ref._feed = feed_from(STEPS)
        ref.restore(port_path)
        assert ref.iter == STEPS
        from_port = [np.asarray(ref.step(1, chunk=1)[0]).copy()
                     for _ in range(STEPS)]
        from_port_banks = host_tree(ref.fault_states)
        ref.close()
    return {"ref_path": ref_path, "ref_cont": ref_cont,
            "ref_banks": ref_banks, "ref_faults": ref_faults,
            "port": p, "port_path": port_path, "port_cont": port_cont,
            "from_port": from_port, "from_port_banks": from_port_banks}


def test_reference_checkpoint_restores_into_the_port(cross):
    r = port(start=STEPS)
    r.restore(cross["ref_path"])
    assert r.iter == STEPS
    for want in cross["ref_cont"]:
        np.testing.assert_allclose(r.step(1)[0], want, rtol=REL)
    for k, q in r.fault_states["life_q"].items():
        np.testing.assert_array_equal(q.numpy(),
                                      cross["ref_banks"]["life_q"][k])
    assert float(r.broken_fractions().min()) > 0.0


def test_port_checkpoint_restores_into_the_reference(cross):
    for got, want in zip(cross["from_port"], cross["port_cont"]):
        np.testing.assert_allclose(got, want, rtol=REL)
    p = cross["port"]
    for k, q in p.fault_states["life_q"].items():
        np.testing.assert_array_equal(cross["from_port_banks"]["life_q"][k],
                                      q.numpy())


def test_save_fault_states_equals_the_reference(cross, tmp_path):
    """The port's fault-state file at the reference's continued state:
    the f32 layout under packed banks, array for array."""
    r = port(start=STEPS)
    r.restore(cross["ref_path"])
    r.step(STEPS, chunk=STEPS)
    path = r.save_fault_states(str(tmp_path / "faults.npz"))
    r.wait_for_writes()
    got, want = read_npz(path), read_npz(cross["ref_faults"])
    assert list(got) == list(want)
    assert sorted({k.split("/")[0] for k in got}) == ["lifetimes", "stuck"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    r.close()


@pytest.mark.parametrize("to_packed", [True, False],
                         ids=["f32-to-packed", "packed-to-f32"])
def test_format_conversion_on_restore(tmp_path, to_packed):
    """An f32 checkpoint into a packed runner and the reverse: the fault
    leaves equal the reference's convert_flat of the file's, the other
    leaves are the file's."""
    src = port(packed=not to_packed)
    src.step(STEPS, chunk=STEPS)
    path = src.checkpoint(str(tmp_path / "c.npz"))
    dst = port(start=STEPS, packed=to_packed)
    dst.restore(path)
    data = read_npz(path)
    spec = dst._pack_spec if to_packed else src._pack_spec
    flat = {k[len("fault/"):]: v for k, v in data.items()
            if k.startswith("fault/")}
    want = jpacked.convert_flat(flat, to_packed=to_packed, spec=spec)
    assert tpacked.convert_flat(flat, to_packed, spec).keys() == want.keys()
    got = state_of(dst)
    for k, v in want.items():
        assert got[f"fault/{k}"].dtype == v.dtype, k
        np.testing.assert_array_equal(got[f"fault/{k}"], v)
    for k, v in data.items():
        if not k.startswith(("fault/", "__meta__")):
            assert got[k].tobytes() == v.tobytes(), k
    # and the converted state trains on
    assert np.isfinite(dst.step(1)[0]).all()


# ---------------------------------------------------------------------------
# refusals

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    r = port()
    r.step(2, chunk=2)
    return r.checkpoint(str(tmp_path_factory.mktemp("saved") / "c.npz"))


def _edited(saved, tmp_path, edit=None, edit_data=None):
    data = read_npz(saved)
    meta = json.loads(bytes(bytearray(data["__meta__"])).decode())
    if edit:
        edit(meta)
    if edit_data:
        edit_data(data)
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = str(tmp_path / "edited.npz")
    np.savez(path, **data)
    return path


def genetics_bytes():
    """A real `__genetics__` entry: one GeneticStrategy a lane, as a
    genetic sweep writes it."""
    from rram_caffe_simulation_tpu_torch.fault import genetic_state
    from rram_caffe_simulation_tpu_torch.fault import strategies as tstrat
    pw = [np.ones((12, 24), np.float32), np.ones((5, 12), np.float32)]
    lanes = [tstrat.GeneticStrategy([("ip1/0", "ip1/1"), ("ip2/0", "ip2/1")],
                                    pw, 2, 2, 20) for _ in range(3)]
    raw = np.frombuffer(genetic_state.dumps(lanes), np.uint8)
    assert len(genetic_state.loads(raw)) == 3
    return raw


@pytest.mark.parametrize("case,match", [
    ("n_configs", "holds 5 configs"),
    ("key", "different solver RNG key"),
    ("tile_spec", "tile spec '2x2'"),
    ("fault_process", "fault process 'conductance_drift'"),
    ("healing", "self-healing state"),
    ("missing_key", "missing \\['params/ip2/1'\\]"),
    ("leaf_shape", "leaf 'params/ip2/0' has shape"),
    ("version", "format version 7"),
    ("virtual_time", "virtual_time"),
    ("genetics", "disagree on the genetic"),
])
def test_restore_refusals(saved, tmp_path, case, match):
    edits = {
        "n_configs": lambda m: m.update(n_configs=5),
        "key": lambda m: m.update(key=[1, 2]),
        "tile_spec": lambda m: m.update(tile_spec="2x2"),
        "fault_process": lambda m: m.update(
            fault_process="conductance_drift"),
        "healing": lambda m: m.update(healing={"lane_cfg": [0, 1, 2]}),
        "version": lambda m: m.update(version=7),
        "virtual_time": lambda m: m.update(virtual_time=True),
    }
    data_edits = {
        "missing_key": lambda d: d.pop("params/ip2/1"),
        "leaf_shape": lambda d: d.update(
            {"params/ip2/0": d["params/ip2/0"][:, :2]}),
        "genetics": lambda d: d.update(__genetics__=genetics_bytes()),
    }
    path = _edited(saved, tmp_path, edits.get(case), data_edits.get(case))
    r = port()
    before = state_of(r)
    with pytest.raises(ValueError, match=match):
        r.restore(path)
    assert_same_state(state_of(r), before)     # nothing half-restored
    assert r.iter == 0


def test_v5_checkpoint_restores_untiled_and_is_refused_tiled(saved,
                                                             tmp_path):
    """A v5 checkpoint (no tile_spec) is the untiled mapping: it restores
    into an untiled runner and is refused by a tiled one."""
    def v5(meta):
        meta["version"] = 5
        del meta["tile_spec"]
    path = _edited(saved, tmp_path, v5)
    r = port(start=2)
    r.restore(path)
    assert r.iter == 2
    assert_same_state(state_of(r), {k: v for k, v in read_npz(saved).items()
                                    if k != "__meta__"})
    solver = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                     train_feed=feed_from(2), tile_spec="2x2")
    tiled = TSweep(solver, 3, means=MEANS, stds=STDS, packed_state=True,
                   dtype_policy="ternary", device="cpu")
    assert tiled._tile_canonical() == "2x2"
    with pytest.raises(ValueError, match="'1x1'.*'2x2'"):
        tiled.restore(path)


def test_distributed_directory_restores_and_needs_its_manifest(saved,
                                                              tmp_path):
    """A v4 distributed directory (two shards of rows, global.npz with
    the quarantine mask, manifest.json) made by hand from a port
    checkpoint restores to the same state; without its manifest it is
    refused."""
    data = read_npz(saved)
    meta = json.loads(bytes(bytearray(data.pop("__meta__"))).decode())
    d = tmp_path / "dist.ckpt"
    d.mkdir()
    rows = [(0, 2), (2, 3)]
    sharded = {k: v for k, v in data.items() if k != "quarantine"}
    for i, (lo, hi) in enumerate(rows):
        np.savez(d / f"shard_{i:05d}.npz",
                 **{k: v[lo:hi] for k, v in sharded.items()})
    np.savez(d / "global.npz", quarantine=data["quarantine"])
    manifest = {"meta": meta, "leaves": sorted(sharded),
                "shards": [{"file": f"shard_{i:05d}.npz", "rows": [lo, hi]}
                           for i, (lo, hi) in enumerate(rows)]}
    (d / "manifest.json").write_text(json.dumps(manifest))
    r = port(start=2)
    r.restore(str(d))
    assert_same_state(state_of(r), data)
    os.remove(d / "manifest.json")
    with pytest.raises(ValueError, match="manifest.json"):
        port().restore(str(d))


def test_checkpoint_overwrites_a_directory_of_that_name(tmp_path):
    r = port()
    path = tmp_path / "c.ckpt"
    path.mkdir()
    (path / "shard_00000.npz").write_bytes(b"x")
    r.checkpoint(str(path))
    assert path.is_file()


# ---------------------------------------------------------------------------
# background writes

def test_background_checkpoint_is_atomic_and_lands_on_wait(tmp_path):
    """A background write holds the final name only once whole: while the
    writer is held, only the temp file exists; after `wait_for_writes`
    the file restores."""
    r = port()
    r.step(1)
    gate = threading.Event()
    inner = tsweep._savez_writer

    def held(arrays):
        write = inner(arrays)

        def slow(tmp):
            write(tmp)
            gate.wait(10)
        return slow
    path = str(tmp_path / "bg.npz")
    tsweep._savez_writer = held
    try:
        r.checkpoint(path, background=True)
        assert not os.path.exists(path)
        gate.set()
        r.wait_for_writes()
    finally:
        tsweep._savez_writer = inner
    assert os.path.exists(path)
    assert os.listdir(tmp_path) == ["bg.npz"]
    fresh = port(start=1)
    fresh.restore(path)
    assert_same_state(state_of(fresh), state_of(r))
    r.close()
    r.close()


def test_writer_error_is_sticky_and_keeps_the_good_file(tmp_path):
    path = str(tmp_path / "faults.npz")
    r = port()
    r.save_fault_states(path)
    r.wait_for_writes()
    good = read_npz(path)
    assert sorted({k.split("/")[0] for k in good}) == ["lifetimes", "stuck"]

    def boom(tmp):
        with open(tmp, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")
    writer = r._bg_writer
    writer.submit(path, boom)
    with pytest.raises(OSError, match="disk full"):
        r.wait_for_writes()
    with pytest.raises(OSError, match="disk full"):
        r.save_fault_states(path)           # sticky at the next submit
    with pytest.raises(OSError, match="disk full"):
        r.close()
    assert os.listdir(tmp_path) == ["faults.npz"]
    for k, v in read_npz(path).items():
        np.testing.assert_array_equal(v, good[k])


def test_atomic_write_removes_its_temp_file_on_failure(tmp_path):
    path = str(tmp_path / "sub" / "f.bin")

    def fail(tmp):
        open(tmp, "wb").close()
        raise RuntimeError("no")
    with pytest.raises(RuntimeError):
        async_exec.atomic_write(path, fail)
    assert os.listdir(tmp_path / "sub") == []
    async_exec.atomic_write(path, lambda tmp: open(tmp, "wb").close())
    assert os.listdir(tmp_path / "sub") == ["f.bin"]
