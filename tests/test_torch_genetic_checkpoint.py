"""The genetic search's checkpoint state in the port
(fault/genetic_state.py, the `__genetics__` entry of
parallel/sweep.py's checkpoint) against the reference package's.

The reference stores `pickle.dumps` of its lanes' GeneticStrategy list.
Held: the port's bytes load with the reference's plain `pickle.loads`
into the reference's class and the reverse, fields, prune masks and
generator state equal; the reader refuses any global outside the
reference's class and numpy's names, by name, before it runs anything.
On the genetic sweep of tests/test_torch_sweep_strategies.py (C = 3
lanes, the small conv net, ternary read, packed banks, the search every
2 iterations from 2): a checkpoint continues bit for bit within the
port, and a checkpoint of either package restores in the other, whose
continuation keeps the prune masks and generators identical, the banks
bit for bit and the losses within 1e-4 relative (the tolerance of
tests/test_torch_sweep_strategies.py). A self-healing retry of a genetic
lane recovers that lane's search state from the file.
"""
import io
import os
import pickle

import numpy as np
import pytest

import jax

from rram_caffe_simulation_tpu.fault import strategies as jstrat
from rram_caffe_simulation_tpu_torch.fault import genetic_state
from rram_caffe_simulation_tpu_torch.fault import strategies as tstrat

from test_torch_sweep import SOLVER, batches
from test_torch_sweep_strategies import (assert_lanes_agree, port_runner,
                                         ref_runner, strategy_text)

STEPS = 3
BS = batches(2 * STEPS + 2, seed=3)


def from_(start):
    """The batches of a run resumed at iteration `start`."""
    return BS[start:] + BS[:start]


def strategies(cls, n=2):
    pw = [np.random.RandomState(1).rand(12, 24).astype(np.float32),
          np.random.RandomState(2).rand(5, 12).astype(np.float32)]
    out = [cls([("ip1/0", "ip1/1"), ("ip2/0", "ip2/1")], pw, 2, 2, 20,
               seed=7) for _ in range(n)]
    out[0]._rng.randint(100, size=5)          # the lanes' streams differ
    out[0].times = 4
    out[0].prune_weights[0][[0, 1]] = out[0].prune_weights[0][[1, 0]]
    return out


def assert_same_search(a, b):
    assert type(a).__name__ == type(b).__name__ == "GeneticStrategy"
    for f in ("fc_pairs", "start", "period", "switch_time", "seed",
              "times"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.prune_weights, b.prune_weights):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    sa, sb = a._rng.get_state(), b._rng.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


# ---------------------------------------------------------------------------
# the bytes

def test_port_bytes_load_in_the_reference():
    mine = strategies(tstrat.GeneticStrategy)
    theirs = pickle.loads(genetic_state.dumps(mine))
    assert all(isinstance(g, jstrat.GeneticStrategy) for g in theirs)
    for a, b in zip(mine, theirs):
        assert_same_search(a, b)
        assert a._rng.randint(1 << 30) == b._rng.randint(1 << 30)


def test_reference_bytes_load_in_the_port():
    theirs = strategies(jstrat.GeneticStrategy)
    raw = np.frombuffer(pickle.dumps(theirs), np.uint8)
    mine = genetic_state.loads(raw)
    assert all(isinstance(g, tstrat.GeneticStrategy) for g in mine)
    for a, b in zip(mine, theirs):
        assert_same_search(a, b)
        assert a._rng.randint(1 << 30) == b._rng.randint(1 << 30)
    # and the port's bytes of the loaded objects read back alike
    for a, b in zip(genetic_state.loads(genetic_state.dumps(mine)), mine):
        assert_same_search(a, b)


class _System:
    def __reduce__(self):
        return (os.system, ("true",))


class _Eval:
    def __reduce__(self):
        import builtins
        return (builtins.eval, ("1",))


@pytest.mark.parametrize("payload,name", [
    (_System(), os.system.__module__ + ".system"),
    (_Eval(), "builtins.eval"),
    ([io.BytesIO], "_io.BytesIO"),
], ids=["os.system", "eval", "a class"])
def test_reader_refuses_a_foreign_global(monkeypatch, payload, name):
    raw = pickle.dumps(payload)
    ran = []
    monkeypatch.setattr(os, "system", lambda *a: ran.append(a))
    with pytest.raises(pickle.UnpicklingError, match=name.replace(".", r"\.")):
        genetic_state.loads(raw)
    assert ran == []


def test_reader_refuses_what_is_not_a_list_of_searches():
    with pytest.raises(pickle.UnpicklingError, match="not a list"):
        genetic_state.loads(pickle.dumps([np.zeros(3)]))


# ---------------------------------------------------------------------------
# the sweep

@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return strategy_text(tmp_path_factory.mktemp("genetic"), "genetic")


def test_continuation_is_bit_identical(text, tmp_path):
    full = port_runner(text, BS)
    full.step(STEPS, chunk=STEPS)
    path = full.checkpoint(str(tmp_path / "g.ckpt.npz"))
    with np.load(path) as z:
        assert "__genetics__" in z.files
    want = [full.step(1)[0].copy() for _ in range(STEPS)]
    fresh = port_runner(text, from_(STEPS))
    fresh.restore(path)
    with np.load(path) as z:
        saved = genetic_state.loads(z["__genetics__"])
    for a, b in zip(fresh._genetics, saved):
        assert_same_search(a, b)
    got = [fresh.step(1)[0].copy() for _ in range(STEPS)]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    for a, b in zip(fresh._genetics, full._genetics):
        assert_same_search(a, b)
    for a, b in zip(fresh._state_tensors(), full._state_tensors()):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.fixture(scope="module")
def cross(text, tmp_path_factory):
    """The reference's genetic sweep checkpoints at STEPS and runs on;
    the port's the same; each package then restores the other's file
    and runs STEPS more."""
    tmp = tmp_path_factory.mktemp("cross")
    ref = ref_runner(text, BS)
    with jax.enable_x64(False):
        ref.step(STEPS, chunk=STEPS)
        ref_path = ref.checkpoint(str(tmp / "ref.ckpt.npz"))
        ref_cont = [np.asarray(ref.step(1)[0]).copy() for _ in range(STEPS)]
    port = port_runner(text, BS)
    port.step(STEPS, chunk=STEPS)
    port_path = port.checkpoint(str(tmp / "port.ckpt.npz"))
    port_cont = [port.step(1)[0].copy() for _ in range(STEPS)]
    back = ref_runner(text, from_(STEPS))
    with jax.enable_x64(False):
        back.restore(port_path)
        back_cont = [np.asarray(back.step(1)[0]).copy()
                     for _ in range(STEPS)]
    return {"ref": ref, "ref_path": ref_path, "ref_cont": ref_cont,
            "port": port, "port_cont": port_cont, "back": back,
            "back_cont": back_cont}


def test_reference_genetic_checkpoint_restores_in_the_port(text, cross):
    r = port_runner(text, from_(STEPS))
    r.restore(cross["ref_path"])
    assert r.iter == STEPS
    for a, b in zip(r._genetics, pickle.loads(bytes(bytearray(np.load(
            cross["ref_path"])["__genetics__"])))):
        assert_same_search(a, b)
    ref = cross["ref"]
    for want in cross["ref_cont"]:
        np.testing.assert_allclose(r.step(1)[0], want, rtol=1e-4)
    assert_lanes_agree(r, ref, r.last_losses, cross["ref_cont"][-1])
    for a, b in zip(r._genetics, ref._genetics):
        assert_same_search(a, b)


def test_port_genetic_checkpoint_restores_in_the_reference(cross):
    for got, want in zip(cross["back_cont"], cross["port_cont"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    port, back = cross["port"], cross["back"]
    assert_lanes_agree(port, back, cross["port_cont"][-1],
                       cross["back_cont"][-1])
    assert all(isinstance(g, jstrat.GeneticStrategy)
               for g in back._genetics)
    for a, b in zip(port._genetics, back._genetics):
        assert_same_search(a, b)


def test_genetic_and_plain_files_disagree(text, tmp_path):
    genetic = port_runner(text, BS)
    genetic.step(1)
    gpath = genetic.checkpoint(str(tmp_path / "g.ckpt.npz"))
    plain = port_runner(SOLVER, BS)
    ppath = plain.checkpoint(str(tmp_path / "p.ckpt.npz"))
    with pytest.raises(ValueError, match="disagree on the genetic"):
        port_runner(text, BS).restore(ppath)
    with pytest.raises(ValueError, match="disagree on the genetic"):
        plain.restore(gpath)
    assert plain.iter == 0


def test_healing_retry_recovers_the_lane_search_from_the_file(text,
                                                              tmp_path):
    """A genetic lane's first retry takes its slice of the checkpoint and
    its GeneticStrategy from `__genetics__`; a fresh re-seed takes a new
    search from the solver's."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    from test_torch_sweep_strategies import cycling
    from rram_caffe_simulation_tpu_torch import proto as tproto
    from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=cycling(BS))
    r = SweepRunner(s, 3, means=[250.0, 450.0, 300.0],
                    stds=[30.0, 250.0, 120.0], packed_state=True,
                    dtype_policy="ternary", device="cpu", pipeline_depth=0)
    r.enable_self_healing(budget=10, max_retries=2)
    r.step(4, chunk=2)
    path = r.checkpoint(str(tmp_path / "h.ckpt.npz"))
    saved = genetic_state.loads(np.load(path)["__genetics__"])
    import torch
    with torch.no_grad():
        r.params["ip2"][0][1].view(-1)[0] = float("nan")
    r.step(2, chunk=2)
    # re-seeded at 5 with the file's progress (4), then one iteration;
    # its search is next due at its own iteration 5
    assert r.config_report()["active"][1] == {"lane": 1, "done": 5,
                                              "attempt": 2}
    assert_same_search(r._genetics[1], saved[1])
    with torch.no_grad():
        r.params["ip2"][0][1].view(-1)[0] = float("nan")
    r.step(2, chunk=2)
    assert r.config_report()["active"][1]["attempt"] == 3
    assert_same_search(r._genetics[1], r._fresh_genetic())
    while not r.healing_complete():
        r.step(4, chunk=2)
    assert sorted(r.config_report()["completed"]) == [0, 1, 2]
