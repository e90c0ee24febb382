"""The self-healing sweep's per-lane clocks (parallel/sweep.py
`enable_self_healing(virtual_time=True)`) against the reference
package's.

The small conv net of tests/test_torch_sweep.py over a device-resident
LMDB (20 records, batch 4) at C = 4 lanes, the ternary crossbar read,
packed banks, lifetimes N(360-420, 60-80), and the LR policy "step" with
gamma 0.5 from a power-of-two base_lr (every rate a power of two, so the
reference's traced rate and the port's host rate agree, and the
threshold's cutoff with them): lanes whose clocks differ read different
rates. Every lane starts idle (start_empty); two configs arrive at
iteration 0 with budget 6, two more after 4 iterations with budget 4,
so the lanes run at clocks 4 apart.

In lockstep with the reference runner at depth 0 on one seed, after
every chunk: `config_report()` (losses within 1e-5 relative, as
tests/test_torch_self_healing.py holds them; broken shares within one
float32 step), the fault banks bit for bit, params within the tolerance of
tests/test_torch_sweep.py; plain SGD and Adam (its correction at each
lane's own t) on the reference's "jax" engine, threshold and remapping
on its "pallas" engine (whose broken cells get no gradient, as the
port's). The per-lane step keys equal the reference's fold_in chain
bit for bit. Checkpoints cross between the packages both ways and the
continued runs end where the never-stopped ones do. The two ValueErrors
(a host feed, config_block) are the reference's.
"""
import numpy as np
import pytest
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_self_healing import REL, banks
from test_torch_sweep import (batches, cycling, lmdb_solver_text,
                              port_sweep)
from test_torch_sweep_strategies import order_file

C = 4
WAVE1 = [{"mean": 400.0, "std": 80.0}, {"mean": 360.0, "std": 70.0}]
WAVE2 = [{"mean": 420.0, "std": 60.0}, {"mean": 380.0, "std": 75.0}]
STEP_LR = ('base_lr: 0.015625', 'lr_policy: "step" gamma: 0.5 stepsize: 3')


def solver_text(root, kind="plain"):
    text = lmdb_solver_text(root).replace("base_lr: 0.05", STEP_LR[0]) \
        .replace('lr_policy: "fixed"', STEP_LR[1])
    if kind == "threshold":
        text += ' failure_strategy { type: "threshold" threshold: 0.01 }'
    elif kind == "remap":
        # period 3: lanes 4 iterations apart are due on other iterations
        text += (' failure_strategy { type: "remapping" start: 1 period: 3 '
                 'track_identity: true prune_order_file: '
                 f'"{order_file(root)}" }}')
    elif kind == "adam":
        text += ' type: "Adam" momentum2: 0.999'
    elif kind == "noise":
        # read noise: each lane's draw comes from its step key
        text += ' rram_forward { sigma: 0.05 }'
    return text


def assert_reports_agree(got, want):
    """config_report()s equal but the losses (within REL: the packages
    sum convolutions and products in other orders) and the broken shares
    (within one float32 step: the reference's census, x64 off, is the
    count times float32(1 / cells), the port's the float64 ratio)."""
    def split(rep):
        nums = {}
        for kind in ("completed", "failed"):
            for cfg, entry in rep[kind].items():
                entry = dict(entry)
                nums[(kind, cfg)] = (entry.pop("loss", None),
                                     entry.pop("broken", None))
                rep[kind][cfg] = entry
        return rep, nums
    g, gn = split(got)
    w, wn = split(want)
    assert g == w
    for key, (gl, gb) in gn.items():
        wl, wb = wn[key]
        np.testing.assert_allclose(gl, wl, rtol=REL, err_msg=str(key))
        assert abs(np.float32(gb) - np.float32(wb)) <= np.spacing(
            np.float32(wb)), key


def port_runner(text, **kw):
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    return TSweep(s, C, packed_state=True, dtype_policy="ternary",
                  device="cpu", pipeline_depth=0, **kw)


def ref_runner(text, engine="jax"):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return JSweep(JSolver(sp), C, engine=engine, packed_state=True,
                  dtype_policy="ternary", pipeline_depth=0)


def arm(r):
    r.enable_self_healing(budget=6, max_retries=1, start_empty=True,
                          virtual_time=True)
    return r.submit_configs(WAVE1)


def params_agree(pr, rr):
    for layer, vals in pr.params.items():
        for slot, v in enumerate(vals):
            np.testing.assert_allclose(
                v.numpy(), np.asarray(rr.params[layer][slot]), rtol=1e-3,
                atol=1e-5, err_msg=f"{layer}/{slot}")


def sweep_keys_agree(pr, rr):
    """The next chunk's step keys the port's sweep derives are the
    reference's fold_in(fold_in(solver key, lane_done + j), config id),
    from the reference's lane map and progress."""
    h = rr._healing
    key = jax.numpy.asarray(np.asarray(pr.solver._key, np.uint32))
    want = np.stack([np.stack([np.asarray(jax.random.fold_in(
        jax.random.fold_in(key, int(h.lane_done[c]) + j),
        max(int(h.lane_cfg[c]), 0))) for c in range(C)]) for j in range(2)])
    assert pr._lane_clocks(2)[1].tobytes() == want.tobytes()


def banks_equal(pr, rr):
    want, got = banks(rr), banks(pr)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def lockstep(text, engine, tmp=None):
    """The two-wave scenario in both packages, held after every chunk;
    with `tmp`, both write a checkpoint at iteration 4 (the second
    wave queued, not yet seeded). Returns the finished runners."""
    pr = port_runner(text)
    with jax.enable_x64(False):
        rr = ref_runner(text, engine)
        assert arm(pr) == arm(rr) == [4, 5]
        chunks = 0
        while not (pr.healing_complete() and rr.healing_complete()):
            pr.step(2, chunk=2)
            rr.step(2, chunk=2)
            chunks += 1
            banks_equal(pr, rr)
            params_agree(pr, rr)
            sweep_keys_agree(pr, rr)
            assert_reports_agree(pr.config_report(), rr.config_report())
            if chunks == 2:
                assert pr.submit_configs(WAVE2, budget=4) == \
                    rr.submit_configs(WAVE2, budget=4) == [6, 7]
                if tmp is not None:
                    pr.checkpoint(str(tmp / "port.ckpt.npz"))
                    rr.checkpoint(str(tmp / "ref.ckpt.npz"))
    rep = pr.config_report()
    assert sorted(rep["completed"]) == [4, 5, 6, 7]
    assert {rep["completed"][c]["iter"] for c in (4, 5)} == {6}
    assert {rep["completed"][c]["iter"] for c in (6, 7)} == {8}
    return pr, rr


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("virtual_time")


@pytest.fixture(scope="module")
def plain(root):
    pr, rr = lockstep(solver_text(root), "jax", root)
    return pr, rr


def test_lockstep_with_the_reference(plain):
    pr, rr = plain
    assert pr.iter == rr.iter == 8
    assert pr._virtual_time and rr._virtual_time


def test_lane_keys_are_the_references(plain):
    """fold_in(fold_in(solver key, t_c), cfg_c), one vectorised pass."""
    pr = plain[0]
    t = np.array([[4, 0, 9, 2 ** 31 - 1], [5, 1, 10, 0]], np.int64)
    cfgs = np.array([4, 6, 0, 7])
    got = pr._noise.lane_step_keys(pr.solver._key, t, cfgs)
    key = jax.numpy.asarray(np.asarray(pr.solver._key, np.uint32))
    with jax.enable_x64(False):
        want = np.stack([np.stack([np.asarray(jax.random.fold_in(
            jax.random.fold_in(key, int(t[j, c])), int(cfgs[c])))
            for c in range(C)]) for j in range(2)])
    assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind,engine", [("threshold", "pallas"),
                                         ("remap", "pallas"),
                                         ("adam", "jax")])
def test_lockstep_strategies_and_adam(root, kind, engine):
    pr, rr = lockstep(solver_text(root, kind), engine)
    if kind == "remap":
        for g, v in pr.fault_states["remap_slots"].items():
            assert v.numpy().tobytes() == np.asarray(
                rr.fault_states["remap_slots"][g]).tobytes()


def test_checkpoints_cross_the_packages(root, plain):
    """Each package's checkpoint at iteration 4 restored into the other:
    the continued run ends as the never-stopped one did."""
    pr, rr = plain
    text = solver_text(root)
    got = port_runner(text)
    got.enable_self_healing(budget=6, max_retries=1, start_empty=True,
                            virtual_time=True)
    got.restore(str(root / "ref.ckpt.npz"))
    while not got.healing_complete():
        got.step(2, chunk=2)
    assert_reports_agree(got.config_report(), pr.config_report())
    for k, v in banks(pr).items():
        assert banks(got)[k].tobytes() == v.tobytes(), k
    with jax.enable_x64(False):
        back = ref_runner(text)
        back.enable_self_healing(budget=6, max_retries=1, start_empty=True,
                                 virtual_time=True)
        back.restore(str(root / "port.ckpt.npz"))
        while not back.healing_complete():
            back.step(2, chunk=2)
        assert_reports_agree(back.config_report(), rr.config_report())
    for k, v in banks(rr).items():
        assert banks(back)[k].tobytes() == v.tobytes(), k


def _contract_run(make, defer):
    """Configs 4 and 5 (the targets) and 6, 7 (others) submitted at once
    into a start_empty runner; with `defer` a refill policy seeds the
    others first and holds the targets back until iteration 2, so they
    land in other lanes in a later wave. Returns the report and, where
    the runner calls it, each target's rows at completion."""
    r = make()
    r.enable_self_healing(budget=4, max_retries=1, start_empty=True,
                          virtual_time=True)
    rows = {}
    if isinstance(r, TSweep):
        def keep(cfg, lane, result):
            rows[cfg] = {k: v[lane].numpy().tobytes()
                         for k, v in r._state_arrays().items()
                         if k != "quarantine"}
        r.on_lane_complete = keep
    assert r.submit_configs(WAVE1 + WAVE2) == [4, 5, 6, 7]
    if defer:
        def policy(entries, lane_map):
            later = [e for e in entries if e["config"] < 6]
            return [e for e in entries if e["config"] >= 6] + (
                later if r.iter >= 2 else [])
        r.set_refill_policy(policy)
    while not r.healing_complete():
        r.step(2, chunk=2)
    return r.config_report(), rows


def test_a_configs_result_does_not_depend_on_its_lane_or_wave(root):
    """The reproducibility contract, in the port and in the reference:
    configs 4 and 5 give the same loss, broken share and (port) rows bit
    for bit whether they land first in lanes 0-1 or later in lanes 2-3,
    with read noise drawn from each lane's step key (the packages draw
    the crossbar weights' noise apart: Philox against threefry)."""
    text = solver_text(root, "noise")
    first, rows_a = _contract_run(lambda: port_runner(text), False)
    later, rows_b = _contract_run(lambda: port_runner(text), True)
    assert [first["completed"][c]["lane"] for c in (4, 5)] == [0, 1]
    assert [later["completed"][c]["lane"] for c in (4, 5)] == [2, 3]
    assert later["completed"][4]["iter"] > first["completed"][4]["iter"]
    for cfg in (4, 5):
        for field in ("loss", "broken", "attempts"):
            assert first["completed"][cfg][field] == \
                later["completed"][cfg][field], (cfg, field)
        assert rows_a[cfg] == rows_b[cfg], cfg
    with jax.enable_x64(False):
        ref_a, _ = _contract_run(lambda: ref_runner(text), False)
        ref_b, _ = _contract_run(lambda: ref_runner(text), True)
    for cfg in (4, 5):
        assert ref_a["completed"][cfg]["lane"] != \
            ref_b["completed"][cfg]["lane"]
        for field in ("loss", "broken"):
            assert ref_a["completed"][cfg][field] == \
                ref_b["completed"][cfg][field], (cfg, field)


def test_virtual_time_refusals_are_the_references(root):
    """A host feed (no device dataset) and config_block raise the
    reference's ValueErrors; nothing is armed."""
    runners = [
        (port_sweep(cycling(batches(1)), C=2, pipeline_depth=0),
         "device-resident"),
        (port_runner(solver_text(root), config_block=2), "config_block")]
    for r, match in runners:
        with pytest.raises(ValueError, match=match) as exc:
            r.enable_self_healing(budget=4, virtual_time=True)
        assert r._healing is None and not r._virtual_time
        sp = pb.SolverParameter()
        if match == "config_block":
            text_format.Parse(solver_text(root), sp)
            with jax.enable_x64(False):
                ref = JSweep(JSolver(sp), C, engine="jax", pipeline_depth=0,
                             config_block=2)
            with pytest.raises(ValueError) as ref_exc:
                ref.enable_self_healing(budget=4, virtual_time=True)
            assert str(exc.value) == str(ref_exc.value)
