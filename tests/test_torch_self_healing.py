"""The port's self-healing sweep (parallel/sweep.py enable_self_healing,
submit_configs, set_refill_policy, healing_complete, config_report,
on_lane_complete) against the reference package's.

The small conv net of tests/test_torch_sweep.py at C = 3 lanes, lifetimes
N(250, 30) to N(450, 250), the ternary crossbar read, packed banks; NaN
written into one lane's ip2 weights stands for a diverging config.

In lockstep with the reference runner (engine "jax", depth 0, one seed,
the same poison): a sweep that quarantines, requeues with backoff,
re-seeds fresh and from a checkpoint slice, fails a config for good and
seeds a queued extra config. Equal but `wall_time`: the retry records,
the printed retry and quarantine lines, the records' lane maps, the
checkpoint's meta (healing block included) and `config_report()`, whose
losses agree within 1e-5 relative (the packages sum convolutions and
products in other orders, tests/test_torch_checkpoint.py) and whose
broken shares agree as float32 (the reference's census is float32 with
x64 off, the port's the float64 of the same count). Fault banks are
identical bit for bit, `_fresh_rows` too. A healing checkpoint either
package writes restores in the other and the run goes on as it would
have. The reference's own healing tests, on the port, are in
tests/test_torch_self_healing_port.py.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep

from test_torch_checkpoint import feed_from, read_npz, ref_solver
from test_torch_sweep import MEANS, STDS, port_solver

REL = 1e-5
TIMING = ("wall_time", "step_latency_s", "iters_per_s")
EXTRA = [{"mean": 300.0, "std": 20.0}]


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def port_runner(depth=0, C=3, sink=None, start=0, **kw):
    s = port_solver(feed_from(start))
    if sink is not None:
        s.enable_metrics(sink)
    return TSweep(s, C, means=MEANS[:C], stds=STDS[:C], packed_state=True,
                  dtype_policy="ternary", device="cpu",
                  pipeline_depth=depth, **kw)


def ref_runner(depth=0, C=3, sink=None, start=0):
    s = ref_solver(feed_from(start))
    if sink is not None:
        s.enable_metrics(sink)
    return JSweep(s, C, means=MEANS[:C], stds=STDS[:C], engine="jax",
                  packed_state=True, dtype_policy="ternary",
                  pipeline_depth=depth)


def poison_port(r, lane):
    with torch.no_grad():
        r.params["ip2"][0][lane].view(-1)[0] = float("nan")


def poison_ref(r, lane):
    orig = r.params["ip2"][0]
    w = np.array(orig)
    w[lane].flat[0] = np.nan
    r.params["ip2"][0] = jax.device_put(jnp.asarray(w), orig.sharding)


def strip(records):
    return [{k: v for k, v in r.items() if k not in TIMING}
            for r in records]


def retries(sink):
    return [r for r in sink.records if r.get("type") == "retry"]


def healing_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Sweep retry", "Sweep quarantine"))]


def lane_bytes(r, lane):
    return {k: v[lane].detach().numpy().tobytes()
            for k, v in r._state_arrays().items() if k != "quarantine"}


def meta_of(path):
    return json.loads(bytes(bytearray(read_npz(path)["__meta__"])).decode())


def banks(r):
    if isinstance(r, TSweep):
        return {n: v.numpy() for n, v in
                tengine.iter_state_leaves(r.fault_states)}
    from rram_caffe_simulation_tpu.fault import engine as jengine
    return {n: np.asarray(v) for n, v in
            jengine.iter_state_leaves(r.fault_states)}


def assert_reports_agree(got, want):
    """config_report()s equal but the losses (within REL) and the broken
    shares (as float32)."""
    def split(rep):
        rep = json.loads(json.dumps(rep))
        nums = {}
        for kind in ("completed", "failed"):
            for cfg, entry in rep[kind].items():
                nums[(kind, cfg)] = (entry.pop("loss", None),
                                     entry.pop("broken", None))
        return rep, nums
    g, gn = split(got)
    w, wn = split(want)
    assert g == w
    assert gn.keys() == wn.keys()
    for key, (gl, gb) in gn.items():
        wl, wb = wn[key]
        if wl is None:
            assert gl is None, key
        else:
            np.testing.assert_allclose(gl, wl, rtol=REL, err_msg=str(key))
        if wb is not None:
            assert np.float32(gb) == np.float32(wb), key


# ---------------------------------------------------------------------------
# lockstep with the reference

def scenario(r, poison, ckpt, resume=None):
    """The lockstep sweep, or its second half after a restore of `ckpt`
    (`resume`, a runner at iteration 4): config 0 is poisoned at the
    start (requeued with backoff 2; the extra config 3 takes its lane),
    a checkpoint at iteration 4, config 1 poisoned (requeued; config 0
    re-seeded fresh, since the checkpoint holds no good slice of it),
    config 1 re-seeded from the checkpoint at 8, poisoned again and
    failed for good; then on to completion."""
    if resume is None:
        r.enable_self_healing(budget=8, max_retries=1, backoff_iters=2,
                              extra_configs=EXTRA)
        poison(r, 0)
        r.step(2, chunk=2)
        r.step(2, chunk=2)
        r.checkpoint(ckpt)
    else:
        r = resume
    poison(r, r.config_report()["active"][1]["lane"])
    r.step(4, chunk=2)
    active = r.config_report()["active"]
    assert active[1]["attempt"] == 2
    poison(r, active[1]["lane"])
    while not r.healing_complete():
        r.step(4, chunk=2)
    return r


def run_port(tmp, resume_from=None):
    sink = ListSink()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if resume_from is None:
            r = scenario(port_runner(sink=sink), poison_port,
                         str(tmp / "port.ckpt.npz"))
        else:
            r = port_runner(sink=sink, start=4)
            r.enable_self_healing(budget=8, max_retries=1, backoff_iters=2,
                                  extra_configs=EXTRA)
            r.restore(resume_from)
            r = scenario(None, poison_port, None, resume=r)
    return r, sink, out.getvalue()


def run_ref(tmp, resume_from=None):
    sink = ListSink()
    out = io.StringIO()
    with jax.enable_x64(False), contextlib.redirect_stdout(out):
        if resume_from is None:
            r = scenario(ref_runner(sink=sink), poison_ref,
                         str(tmp / "ref.ckpt.npz"))
        else:
            r = ref_runner(sink=sink, start=4)
            r._feed = feed_from(4)
            r.enable_self_healing(budget=8, max_retries=1, backoff_iters=2,
                                  extra_configs=EXTRA)
            r.restore(resume_from)
            r = scenario(None, poison_ref, None, resume=r)
        rows = {key: r._fresh_rows(*key) for key in ((1, 3), (3, 1))}
    return r, sink, out.getvalue(), rows


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lockstep")
    port = run_port(tmp)
    ref = run_ref(tmp)
    return {"tmp": tmp, "port": port, "ref": ref}


def test_lockstep_reports_records_and_lines(lockstep):
    pr, psink, pout = lockstep["port"]
    rr, rsink, rout, _ = lockstep["ref"]
    rep = pr.config_report()
    assert_reports_agree(rep, rr.config_report())
    assert sorted(rep["completed"]) == [0, 2, 3]
    assert rep["failed"][1]["attempts"] == 2
    assert rep["failed"][1]["diagnosis"] == \
        "non-finite loss at iteration 9"
    assert rep["completed"][0]["attempts"] == 2
    assert strip(retries(psink)) == strip(retries(rsink))
    assert [(x["event"], x.get("recovery")) for x in retries(psink)] == [
        ("requeue", None), ("reseed", "fresh"), ("requeue", None),
        ("reseed", "fresh"), ("reseed", "checkpoint"), ("failed", None)]
    assert healing_lines(pout) == healing_lines(rout)
    assert len(healing_lines(pout)) == 9
    maps = [(x["iter"], x.get("lane_map"), x.get("quarantine"))
            for x in psink.records if x.get("type") is None]
    assert maps == [(x["iter"], x.get("lane_map"), x.get("quarantine"))
                    for x in rsink.records if x.get("type") is None]
    for rec in psink.records:
        assert tschema.validate_record(rec) == [], rec


def test_lockstep_banks_params_and_fresh_rows(lockstep):
    pr = lockstep["port"][0]
    rr, _, _, ref_rows = lockstep["ref"]
    assert pr.iter == rr.iter == 14
    want = banks(rr)
    got = banks(pr)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    for layer, vals in pr.params.items():
        for slot, v in enumerate(vals):
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(rr.params[layer][slot]),
                                       rtol=1e-4, atol=1e-5)
    assert pr.quarantined().tolist() == \
        np.flatnonzero(np.asarray(rr.quarantine)).tolist()
    for key, want_rows in ref_rows.items():
        rows = pr._fresh_rows(*key)
        assert rows.keys() == want_rows.keys()
        for name, v in want_rows.items():
            assert rows[name].dtype == v.dtype, name
            assert rows[name].tobytes() == np.asarray(v).tobytes(), \
                (key, name)


def test_lockstep_checkpoint_meta_equals_the_reference(lockstep):
    tmp = lockstep["tmp"]
    got = meta_of(str(tmp / "port.ckpt.npz"))
    want = meta_of(str(tmp / "ref.ckpt.npz"))
    assert got == want
    assert got["lane_map"] == [3, 1, 2]
    assert got["healing"]["cfg_specs"] == {"3": EXTRA[0]}
    assert got["healing"]["pending"] == [
        {"config": 0, "attempt": 2, "eligible_iter": 4}]


def test_healing_checkpoint_crosses_the_packages(lockstep, tmp_path):
    """The reference's checkpoint at iteration 4 restored into the port
    and the port's into the reference: each run goes on to the ledger,
    records and banks of the run that never stopped."""
    tmp = lockstep["tmp"]
    pr, psink, _ = lockstep["port"]
    rr, rsink, _, _ = lockstep["ref"]
    got, sink, _ = run_port(tmp_path, resume_from=str(tmp / "ref.ckpt.npz"))
    assert_reports_agree(got.config_report(), pr.config_report())
    assert strip(retries(sink)) == strip(retries(psink))[2:]
    for k, v in banks(pr).items():
        assert banks(got)[k].tobytes() == v.tobytes(), k
    back, rsink2, _, _ = run_ref(tmp_path,
                                 resume_from=str(tmp / "port.ckpt.npz"))
    assert_reports_agree(back.config_report(), rr.config_report())
    assert strip(retries(rsink2)) == strip(retries(rsink))[2:]
    for k, v in banks(rr).items():
        assert banks(back)[k].tobytes() == v.tobytes(), k
