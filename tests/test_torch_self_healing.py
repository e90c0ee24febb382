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
have. Within the port, the reference's own healing tests
(tests/test_self_healing.py): healthy lanes equal an uninjected run's
byte for byte, the retry policy, backoff, re-quarantine after a refill,
escalating recovery (from the reference's v4 directory too),
continuous batching, the v2 round trip, and the heal spans.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.observe import sink as jsink
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.observe import sink as tsink
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


# ---------------------------------------------------------------------------
# the reference's healing tests, on the port

def test_reclaim_refills_lane_and_healthy_lanes_are_untouched():
    """A poisoned config's lane is reclaimed at the boundary after the
    quarantine, the config retries there fresh, every config completes,
    and the healthy lanes equal an uninjected run's byte for byte,
    losses included."""
    clean = port_runner()
    loss_clean, _ = clean.step(8, chunk=2)
    sink = ListSink()
    r = port_runner(sink=sink)
    r.enable_self_healing(budget=8, max_retries=1)
    r.step(4, chunk=2)
    poison_port(r, 1)
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    assert rep["requested"] == [0, 1, 2] == sorted(rep["completed"])
    assert rep["failed"] == {} and rep["lane_map"] == [-1, -1, -1]
    assert rep["completed"][1]["attempts"] == 2
    assert rep["completed"][0]["attempts"] == 1
    for i in (0, 2):
        assert rep["completed"][i]["loss"] == float(loss_clean[i])
        assert lane_bytes(r, i) == lane_bytes(clean, i)
    events = retries(sink)
    assert [x["event"] for x in events] == ["requeue", "reseed"]
    assert events[0]["iter"] == events[1]["iter"]
    assert events[1]["recovery"] == "fresh"
    for rec in sink.records:
        assert tschema.validate_record(rec) == []


def test_metrics_and_health_records_carry_lane_map():
    sink = ListSink()
    r = port_runner(sink=sink, health_every=2)
    r.enable_self_healing(budget=4, extra_configs=EXTRA)
    r.step(4, chunk=2)
    maps = [x.get("lane_map") for x in sink.records if x.get("type") is None]
    assert maps and all(m == [0, 1, 2] for m in maps)
    r.step(2, chunk=2)
    health = [x for x in sink.records if x.get("type") == "health"]
    assert health[-1]["lane_map"] == [3, -1, -1]
    r.close()


def test_retry_budget_exhausts_to_failure_with_diagnosis():
    sink = ListSink()
    r = port_runner(sink=sink)
    r.enable_self_healing(budget=8, max_retries=0)
    poison_port(r, 2)
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    assert sorted(rep["completed"]) == [0, 1] and list(rep["failed"]) == [2]
    assert rep["failed"][2]["attempts"] == 1
    assert rep["failed"][2]["diagnosis"] == "non-finite loss at iteration 1"
    assert [x["event"] for x in retries(sink)] == ["failed"]


def test_retry_backoff_delays_reseed():
    sink = ListSink()
    r = port_runner(sink=sink)
    r.enable_self_healing(budget=6, max_retries=1, backoff_iters=4)
    poison_port(r, 0)
    while not r.healing_complete():
        r.step(4, chunk=2)
    requeue, reseed = retries(sink)
    assert requeue["eligible_iter"] == requeue["iter"] + 4
    assert reseed["iter"] >= requeue["eligible_iter"]
    assert r.config_report()["completed"][0]["attempts"] == 2


def test_same_lane_requarantines_after_refill():
    """A re-seeded lane that diverges again is announced and reclaimed
    again (depth 2: the refill drains the consumer first)."""
    r = port_runner(depth=2)
    r.enable_self_healing(budget=12, max_retries=2, backoff_iters=2)
    poison_port(r, 1)
    r.step(4, chunk=2)
    while not r.healing_complete() and \
            r.config_report()["active"].get(1, {}).get("attempt") != 2:
        r.step(2, chunk=2)
    active = r.config_report()["active"]
    assert active[1]["attempt"] == 2
    poison_port(r, active[1]["lane"])
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    done = {**rep["completed"], **rep["failed"]}
    assert done[1]["attempts"] == 3 and sorted(done) == [0, 1, 2]
    r.close()


def test_fresh_reseed_is_an_independent_draw():
    r = port_runner()
    first = {k: v[1].clone() for k, v in r.fault_states["life_q"].items()}
    r.enable_self_healing(budget=8, max_retries=1)
    poison_port(r, 1)
    r.step(2, chunk=2)
    assert r.config_report()["active"][1]["attempt"] == 2
    assert any(not torch.equal(first[k], r.fault_states["life_q"][k][1])
               for k in first)
    for layer, vals in r.solver.params.items():
        for slot, v in enumerate(vals):
            if v is not None:
                assert torch.equal(r.params[layer][slot][1], v)


def test_escalating_recovery_restores_checkpoint_slice(tmp_path):
    """The first retry restores the config's checkpointed slice: the
    lane's rows after the refill are the file's, its progress the
    checkpoint's iteration."""
    sink = ListSink()
    r = port_runner(sink=sink)
    r.enable_self_healing(budget=12, max_retries=1)
    r.step(4, chunk=2)
    path = r.checkpoint(str(tmp_path / "good.ckpt.npz"))
    poison_port(r, 1)
    r.step(2, chunk=2)          # the refill is the chunk's last act
    reseed = retries(sink)[-1]
    assert reseed["event"] == "reseed"
    assert reseed["recovery"] == "checkpoint"
    assert r.config_report()["active"][1]["done"] == 4
    data = read_npz(path)
    now = lane_bytes(r, 1)
    assert now.keys() == set(data) - {"quarantine", "__meta__"}
    for name, row in now.items():
        assert row == data[name][1].tobytes(), name
    while not r.healing_complete():
        r.step(4, chunk=2)
    assert r.config_report()["completed"][1]["attempts"] == 2


def test_escalating_recovery_reads_the_reference_v4_directory(tmp_path):
    """A reference runner writes the v4 distributed directory; restored
    into the port, a retried config re-seeds from its slice there, and
    the lane's rows after the refill are the directory's."""
    with jax.enable_x64(False):
        ref = ref_runner()
        ref.enable_self_healing(budget=40, max_retries=1)
        ref.step(4, chunk=2)
        ckpt = ref.checkpoint(str(tmp_path / "h.ckpt"), distributed=True)
        ref.close()
    assert os.path.isdir(ckpt)
    sink = ListSink()
    r = port_runner(sink=sink, start=4)
    r.enable_self_healing(budget=40, max_retries=1)
    r.restore(ckpt)
    poison_port(r, 1)
    r.step(2, chunk=2)
    reseed = retries(sink)[-1]
    assert (reseed["event"], reseed["recovery"]) == ("reseed", "checkpoint")
    assert r.config_report()["active"][1]["done"] == 4
    data, _, _ = TSweep._load_checkpoint_data(ckpt)
    now = lane_bytes(r, 1)
    assert now.keys() == set(data) - {"quarantine"}
    for name, row in now.items():
        assert row == data[name][1].tobytes(), name


def test_extra_configs_pack_lanes_continuous_batching():
    r = port_runner(C=2)
    r.enable_self_healing(budget=4, extra_configs=EXTRA)
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    assert sorted(rep["completed"]) == [0, 1, 2]
    assert rep["completed"][2]["attempts"] == 1
    assert rep["completed"][2]["iter"] > rep["completed"][0]["iter"]


def test_start_empty_submissions_policy_and_completion_hook():
    """Service mode: every lane idle until a submission; the refill
    policy orders the queue, `on_lane_complete` sees the lane's rows
    before it is freed, a per-submission budget holds, and a spec past
    the int16 banks is refused."""
    r = port_runner(C=2)
    r.enable_self_healing(budget=4, start_empty=True)
    assert r.quarantine.tolist() == [True, True]
    assert r.config_report()["requested"] == []
    with pytest.raises(ValueError, match="int16 lifetime banks"):
        r.submit_configs([{"mean": 1e8, "std": 3e7}])
    r._healing.pending.clear()
    seen = []
    r.set_refill_policy(lambda entries, lane_map: sorted(
        entries, key=lambda e: -e["config"]))
    r.on_lane_complete = lambda cfg, lane, res: seen.append(
        (cfg, lane, res["status"], bool(r.quarantine[lane])))
    ids = r.submit_configs([{"mean": 260.0, "std": 30.0}] * 3, budget=2)
    assert ids == [3, 4, 5]
    r.step(1)
    assert r.config_report()["lane_map"] == [5, 4]
    while not r.healing_complete():
        r.step(2, chunk=2)
    rep = r.config_report()
    assert {c: v["iter"] for c, v in rep["completed"].items()} == \
        {5: 2, 4: 2, 3: 4}
    assert [s[0] for s in seen] == [5, 4, 3]
    assert all(status == "completed" and not frozen
               for _, _, status, frozen in seen)


@pytest.mark.parametrize("depth", [0, 2])
def test_checkpoint_v2_roundtrips_healing_state(tmp_path, depth):
    a = port_runner(depth=depth)
    a.enable_self_healing(budget=8, max_retries=1, backoff_iters=2)
    poison_port(a, 1)
    a.step(2, chunk=2)
    ckpt = a.checkpoint(str(tmp_path / "h.ckpt.npz"))
    before = a._healing.to_json()
    a.close()
    b = port_runner(depth=depth, start=2)
    b.enable_self_healing(budget=8, max_retries=1, backoff_iters=2)
    b.restore(ckpt)
    assert b._healing.to_json() == before
    while not b.healing_complete():
        b.step(4, chunk=2)
    rep = b.config_report()
    assert sorted(rep["completed"]) == [0, 1, 2]
    assert rep["completed"][1]["attempts"] == 2
    b.close()


def test_restore_rearms_pending_reclamation(tmp_path):
    """A checkpoint between the announcement and the reclamation: the
    restored runner reclaims the frozen lane at its next boundary."""
    a = port_runner(depth=0)
    a.enable_self_healing(budget=8, max_retries=1)
    poison_port(a, 0)
    a.step(2, chunk=2)
    ckpt = a.checkpoint(str(tmp_path / "mid.ckpt.npz"))
    # the file as a checkpoint between the announcement and the
    # reclamation would hold it: lane 0 on its first attempt, frozen
    meta = meta_of(ckpt)
    meta["healing"]["lane_attempt"][0] = 1
    meta["healing"]["lane_done"][0] = 2
    meta["healing"]["quar_diag"] = {"0": {"iter": 1, "where": ""}}
    meta["quarantined"] = [0]
    data = read_npz(ckpt)
    data["quarantine"][0] = True
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(ckpt, **data)
    b = port_runner(depth=0, start=2)
    b.enable_self_healing(budget=8, max_retries=1)
    b.restore(ckpt)
    assert b._reclaim_flag.is_set()
    while not b.healing_complete():
        b.step(4, chunk=2)
    rep = b.config_report()
    assert sorted(rep["completed"]) == [0, 1, 2]
    assert rep["completed"][0]["attempts"] == 2


def test_restore_healing_checkpoint_needs_healing_enabled(tmp_path):
    a = port_runner()
    a.enable_self_healing(budget=8)
    a.step(2, chunk=2)
    ckpt = a.checkpoint(str(tmp_path / "h2.ckpt.npz"))
    b = port_runner()
    with pytest.raises(ValueError, match="enable_self_healing"):
        b.restore(ckpt)
    assert b.iter == 0


def test_v1_checkpoint_upgrades_with_identity_lane_map(tmp_path):
    a = port_runner()
    a.step(4, chunk=2)
    ckpt = a.checkpoint(str(tmp_path / "v1.ckpt.npz"))
    data = read_npz(ckpt)
    meta = {k: v for k, v in meta_of(ckpt).items()
            if k not in ("lane_map", "lane_done", "healing", "fault_format",
                         "pack_spec", "fault_process")}
    meta["version"] = 1
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    v1 = str(tmp_path / "v1_downgraded.ckpt.npz")
    np.savez(v1, **data)
    b = port_runner(start=4)
    b.restore(v1)
    assert b.iter == 4
    c = port_runner(start=4)
    c.enable_self_healing(budget=8, extra_configs=EXTRA)
    c.restore(v1)
    h = c._healing
    assert h.lane_cfg.tolist() == [0, 1, 2]
    assert h.lane_done.tolist() == [4, 4, 4]
    assert h.pending == [{"config": 3, "attempt": 1, "eligible_iter": 4}]
    c.step(4, chunk=2)
    assert 3 in c.config_report()["active"]


def test_blocked_healing_equals_unblocked():
    """Under config_block a refill writes the resident rows the blocks
    slice: the blocked run's ledger, banks and params equal the
    unblocked run's bit for bit."""
    runs = []
    for block in (0, 1):
        sink = ListSink()
        r = port_runner(C=2, sink=sink, config_block=block)
        r.enable_self_healing(budget=4, max_retries=1)
        r.step(2, chunk=2)
        poison_port(r, 1)
        while not r.healing_complete():
            r.step(2, chunk=2)
        runs.append((r, strip(retries(sink))))
    (a, ra), (b, rb) = runs
    assert a.config_report() == b.config_report()
    assert ra == rb and [x["event"] for x in ra] == ["requeue", "reseed"]
    for lane in (0, 1):
        assert lane_bytes(a, lane) == lane_bytes(b, lane)


def test_heal_spans_and_instants(tmp_path):
    sink = ListSink()
    r = port_runner(depth=2, sink=sink)
    r.enable_tracing(profile_dir=str(tmp_path / "prof"))
    r.enable_self_healing(budget=8, max_retries=1)
    poison_port(r, 1)
    while not r.healing_complete():
        r.step(4, chunk=2)
    r.close()
    spans = [x for x in sink.records if x.get("type") == "span"]
    names = {x["name"] for x in spans}
    assert {"dispatch", "consume", "drain", "heal", "quarantine",
            "requeue", "reseed"} <= names
    heal = [x for x in spans if x["name"] == "heal"]
    assert sum(x["args"]["refilled"] for x in heal) == 1
    assert sum(x["args"]["harvested"] for x in heal) == 3
    for rec in spans:
        assert tschema.validate_record(rec) == []


def test_retry_lines_and_caffe_log_equal_the_reference(tmp_path):
    recs = [tsink.make_retry_record(6, 1, 1, 1, "requeue", eligible_iter=8),
            tsink.make_retry_record(8, 1, 2, 2, "reseed",
                                    recovery="checkpoint"),
            tsink.make_retry_record(10, 1, 2, 2, "failed",
                                    diagnosis="non-finite loss at "
                                    "iteration 8")]
    for rec in recs:
        want = jsink.make_retry_record(
            rec["iter"], rec["config"], rec["lane"], rec["attempt"],
            rec["event"], recovery=rec.get("recovery"),
            eligible_iter=rec.get("eligible_iter"),
            diagnosis=rec.get("diagnosis"))
        assert strip([rec]) == strip([want])
        assert tsink.retry_line(rec) == jsink.retry_line(want)
        assert tschema.validate_record(rec) == []
    log = tsink.CaffeLogSink(str(tmp_path / "caffe.log"))
    for rec in recs:
        log.write(rec)
    log.close()
    text = (tmp_path / "caffe.log").read_text()
    for rec in recs:
        assert tsink.retry_line(rec) in text
