"""The reference's own healing tests (tests/test_self_healing.py) on the
port's self-healing sweep (parallel/sweep.py), with the small conv net,
lanes and poison of tests/test_torch_self_healing.py: healthy lanes
equal an uninjected run's byte for byte, the retry policy, backoff,
re-quarantine after a refill, escalating recovery (from the reference's
v4 directory too), continuous batching, start_empty submissions with a
refill policy and a completion hook, the v2 round trip, blocked equal to
unblocked, the heal spans and the retry lines."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from rram_caffe_simulation_tpu.observe import sink as jsink
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.observe import sink as tsink
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep

from test_torch_checkpoint import read_npz
from test_torch_self_healing import (EXTRA, ListSink, lane_bytes, meta_of,
                                     poison_port, port_runner, ref_runner,
                                     retries, strip)


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
