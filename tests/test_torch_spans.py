"""The port's span tracing (observe/spans.py, observe/trace.py and the
SweepRunner's enable_tracing / write_trace) against the reference
package's.

Held: one event sequence driven through both packages' SpanTracer gives
the same span records and the same Chrome-trace events (apart from the
wall-clock and measured-duration fields; a caller-timed span's duration
exactly); make_span_record, span_line, phase_breakdown,
bench_phase_breakdown and merge_chrome_traces give the reference's
output for the same input. On the sweep of tests/test_torch_sweep.py at
depth 2, tracing on changes no result byte (losses, outputs, state,
non-span records); the drained span records validate under both
schemas and name the reference's spans (dispatch, submit_wait, consume,
drain, checkpoint, restore, save_faults); write_trace writes Chrome JSON
with the dispatcher and chunk-consumer tracks; observe.trace writes a
torch.profiler Chrome trace under its directory."""
import json
import os

import pytest

from rram_caffe_simulation_tpu.observe import schema as jschema
from rram_caffe_simulation_tpu.observe import spans as jspans
from rram_caffe_simulation_tpu_torch.observe import schema as tschema
from rram_caffe_simulation_tpu_torch.observe import spans as tspans
from rram_caffe_simulation_tpu_torch.observe import trace as ttrace

from test_torch_async_pipeline import ListSink, metrics_runner, strip
from test_torch_checkpoint import assert_same_state, state_of

MEASURED = ("wall_time", "dur_s")


def drive(mod):
    """One event sequence on a tracer of `mod`: a timed span, a
    caller-timed span, an instant, an async pair, a context span."""
    tr = mod.SpanTracer(capacity=64)
    tr.set_thread_role("dispatcher")
    tok = tr.begin("dispatch", iteration=3, args={"k": 2})
    tr.end(tok, args={"done": 1})
    tr.complete("submit_wait", 0.25, iteration=3, args={"k": 2})
    tr.instant("quarantine", cat="healing", iteration=4,
               args={"lane": 1, "config": 1})
    tr.async_begin("request", "r1", iteration=4)
    tr.async_end("request", "r1", iteration=5, args={"status": "ok"})
    with tr.span("checkpoint", iteration=6, args={"path": "x.npz"}):
        pass
    return tr


def measured_off(rec):
    out = {k: v for k, v in rec.items() if k not in MEASURED}
    if rec["name"] == "submit_wait":
        out["dur_s"] = rec["dur_s"]          # caller-timed: exact
    return out


def test_tracer_records_equal_the_reference():
    t, j = drive(tspans), drive(jspans)
    got, want = t.drain_records(), j.drain_records()
    assert [measured_off(r) for r in got] == [measured_off(r) for r in want]
    assert [r["name"] for r in got] == ["dispatch", "submit_wait",
                                        "quarantine", "request",
                                        "checkpoint"]
    for r in got:
        assert tschema.validate_record(r) == jschema.validate_record(r) \
            == []
    assert t.drain_records() == [] == j.drain_records()   # cursor
    assert t.dropped == j.dropped == 0


def test_chrome_events_equal_the_reference():
    def shape(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in events]
    assert shape(drive(tspans).chrome_events()) == \
        shape(drive(jspans).chrome_events())


def test_ring_overflow_counts_drops_like_the_reference():
    out = []
    for mod in (tspans, jspans):
        tr = mod.SpanTracer(capacity=3)
        for i in range(5):
            tr.complete("x", 0.1, iteration=i)
        out.append((tr.dropped, [r["iter"] for r in tr.drain_records()]))
    assert out[0] == out[1] == (2, [2, 3, 4])


EVENTS = [
    {"kind": "span", "name": "dispatch", "cat": "sweep", "t": 10.5,
     "dur": 0.125, "thread": "dispatcher", "iter": 4, "args": {"k": 2}},
    {"kind": "span", "name": "consume", "cat": "host", "t": 11.0,
     "dur": 0.0625, "thread": "chunk-consumer", "iter": 0, "args": None},
    {"kind": "instant", "name": "quarantine", "cat": "healing", "t": 12.0,
     "dur": 0.0, "thread": "chunk-consumer", "iter": 7,
     "args": {"lane": 2}},
    {"kind": "span", "name": "request", "cat": "request", "t": 1.0,
     "dur": 3.0, "thread": "main", "iter": 1, "id": "r9", "args": None},
]


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_span_record_and_line_equal_the_reference(i):
    rec = tspans.make_span_record(EVENTS[i], process_index=1)
    assert rec == jspans.make_span_record(EVENTS[i], process_index=1)
    assert tspans.span_line(rec) == jspans.span_line(rec)


def test_breakdowns_and_merge_equal_the_reference(tmp_path):
    events = EVENTS + [
        {"kind": "span", "name": n, "cat": "sweep", "t": 1.0, "dur": d,
         "thread": th, "iter": 0}
        for n, d, th in (("submit_wait", 0.5, "dispatcher"),
                         ("drain", 0.25, "dispatcher"),
                         ("consume", 0.125, "dispatcher"),
                         ("checkpoint", 1.0, "dispatcher"),
                         ("save_faults", 0.5, "dispatcher"),
                         ("write", 0.25, "snapshot-writer"))]
    recs = [tspans.make_span_record(e) for e in events]
    for src in (events, recs):
        assert tspans.phase_breakdown(src) == jspans.phase_breakdown(src)
        assert tspans.phase_breakdown(src, by_thread=True) == \
            jspans.phase_breakdown(src, by_thread=True)
        assert tspans.bench_phase_breakdown(src) == \
            jspans.bench_phase_breakdown(src)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    drive(tspans).write_chrome_trace(a)
    drive(jspans).write_chrome_trace(b)
    got = json.load(open(tspans.merge_chrome_traces(
        [a, b], str(tmp_path / "t.json"))))
    want = json.load(open(jspans.merge_chrome_traces(
        [a, b], str(tmp_path / "j.json"))))
    assert got == want


def traced_run(tmp_path, trace: bool):
    sink = ListSink()
    r = metrics_runner(2, sink)
    r.solver.param.snapshot_prefix = str(tmp_path / "snap")
    if trace:
        r.enable_tracing(profile_dir=str(tmp_path / "prof"))
    out = [r.step(2, chunk=2) for _ in range(2)]
    path = r.checkpoint(str(tmp_path / "c.npz"))
    r.save_fault_states(str(tmp_path / "f.npz"), background=False)
    r.restore(path)
    out.append(r.step(1))
    r.close()
    return r, out, sink.records


def test_tracing_changes_no_result_byte(tmp_path):
    plain, p_out, p_recs = traced_run(tmp_path / "a", False)
    traced, t_out, t_recs = traced_run(tmp_path / "b", True)
    for (la, oa), (lb, ob) in zip(p_out, t_out):
        assert la.tobytes() == lb.tobytes()
        assert oa["loss"].tobytes() == ob["loss"].tobytes()
    assert_same_state(state_of(plain), state_of(traced))
    assert strip(p_recs) == strip([x for x in t_recs
                                   if x.get("type") != "span"])
    assert open(tmp_path / "a" / "f.npz", "rb").read() == \
        open(tmp_path / "b" / "f.npz", "rb").read()

    spans = [x for x in t_recs if x.get("type") == "span"]
    names = {x["name"] for x in spans}
    assert {"dispatch", "submit_wait", "consume", "drain", "checkpoint",
            "restore", "save_faults"} <= names
    for x in spans:
        assert tschema.validate_record(x) == jschema.validate_record(x) \
            == []
    consume = {x["thread"] for x in spans if x["name"] == "consume"}
    assert consume == {"chunk-consumer"}
    assert {x["thread"] for x in spans if x["name"] == "dispatch"} == \
        {"dispatcher"}
    trace = json.load(open(tmp_path / "b" / "prof" /
                           "spans.p0.trace.json"))
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"dispatcher", "chunk-consumer"} <= tracks
    assert plain.write_trace() is None


def test_profiler_context_writes_a_chrome_trace(tmp_path):
    import torch
    with ttrace.trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.load(open(tmp_path / "prof" / files[0]))
    with ttrace.trace(None) as off:
        assert off is None
