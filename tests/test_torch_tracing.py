"""The port's spans and counters (util/profiling's recorder) on the CPU: off
by default at the cost of a flag test, on inside recording(), trace() and a
torch.profiler session around EventPipeline.process, the pipeline's spans
and their parents and identifiers on the feeder's and the harvester's
threads, results bit-identical either way, and the spans' clock shared with
torch.profiler's."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clsim_tpu_torch.parallel import EventPipeline
from clsim_tpu_torch.util import profiling as P

from test_torch_pipeline import cascade, make_sim

torch.set_num_threads(1)

HARVESTER = "EventPipeline-harvester"


def fused_sim():
    """make_sim's detector through the fused call loop (its plain version
    on the CPU), small enough for a few launches a batch."""
    return make_sim(n_slots=256, backend="fused",
                    fused_opts=dict(iters_per_call=64))


def events():
    return [[cascade(5.0, 0.0)], [cascade(3.0, 50.0)], [cascade(4.0, -50.0)]]


def test_off_records_nothing_and_hands_out_the_shared_no_op():
    assert not P.recording_on()
    with P.recording() as rec:
        pass
    n0 = len(rec.spans())
    assert P.span("x", event=1) is P.NO_SPAN
    assert P.wait("site") is P.NO_SPAN
    with P.span("x") as sp:
        sp.set(batch=3)
        P.count("c", 5)
    assert rec.spans() == [] and n0 == 0
    assert [c for c in rec.counters() if c["name"] != "launches"] == []


def test_spans_nest_inherit_identifiers_and_count():
    with P.recording() as rec:
        with P.span("outer", event=7) as outer:
            outer.set(batch=2)
            with P.wait("site", 3):
                pass
            P.count("photons", 10, event=7)
            P.count("photons", 5, event=7)
    by_name = {s["name"]: s for s in rec.spans()}
    o, w = by_name["outer"], by_name["wait"]
    assert o["parent"] is None and w["parent"] == o["id"]
    assert (w["event"], w["batch"], w["site"]) == (7, 2, "site")
    assert o["start_ns"] <= w["start_ns"] <= w["end_ns"] <= o["end_ns"]
    assert rec.total("photons") == 15
    assert rec.total("waits", site="site") == 3
    assert rec.total("launches") == 0
    with P.recording() as rec2:
        pass
    assert rec2.spans() == [] and rec2.total("photons") == 0


def test_pipeline_spans_on_the_feeder_and_the_harvester():
    sim = fused_sim()
    pipe = EventPipeline(sim, max_in_flight=2)
    with P.recording() as rec:
        results = pipe.process(events(), seed=3)
    spans = rec.spans()
    by_id = {s["id"]: s for s in spans}
    feeder = threading.current_thread().name

    ev = [s for s in spans if s["name"] == "event"]
    assert sorted(s["event"] for s in ev) == [r.event_id for r in results]
    for s in ev:
        assert s["parent"] is None and s["thread"] == feeder
        kids = [c for c in spans if c["parent"] == s["id"]]
        assert sorted(c["name"] for c in kids if c["name"] != "wait") == [
            "assign", "convert"]
        assert all(c["event"] == s["event"] and c["thread"] == feeder
                   for c in kids)
    for r in results:
        assert rec.total("photons", event=r.event_id) == r.n_generated

    batches = [s for s in spans if s["name"] == "batch"]
    assert len(batches) == pipe.stats.as_dict()["NumKernelCalls"]
    assert sorted(s["batch"] for s in batches) == list(range(len(batches)))
    for b in batches:
        assert b["parent"] is None and b["thread"] == HARVESTER
        assert b["event"] in {r.event_id for r in results}
        under = [s for s in spans if s["id"] != b["id"]
                 and _root(s, by_id) is b]
        names = [s["name"] for s in under]
        assert names.count("plan") == 1 and "wait" in names
        assert all(s["thread"] == HARVESTER and s["batch"] == b["batch"]
                   and s["event"] == b["event"] for s in under)
        plan = next(s for s in under if s["name"] == "plan")
        assert plan["parent"] == b["id"]
        sites = {s["site"] for s in under if s["name"] == "wait"}
        assert {"check", "alive", "hist", "counts", "diagnostics"} <= sites
    waits = [s for s in spans if s["name"] == "queue_wait"]
    assert waits and all(s["thread"] == HARVESTER and s["parent"] is None
                         for s in waits)
    assert rec.total("waits", site="alive") >= len(batches)


def _root(s, by_id):
    while s["parent"] is not None:
        s = by_id[s["parent"]]
    return s


def test_results_are_bit_identical_with_recording_on_and_off():
    sim = fused_sim()
    off = EventPipeline(sim, max_in_flight=2).process(events(), seed=11)
    with P.recording():
        on = EventPipeline(sim, max_in_flight=2).process(events(), seed=11)
    for a, b in zip(off, on):
        assert np.array_equal(a.hist, b.hist)
        assert (a.n_generated, a.n_hits, a.weight_hits, a.per_particle) == (
            b.n_generated, b.n_hits, b.weight_hits, b.per_particle)


def test_process_records_under_a_profiler_on_its_thread_only():
    pipe = EventPipeline(fused_sim(), max_in_flight=2)
    evs = events()[:2]
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.process(evs, seed=5)
        n1 = len(P.RECORDER.spans("batch"))
        pipe.process(evs, seed=6)      # one profiler session: added to
        n2 = len(P.RECORDER.spans("batch"))
    assert n1 > 0 and n2 == 2 * n1
    assert any(s["thread"] == HARVESTER for s in P.RECORDER.spans())
    assert not P.recording_on()
    pipe.process(evs, seed=7)          # no profiler: nothing recorded
    assert len(P.RECORDER.spans("batch")) == n2
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.process(evs, seed=5)      # a new session starts cleared
    assert len(P.RECORDER.spans("batch")) == n1


def test_a_span_contains_its_operation_on_the_profilers_clock():
    a = torch.randn(256, 256)
    with P.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with P.span("around"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    base = prof.profiler.kineto_results.trace_start_ns()
    op = next(e for e in prof.events() if e.name == "aten::mm")
    s = rec.spans("around")[0]
    op_start = base + op.time_range.start * 1e3
    op_end = base + op.time_range.end * 1e3
    assert s["start_ns"] <= op_start <= op_end <= s["end_ns"]
    # the op lies inside the span's padding, not merely inside the span
    assert op_start - s["start_ns"] >= 1e6 and s["end_ns"] - op_end >= 1e6


def test_trace_writes_the_spans_beside_the_operations(tmp_path):
    pipe = EventPipeline(fused_sim(), max_in_flight=2)
    with P.trace(str(tmp_path)):
        pipe.process(events()[:1], seed=2)
    doc = json.loads((tmp_path / "trace.json").read_text())
    evs = doc["traceEvents"]
    spans = [e for e in evs if e.get("cat") == "clsim_span"]
    assert {"event", "convert", "assign", "batch", "plan", "wait"} <= {
        e["name"] for e in spans}
    assert len(spans) == len(P.RECORDER.spans())
    tracks = {e["args"]["name"] for e in evs if e.get("ph") == "M"
              and e.get("name") == "thread_name"
              and e["tid"] in {s["tid"] for s in spans}}
    assert f"spans {HARVESTER}" in tracks
    # the feeder's operators of the event (its steps' copies) lie inside
    # its span on the file's one timebase
    event = next(e for e in spans if e["name"] == "event")
    inside = [e for e in evs if e.get("cat") == "cpu_op"
              and event["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= event["ts"] + event["dur"]]
    assert inside
    batch = next(e for e in spans if e["name"] == "batch")
    assert batch["ts"] > event["ts"]


def test_counters_lose_no_update_across_threads():
    n_threads, n_adds = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording() as rec:
            def work():
                for _ in range(n_adds):
                    P.count("hits", 1)
                    with P.span("s"):
                        pass
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.total("hits") == n_threads * n_adds
    spans = rec.spans("s")
    assert len(spans) == n_threads * n_adds
    assert len({s["id"] for s in spans}) == len(spans)
    assert all(s["parent"] is None for s in spans)


@pytest.mark.parametrize("depth", [1, 2])
def test_every_event_and_batch_once_at_each_depth(depth):
    pipe = EventPipeline(fused_sim(), max_in_flight=depth)
    with P.recording() as rec:
        results = pipe.process(events(), seed=9)
    assert sorted(s["event"] for s in rec.spans("event")) == [
        r.event_id for r in results]
    assert len(rec.spans("batch")) == pipe.stats.as_dict()["NumKernelCalls"]
    assert bool(rec.spans("queue_wait")) == (depth > 1)


def test_the_call_loop_frees_the_first_state_and_steps_after_repacks(
        monkeypatch):
    """The planning span must not keep propagate_fused's first slot state
    and packed steps alive: a repack frees the steps by the next launch,
    and the state (updated in place) by the launch after it."""
    import weakref
    from clsim_tpu_torch.propagate import kernel as K
    first, seen, repacks = {}, [], [0]
    run, repack = K.run_fused_iterations, K.repack_slots

    def spy_run(state, steps_p, *a, **k):
        if not first:
            first.update(state=weakref.ref(state),
                         steps=weakref.ref(steps_p))
        seen.append((repacks[0], first["state"]() is not None,
                     first["steps"]() is not None))
        return run(state, steps_p, *a, **k)

    def spy_repack(*a, **k):
        repacks[0] += 1
        return repack(*a, **k)

    monkeypatch.setattr(K, "run_fused_iterations", spy_run)
    monkeypatch.setattr(K, "repack_slots", spy_repack)
    sim = make_sim(n_slots=256, backend="fused",
                   fused_opts=dict(iters_per_call=16))
    with P.recording():
        EventPipeline(sim, max_in_flight=1).process(events()[:1], seed=3)
    assert repacks[0] >= 2
    assert all(not steps for k, _, steps in seen if k >= 1)
    assert all(not state for k, state, _ in seen if k >= 2)


def test_back_to_back_profiler_sessions_share_a_recording_unless_cleared():
    """torch names no profiler session, so a session that follows another
    with no unprofiled process call between adds to its recording; the
    caller's RECORDER.clear() between them separates the two."""
    pipe = EventPipeline(fused_sim(), max_in_flight=2)
    evs = events()[:1]
    pipe.process(evs, seed=1)          # no profiler: the next one clears
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.process(evs, seed=5)
    n1 = len(P.RECORDER.spans("batch"))
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.process(evs, seed=5)
    assert n1 > 0 and len(P.RECORDER.spans("batch")) == 2 * n1
    P.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.process(evs, seed=5)
    assert len(P.RECORDER.spans("batch")) == n1


def test_recorded_spans_leave_the_garbage_collectors_tracking():
    """A finished span is a flat tuple of strings, ints and None, which a
    collection stops tracking, so a long recording does not grow the
    collector's work."""
    import gc
    with P.recording() as rec:
        with P.span("outer", event=3, batch=1):
            for _ in range(100):
                with P.wait("site"):
                    pass
    gc.collect()
    assert len(rec._spans) == 101
    assert not any(gc.is_tracked(t) for t in rec._spans)
