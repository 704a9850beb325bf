"""CPU tests of the per-layer metrics that read the program's own spans and
counters (benchmark/spans.py and seven readers under metrics/): each value
on synthetic spans, each None case, and one traced run of the toy cascades
cell through the harness.

    python -m pytest benchmark/test_bench_spans.py -q
"""

import math
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spans, toy  # noqa: E402

READERS = ("convert_span_ns_per_photon.stream",
           "assign_span_ns_per_photon.stream", "starved_ms_per_batch.stream",
           "plan_ms_per_batch.stream", "repack_ms_per_batch.stream",
           "harvester_host_ms_per_batch.stream", "waits_per_batch.stream")
STREAM = {"driver": "stream"}
MS = 1_000_000   # ns


def reader(name):
    return harness.load_module("metrics", name, [harness.HERE])


def sp(i, name, start_ms, end_ms, parent=None, thread="feeder", **ids):
    return dict(ids, id=i, name=name, parent=parent, thread=thread, tid=1,
                start_ns=int(start_ms * MS), end_ns=int(end_ms * MS))


def synthetic():
    """One event on the feeder; two batches on the harvester, the first
    with a wait inside its plan, an alive read, a repack and the
    read-back."""
    h = "EventPipeline-harvester"
    s = [sp(0, "event", 0, 10, event=0),
         sp(1, "convert", 1, 4, 0, event=0),
         sp(2, "assign", 5, 6, 0, event=0),
         sp(3, "wait", 7, 8, 0, event=0, site="steps_h2d"),
         sp(4, "queue_wait", 0, 2, thread=h),
         sp(5, "batch", 2, 12, thread=h, batch=0),
         sp(6, "plan", 2, 5, 5, thread=h, batch=0),
         sp(7, "wait", 3, 4, 6, thread=h, batch=0, site="to_numpy"),
         sp(8, "wait", 6, 9, 5, thread=h, batch=0, site="alive"),
         sp(9, "repack", 9, 10, 5, thread=h, batch=0),
         sp(10, "wait", 10, 11, 5, thread=h, batch=0, site="hist"),
         sp(11, "queue_wait", 12, 13, thread=h),
         sp(12, "batch", 13, 17, thread=h, batch=1),
         sp(13, "plan", 13, 14, 12, thread=h, batch=1),
         sp(14, "wait", 14, 16, 12, thread=h, batch=1, site="alive")]
    c = [dict(name="photons", n=1000, event=0),
         dict(name="waits", n=13, site="steps_h2d"),
         dict(name="waits", n=2, site="to_numpy"),
         dict(name="waits", n=2, site="alive"),
         dict(name="waits", n=1, site="hist"),
         dict(name="launches", n=2)]
    return s, c


EXPECTED = {
    "convert_span_ns_per_photon.stream": 3.0e6 / 1000,   # 3 ms, 1000 photons
    "assign_span_ns_per_photon.stream": 1.0e6 / 1000,
    "starved_ms_per_batch.stream": (2 + 1) / 2,
    "plan_ms_per_batch.stream": (3 + 1) / 2,
    "repack_ms_per_batch.stream": 1 / 2,
    # batches 10 + 4 ms less the waits under them (1 + 3 + 1 + 2 ms): the
    # feeder's copy wait is no batch's
    "harvester_host_ms_per_batch.stream": (14 - 7) / 2,
    "waits_per_batch.stream": 18 / 2,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_values_on_synthetic_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "recorded", synthetic)
    assert reader(name).read(STREAM) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_spans_or_stream(name, monkeypatch):
    r = reader(name)
    monkeypatch.setattr(spans, "recorded", synthetic)
    assert r.read({"driver": "other"}) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert r.read(STREAM) is None
    monkeypatch.setattr(spans, "recorded", lambda: ([], []))
    assert r.read(STREAM) is None


def test_readers_of_what_a_run_lacks(monkeypatch):
    """The engine path (no plan, no repack): plan and repack None; a call
    loop that never repacked: repack 0; no photons: the per-photon readers
    None."""
    s, c = synthetic()
    engine = [x for x in s if x["name"] not in ("plan", "repack")
              and x.get("site") != "to_numpy"]
    monkeypatch.setattr(spans, "recorded", lambda: (engine, c))
    assert reader("plan_ms_per_batch.stream").read(STREAM) is None
    assert reader("repack_ms_per_batch.stream").read(STREAM) is None
    assert reader("starved_ms_per_batch.stream").read(STREAM) == 1.5
    no_repack = [x for x in s if x["name"] != "repack"]
    monkeypatch.setattr(spans, "recorded", lambda: (no_repack, c))
    assert reader("repack_ms_per_batch.stream").read(STREAM) == 0.0
    no_photons = [x for x in c if x["name"] != "photons"]
    monkeypatch.setattr(spans, "recorded", lambda: (s, no_photons))
    assert reader("convert_span_ns_per_photon.stream").read(STREAM) is None
    assert reader("assign_span_ns_per_photon.stream").read(STREAM) is None


def test_a_program_without_a_recorder_reads_none(monkeypatch):
    from clsim_tpu_torch.util import profiling
    monkeypatch.delattr(profiling, "RECORDER")
    assert spans.recorded() is None
    for name in READERS:
        assert reader(name).read(STREAM) is None


def test_toy_cascades_traced_run_reports_the_span_metrics(tmp_path):
    """The toy cascades cell, traced, on the CPU: the feeder's and the
    harvester's metrics are read from the window's spans; the engine path
    has no call loop, so plan and repack are left out."""
    spec = toy.write_toy(tmp_path)
    argv = ["--workload", "toy-ice.toy-cascades", "--seed",
            str(2 ** 33 + 3), "--seconds", "0.1", "--trace", "1"]
    out = harness.run_cell(argv, time.perf_counter(), spec=spec,
                           roots=[tmp_path], device="cpu")
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    for name in READERS:
        if name.startswith(("plan_", "repack_")):
            assert name not in m
        else:
            assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    # one batch a toy event, each read back (hist) and counted (3 reads)
    assert m["waits_per_batch.stream"]["value"] >= 4
