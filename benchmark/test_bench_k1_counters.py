"""CPU tests of k1_candidates_per_iter.stream, the reader of the program's
K1 cull counters: its value on a synthetic recording, None where the run
is no stream, the program keeps no recorder or counts neither counter,
and its absence from the toy cascades cell's traced run (the engine path
launches no K1).

    python -m pytest benchmark/test_bench_k1_counters.py -q
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spans, toy  # noqa: E402

NAME = "k1_candidates_per_iter.stream"
STREAM = {"driver": "stream"}


def reader():
    return harness.load_module("metrics", NAME, [harness.HERE])


def recording(*counters):
    """A window of two batches whose call loops counted `counters`."""
    s = [dict(id=i, name="batch", parent=None, thread="h", tid=1,
              start_ns=i * 10, end_ns=i * 10 + 5, batch=i) for i in (0, 1)]
    c = [dict(name="waits", n=4, site="totals"), dict(name="launches", n=2)]
    return lambda: (s, c + [dict(name=n, n=v) for n, v in counters])


@pytest.mark.parametrize("cand,work", [(1200.0, 2400.0), (66000.0, 3000.0),
                                       (0.0, 500.0)])
def test_candidates_a_slot_iteration(cand, work, monkeypatch):
    monkeypatch.setattr(spans, "recorded", recording(
        ("k1_candidates", cand / 2), ("k1_slot_iterations", work / 2),
        ("k1_candidates", cand / 2), ("k1_slot_iterations", work / 2)))
    assert reader().read(STREAM) == pytest.approx(cand / work)


def test_none_without_a_stream_a_recorder_or_the_counters(monkeypatch):
    r = reader()
    monkeypatch.setattr(spans, "recorded", recording(
        ("k1_candidates", 10.0), ("k1_slot_iterations", 5.0)))
    assert r.read({"driver": "fit"}) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert r.read(STREAM) is None
    monkeypatch.setattr(spans, "recorded", recording())
    assert r.read(STREAM) is None
    monkeypatch.setattr(spans, "recorded", recording(
        ("k1_candidates", 10.0)))
    assert r.read(STREAM) is None


def test_toy_cascades_traced_run_leaves_the_metric_out(tmp_path):
    """The toy cascades cell runs the engine on the CPU: no K1, no cull
    counters, so the traced run's line has no such metric."""
    spec = toy.write_toy(tmp_path)
    spec["per_layer"].append(dict(name=NAME, unit="cand/iter",
                                  better="lower", source="program_counter",
                                  layer="kernel K1", moves="photons_per_s"))
    argv = ["--workload", "toy-ice.toy-cascades", "--seed",
            str(2 ** 33 + 22), "--seconds", "0.1", "--trace", "1"]
    out = harness.run_cell(argv, time.perf_counter(), spec=spec,
                           roots=[tmp_path], device="cpu")
    assert out["correct"] is True, out["checks"]
    assert NAME not in out["metrics"]
