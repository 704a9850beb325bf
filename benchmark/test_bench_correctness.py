"""CPU tests of the correctness check: a sound run comes out correct; each
fault of the timed path that a cell can have, planted in the program
underneath a whole run, makes it come out false; and the control script
(the reference in bfloat16 in the program's place, and the faults planted
in the program's histograms) runs.  At the toy's size (benchmark/toy.py),
with the cells' own limits.

    python -m pytest benchmark/test_bench_correctness.py -q
"""

import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, harness, toy  # noqa: E402

SEED = 2 ** 34 + 5


def run(tmp_path, cell, patch=None):
    spec = toy.write_toy(tmp_path)
    return harness.run_cell(
        ["--workload", cell, "--seed", str(SEED), "--seconds", "0.1",
         "--trace", "0"], time.perf_counter(), spec=spec, roots=[tmp_path],
        device="cpu", patch=patch)


# -- faults of the stream cells, planted under EventPipeline --------------

def _propagate_fault(kind):
    from clsim_tpu_torch.parallel import pipeline
    real = pipeline.propagate_auto

    def broken(steps, *a, **kw):
        if kind == "unchanged":       # the state handed back as it came
            res = real(steps._replace(
                num_photons=torch.zeros_like(steps.num_photons)), *a, **kw)
            return res
        if kind == "half":
            # half the slots left out, their photons counted as generated
            # (a photon histogram's "mean over the rest", the half doubled,
            # is an unbiased estimate of the same expectation: no check of
            # the result can call it wrong, and PERF.md says so)
            n = steps.x.shape[0]
            keep = torch.arange(n, device=steps.x.device) % 2 == 0
            res = real(steps._replace(num_photons=torch.where(
                keep, steps.num_photons,
                torch.zeros_like(steps.num_photons))), *a, **kw)
            return res._replace(n_generated=steps.num_photons.double().sum())
        res = real(steps, *a, **kw)
        if kind == "dom_shift":      # every hit credited to the next DOM
            return res._replace(hist=torch.roll(res.hist, 1, 0))
        if kind == "weight_x2":      # every deposit twice weight / bias
            return res._replace(hist=2 * res.hist,
                                weight_hits=2 * res.weight_hits)
        # an answer altered where it is made: every detected photon
        # deposited and counted twice
        return res._replace(hist=2 * res.hist, n_hits=2 * res.n_hits,
                            weight_hits=2 * res.weight_hits)
    return broken


@pytest.mark.parametrize("cell", ["toy-ice.toy-cascades",
                                  "toy-ice.toy-flashes"])
def test_stream_sound_run_is_correct(tmp_path, cell):
    out = run(tmp_path, cell)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "dom_shift", "weight_x2"])
def test_stream_fault_comes_out_incorrect(tmp_path, monkeypatch, kind):
    from clsim_tpu_torch.parallel import pipeline
    patch = lambda ctx, drv: monkeypatch.setattr(
        pipeline, "propagate_auto", _propagate_fault(kind))
    out = run(tmp_path, "toy-ice.toy-cascades", patch)
    assert out["correct"] is False, out["checks"]


# -- the controls ------------------------------------------------------------

def test_stream_control_runs_at_the_toys_size(tmp_path):
    """The stream cells' control and planted faults end to end at the toy's
    size.  The control's effect there is inside the noise; that it fails
    the cells' limits is shown on the card at the cells' own size
    (PERF.md)."""
    toy.write_toy(tmp_path)
    roots = [tmp_path, harness.HERE]
    conf = json.loads(harness.find("configs", "toy-ice", ".json",
                                   roots).read_text())
    tr = json.loads(harness.find("traffic", "toy-cascades", ".json",
                                 roots).read_text())
    src = harness.load_module("sources", tr["source"], roots)
    out = control.stream_control(conf, tr, src, SEED, "cpu", cap=400)
    assert set(out) == {"control", "program", *control.FAULTS, "events"}
    assert all(len(v) == tr["check_events"] for v in out["events"].values())
    assert all(math.isfinite(out[k]["pooled_z"]) for k in out
               if k != "events")
    # the program's own events pass the cell's limits; each planted fault
    # fails one
    lim = tr["limits"]
    assert all(out["program"][k] <= lim[k] for k in lim), out["program"]
    for k in ("dom_shift", "weight_x2"):
        assert any(out[k][n] > lim[n] for n in lim), (k, out[k])
