"""The port's BASELINE correctness matrix (clsim_tpu_torch/validate/matrix.py)
on the CPU:

  * each of its four workloads equals tests/test_oracle.py's (the one
    scripts/validate_oracle.py runs) carried across by the port's
    conversion helpers: every step field, medium leaf, spectrum table,
    oracle spectrum and config value;
  * muon, flasher and cascade-biased through propagate_auto (the engine on
    the CPU) against the float64 oracle by matrix.check_case: every z below 5
    and at least 200 hits on each side (4,096 x 4 photons, the flasher
    4,096 x 24: its beam gives fewer hits a photon).  The usable
    equal-count bins, a demand on the run's size that needs ~1e6 photons,
    are left to the card (chip_smoke.py --oracle-matrix);
  * check_case's checks besides the statistics: a photon missing from
    generated, a hit without its record, weights not unfolded and a kernel
    launch under the engine backend are each flagged;
  * the power of the biased comparison: the oracle's per-hit output
    against itself gives every z 0, and the same hits with their weights
    multiplied back by the bias (a broken unfolding: each hit keeps its
    step's weight 1) fail the weight law;
  * scripts/torch_validate_oracle.py runs a small muon case on the CPU
    without importing jax or clsim_tpu.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_oracle import _workload, _workload_flasher, _workload_muon

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.types import PropagationConfig as CfgT
from clsim_tpu_torch.validate import matrix as MX

torch.set_num_threads(1)

# photons a step of the statistical cases: >= 200 hits on each side
PPS = {"muon": 4, "cascade-biased": 4, "flasher": 24}


def jax_workload(config):
    """tests/test_oracle.py's workload of `config` with the oracle spectra
    and the record configuration scripts/validate_oracle.py gives it."""
    if config == "flasher":
        medium, geo, spectra, cfg, steps, oracle_spectra = \
            _workload_flasher()
    else:
        medium, geo, spectra, cfg, steps = (
            _workload_muon() if config == "muon"
            else _workload(bias=config == "cascade-biased"))
        oracle_spectra = (np.asarray(spectra.x[0]),
                          np.asarray(spectra.beta[0]))
    if config == "cascade-biased":
        cfg = dataclasses.replace(
            cfg, save_photons=True,
            photon_capacity_per_slot=int(steps.num_photons[0]) + 8)
    return medium, geo, spectra, cfg, steps, oracle_spectra


def assert_same_tree(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (str, bool, int, float)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("config", MX.CONFIGS)
def test_workload_equals_the_jax_workload(config):
    medium, geo, spectra, cfg, steps, oracle_spectra = jax_workload(config)
    w = MX.workload(config, "cpu")
    tree = C.numpy_tree
    assert_same_tree(tree(w.medium), tree(C.medium_from_numpy(
        tree(medium), device="cpu")))
    assert_same_tree(tree(w.geo), tree(C.geometry_from_numpy(
        tree(geo), device="cpu")))
    assert_same_tree(tree(w.spectra), tree(C.spectra_from_numpy(
        tree(spectra), device="cpu")))
    assert_same_tree(tree(w.steps), tree(C.steps_from_numpy(
        steps._asdict(), device="cpu")))
    assert_same_tree(tree(w.steps), {k: np.asarray(v) for k, v in
                                     steps._asdict().items()})
    assert_same_tree(oracle_spectra, w.oracle_spectra)
    assert dataclasses.asdict(w.cfg) == dataclasses.asdict(
        CfgT(**dataclasses.asdict(cfg)))
    assert w.photons_per_step == int(steps.num_photons[0]) == \
        MX.PHOTONS_PER_STEP


@functools.cache
def run(config):
    w = MX.workload(config, "cpu", PPS[config])
    res, launches = MX.propagate(w)
    return w, res, launches, MX.oracle(w)


@pytest.mark.parametrize("config", ["muon", "flasher", "cascade-biased"])
def test_engine_against_the_oracle(config):
    w, res, launches, oracle_out = run(config)
    case = MX.check_case(config, w, res, launches, oracle_out, power=False)
    cmp = case.cmp
    report = "\n".join(cmp.lines)
    assert case.problems == [], report
    assert launches == 0
    assert float(res.n_generated) == MX.N_STEPS * PPS[config]
    assert float(res.n_hits) >= 200 and oracle_out[1] >= 200, report
    assert cmp.passed(power=False), report
    assert cmp.max_z < MX.Z_LIMIT
    kinds = {s.kind for s in cmp.stats}
    if config == "cascade-biased":
        assert kinds == {"z", "quantile", "usable"}
        # every hit recorded once, with the weight the histogram holds,
        # its step's weight over the bias at its wavelength
        flat, weight = case.records
        assert len(weight) == float(res.n_hits)
        assert case.unfold <= MX.UNFOLD_TOL
        np.testing.assert_allclose(weight.sum(), float(res.weight_hits),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            np.bincount(flat, weights=weight,
                        minlength=res.hist.numel()),
            res.hist.double().reshape(-1).numpy(), rtol=1e-5, atol=1e-3)
    else:
        assert kinds == {"z"}
        assert case.records is None
        assert float(res.weight_hits) == pytest.approx(float(res.n_hits))


def test_check_case_flags_what_the_statistics_miss():
    w, res, launches, oracle_out = run("cascade-biased")

    def problems(r, n=launches, backend="auto"):
        return MX.check_case("cascade-biased", w, r, n, oracle_out, backend,
                             power=False).problems

    assert problems(res) == []
    assert problems(res._replace(n_generated=res.n_generated - 1)) == [
        "generated != the steps' photons"]
    assert "records != hits" in problems(res._replace(n_hits=res.n_hits + 1))
    doubled = dict(res.rec, weight=res.rec["weight"] * 2.0)
    assert "weights are not 1 / bias" in problems(res._replace(rec=doubled))
    assert problems(res, n=1, backend="engine") == [
        "the engine launched the kernel"]


class _Hits:
    def __init__(self, hist, n_hits):
        self.hist, self.n_hits = hist, n_hits


def test_biased_comparison_has_power():
    w, _, _, oracle_out = run("cascade-biased")
    o_hist, o_hits, _, o_w, o_flat = oracle_out
    same = MX.compare("cascade-biased", _Hits(o_hist, o_hits),
                      (o_flat, o_w), oracle_out)
    for s in same.stats:
        if s.kind != "usable":
            assert s.value == 0.0 and s.ok, s
    # the weights multiplied back by the bias: each hit keeps its step's
    # weight (1), as a path that forgot to unfold the bias would give
    w_broken = np.ones_like(o_w)
    hist = np.bincount(o_flat, weights=w_broken,
                       minlength=o_hist.size).reshape(o_hist.shape)
    broken = MX.compare("cascade-biased", _Hits(hist, o_hits),
                        (o_flat, w_broken), oracle_out)
    assert not broken.passed(power=False)
    failed = set(broken.failed)
    assert {"weight q25", "weight q50", "weight q75"} <= failed, failed
    assert "total weight" in failed
    # the unbiased rule would see nothing in the hit count
    assert "total hits" not in failed


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT_RUN = """
import runpy, sys
sys.argv = ["torch_validate_oracle.py", "16384", "--config", "muon",
            "--device", "cpu"]
try:
    runpy.run_path("scripts/torch_validate_oracle.py", run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
print("LEAKED", sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "clsim_tpu"}))
sys.exit(code)
"""


def test_script_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", SCRIPT_RUN], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.splitlines()
    assert lines[0] == "device cpu" and "=== muon ===" in lines
    assert "PASS" in lines and lines[-2] == "DONE", p.stdout
    assert lines[-1] == "LEAKED []", p.stdout
