"""Scatter-history rings in clsim_tpu_torch against clsim_tpu's engine on a
shared (T, 8, N) uniform stream (tests/test_engine.py:371's workload: 64
slots x 8 photons, H = 4, SAVE_ALL, one DOM out of reach), the ring
semantics of that test on the port's records, and the rings through the
port's Simulation (engine only: the kernel refuses them, as the JAX
kernel does).  Ring fields are held within 2e-2, num_scatters exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from test_engine import _beam_steps, _one_dom_geometry, _spectra
from test_torch_records import assert_rings_match, run_both_engines

from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.types import PropagationConfig

from clsim_tpu_torch.api import Simulation as SimT
from clsim_tpu_torch.geometry import single_string_geometry as string_t
from clsim_tpu_torch.hits import photons as PT
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.propagate import dispatch as D
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.sources import Particle, ParticleType
from clsim_tpu_torch.types import PropagationConfig as CfgT

torch.set_num_threads(1)

H = 4
N, PHOTONS, T = 64, 8, 128
RING_TOL = 2e-2
CASES = {
    # tests/test_engine.py:371: detect, SAVE_ALL at the absorption points
    "detect": dict(),
    # the expected estimator with soft binning (the configuration whose
    # refusal tests/test_torch_engine.py held before the rings were
    # ported), at a horizon of 3 absorption lengths so that the stream
    # drains
    "expected": dict(estimator="expected", soft_binning=True,
                     fixed_abs_lens=3.0),
}


def workload(**change):
    medium = make_homogeneous_ice(b400=0.08, a_dust400=0.03)
    cfg = PropagationConfig(n_slots=N, save_photons=True,
                            save_all_photons=True, stop_on_detection=False,
                            photon_capacity_per_slot=32,
                            photon_history_entries=H, **change)
    u = np.random.default_rng(14).random((T, 8, N)).astype(np.float32)
    steps = _beam_steps(N, PHOTONS, pos=(100.0, 100.0, 100.0), source_type=0)
    return medium, _one_dom_geometry(x=5000.0), _spectra(), cfg, steps, u


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    """(case, JAX result, port result) of one case on the shared stream."""
    inputs = workload(**CASES[request.param])
    res_j, res_t = run_both_engines(inputs)
    return request.param, inputs, res_j, res_t


def test_history_rings_match_jax_engine(both):
    """Every record, its four ring fields and num_scatters, equal to the
    JAX engine's slot by slot."""
    _, inputs, res_j, res_t = both
    cfg = inputs[3]
    assert float(res_t.n_generated) == N * PHOTONS
    assert_rings_match(res_j, res_t, cfg.photon_capacity_per_slot)
    cnt = res_t.rec_count.numpy()
    rec = np.arange(cfg.photon_capacity_per_slot)[None, :] < cnt[:, None]
    ns = res_t.rec["num_scatters"].numpy()[rec]
    np.testing.assert_array_equal(
        ns, np.asarray(res_j.rec["num_scatters"])[rec])
    assert ns.max() > H                    # some rings wrapped
    worst = {}
    for f in ET.HIST_FIELDS:
        a = res_t.rec[f].numpy()
        b = np.asarray(res_j.rec[f])
        assert a.shape == b.shape == (N, cfg.photon_capacity_per_slot, H)
        np.testing.assert_allclose(a[rec], b[rec], atol=RING_TOL,
                                   rtol=1e-3, err_msg=f)
        worst[f] = float(np.abs(a[rec] - b[rec]).max())
    print("largest ring difference", worst)


def test_history_ring_semantics(both):
    """tests/test_engine.py:371's assertions on the port's records: each
    record holds min(num_scatters, H) filled entries and zeros after them,
    depths positive and at most the record's depth, positions away from
    the origin, depths rising in append order."""
    _, inputs, _, res_t = both
    cap = inputs[3].photon_capacity_per_slot
    counts = res_t.rec_count.numpy()
    ns = res_t.rec["num_scatters"].numpy().astype(int)
    habs = res_t.rec["hist_abs"].numpy()
    hx = res_t.rec["hist_x"].numpy()
    depth = res_t.rec["dist_in_abs_lens"].numpy()
    recorded = np.arange(cap)[None, :] < counts[:, None]
    assert counts.sum() == float(res_t.n_generated)
    filled = np.minimum(ns, H)
    idx = np.arange(H)[None, None, :]
    used = recorded[:, :, None] & (idx < filled[:, :, None])
    unused = recorded[:, :, None] & (idx >= filled[:, :, None])
    assert used.sum() > 100 and unused.sum() > 0
    assert np.all(habs[unused] == 0.0) and np.all(hx[unused] == 0.0)
    assert np.all(habs[used] > 0.0)
    cap_d = np.broadcast_to(depth[:, :, None] + 1e-4, habs.shape)
    assert np.all(habs[used] <= cap_d[used])
    assert np.all(np.abs(hx[used]) > 1.0)
    short = recorded & (ns >= 2) & (ns <= H)
    for i, j in zip(*np.nonzero(short)):
        assert np.all(np.diff(habs[i, j, :ns[i, j]]) >= 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_history_rings_leave_the_histogram_alone(case):
    """On one stream a run with rings takes the same decisions as a run
    without them: equal histograms, counts and records."""
    from test_torch_engine import port_inputs
    steps, medium, geo, spectra, cfg, u = port_inputs(*workload(
        **CASES[case]))
    with_rings = ET.propagate(steps, medium, geo, spectra, 0, cfg,
                              uniforms=u)
    without = ET.propagate(steps, medium, geo, spectra, 0,
                           dataclasses.replace(cfg, photon_history_entries=0),
                           uniforms=u)
    assert set(with_rings.rec) == set(without.rec) | set(ET.HIST_FIELDS)
    assert torch.equal(with_rings.hist, without.hist)
    assert float(with_rings.n_hits) == float(without.n_hits)
    assert torch.equal(with_rings.rec_count, without.rec_count)
    for k, v in without.rec.items():
        assert torch.equal(with_rings.rec[k], v), k


def test_compact_records_keep_the_rings():
    """The flat record contract carries each record's ring as (1, R, H);
    the photon batch drops the ring fields (clsim_tpu/hits/photons.py)."""
    rec = {"time": torch.arange(6.0).reshape(3, 2),
           "hist_x": torch.arange(24.0).reshape(3, 2, 4)}
    flat, n = PT.compact_records(rec, torch.tensor([1, 2, 0]))
    assert int(n[0]) == 3
    assert flat["time"].tolist() == [[0.0, 2.0, 3.0]]
    assert flat["hist_x"].shape == (1, 3, 4)
    np.testing.assert_array_equal(flat["hist_x"][0].numpy(),
                                  rec["hist_x"].reshape(6, 4)[[0, 2, 3]])


def test_simulation_serves_rings_through_the_engine():
    """Simulation with save_photons and rings on CPU tensors: simulate keeps
    every batch's records with their rings, simulate_photons drops the ring
    fields from the batch, simulate_hits samples MCPEs from the records,
    and the kernel's reason names rings."""
    geo = dict(n_doms=24, spacing=17.0, x=20.0, z_top=200.0, oversize=5.0)
    cfg = CfgT(n_slots=100, save_photons=True, photon_capacity_per_slot=32,
               photon_history_entries=3)
    sim = SimT(medium=ice_t(device="cpu", b400=0.04, a_dust400=0.02),
               geometry=string_t(device="cpu", **geo), config=cfg,
               photons_per_step=20)
    c = Particle.cascade(ParticleType.EMinus, pos=(12.0, 0.0, 100.0),
                         time=0.0, energy=30.0, zenith=np.pi / 2,
                         azimuth=np.pi)
    res = sim.simulate([c], seed=13)
    n = int(res.rec_count[0])
    assert n == float(res.n_hits) > 30
    for f in ET.HIST_FIELDS:
        assert res.rec[f].shape == (1, n, 3)
    ns = res.rec["num_scatters"][0]
    filled = (res.rec["hist_abs"][0] > 0).sum(1)
    assert torch.equal(filled, torch.clamp(ns, max=3).to(filled.dtype))
    batch = sim.simulate_photons([c], seed=13)
    assert len(batch.time) == n and not hasattr(batch, "hist_x")
    _, t, _ = sim.simulate_hits([c], seed=13)
    assert 0 < len(t) <= n
    assert "history" in D.backend_reason(sim.medium, sim.spectra, cfg,
                                         sim.geometry, cfg.n_slots)
