"""MCPE hits and photon batches in clsim_tpu_torch against clsim_tpu: the
accept/reject of sample_mcpes with the JAX package's own uniforms passed in
(equal accept sets), the hit probability, merge_mcpes
(tests/test_photons.py:96-116), PhotonBatch construction, the (string, om)
remap and the npz round trip, and Simulation.simulate_hits /
simulate_photons / simulate_hits_from_photons over three slot batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsim_tpu.api import Simulation as SimJ
from clsim_tpu.geometry import single_string_geometry as string_j
from clsim_tpu.hits import mcpe as MJ
from clsim_tpu.hits import photons as PJ
from clsim_tpu.hits.acceptance import (dom_angular_sensitivity as ang_j,
                                       icecube_dom_acceptance as acc_j)
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.propagate.dispatch import propagate_auto as auto_j
from clsim_tpu.sources import Particle as PartJ, ParticleType as PTJ
from clsim_tpu.types import PropagationConfig as CfgJ, StepBatch as StepsJ

from clsim_tpu_torch.api import Simulation as SimT
from clsim_tpu_torch.constants import DOM_RADIUS
from clsim_tpu_torch.geometry import single_string_geometry as string_t
from clsim_tpu_torch.hits import mcpe as MT
from clsim_tpu_torch.hits import photons as PT
from clsim_tpu_torch.hits.acceptance import (angular_factor,
                                             dom_angular_sensitivity as ang_t,
                                             icecube_dom_acceptance as acc_t)
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.propagate.engine import REC_FIELDS
from clsim_tpu_torch.sources import Particle as PartT, ParticleType as PTT
from clsim_tpu_torch.types import PropagationConfig as CfgT

torch.set_num_threads(1)

GEO = dict(n_doms=24, spacing=17.0, x=20.0, z_top=200.0, oversize=5.0)


def random_records(n_slots=64, cap=8, n_doms=24, seed=0):
    """Ring-form records (n_slots, cap) with counts that leave some ring
    entries empty and let some slots wrap."""
    r = np.random.default_rng(seed)
    shape = (n_slots, cap)
    rec = {k: r.random(shape).astype(np.float32) for k in REC_FIELDS}
    rec["dir_theta"] = (np.pi * r.random(shape)).astype(np.float32)
    rec["dir_phi"] = (2 * np.pi * r.random(shape)).astype(np.float32)
    rec["wavelength"] = r.uniform(280, 650, shape).astype(np.float32)
    # bias-weighted records carry weights of 1/acceptance, O(100)
    rec["weight"] = r.uniform(0, 400, shape).astype(np.float32)
    rec["dom"] = r.integers(0, n_doms, shape).astype(np.float32)
    rec["identifier"] = r.integers(0, 5, shape).astype(np.float32)
    count = r.integers(0, 2 * cap, n_slots).astype(np.int32)
    return rec, count


def tables(dev="cpu"):
    kw = dict(dom_radius=DOM_RADIUS * 5.0, efficiency=1.0)
    return (acc_j(**kw), ang_j(), acc_t(device=dev, **kw), ang_t(device=dev))


def test_hit_probability_and_angular_factor_match_jax():
    """hit_probability (I3PhotonToMCPEConverter.cxx:466-475) and the
    polynomial angular factor, float32 in both: rtol 1e-5."""
    rec, _ = random_records()
    wj, aj, wt, at = tables()
    cos = np.linspace(-1.2, 1.2, 97).astype(np.float32)
    from clsim_tpu.hits.acceptance import angular_factor as af_j
    np.testing.assert_allclose(angular_factor(at, torch.as_tensor(cos)),
                               np.asarray(af_j(aj, jnp.asarray(cos))),
                               rtol=1e-5, atol=1e-6)
    w, wl = rec["weight"].ravel(), rec["wavelength"].ravel()
    c = np.cos(rec["dir_theta"].ravel())
    pj = MJ.hit_probability(jnp.asarray(w), jnp.asarray(wl), jnp.asarray(c),
                            wj, aj, 0.9)
    pt = MT.hit_probability(torch.as_tensor(w), torch.as_tensor(wl),
                            torch.as_tensor(c), wt, at, 0.9)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("per_dom", [False, True])
def test_sample_mcpes_matches_jax_with_jax_uniforms(per_dom):
    """The accept masks are equal when the port is handed the draw that
    clsim_tpu makes, jax.random.uniform(key, p.shape) (mcpe.py:94)."""
    rec, count = random_records()
    wj, aj, wt, at = tables()
    eff = (np.random.default_rng(1).random(24).astype(np.float32)
           if per_dom else None)
    key = jax.random.PRNGKey(7)
    mj = MJ.sample_mcpes({k: jnp.asarray(v) for k, v in rec.items()},
                         jnp.asarray(count), key, wj, aj, efficiency=0.8,
                         dom_efficiency=eff)
    u = np.asarray(jax.random.uniform(key, (rec["time"].size,)))
    mt = MT.sample_mcpes({k: torch.as_tensor(v) for k, v in rec.items()},
                         torch.as_tensor(count), None, wt, at,
                         efficiency=0.8, dom_efficiency=eff, uniforms=u)
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert 0 < int(mt.valid.sum()) < int((count > 0).sum()) * 8
    np.testing.assert_array_equal(mt.dom.numpy(), np.asarray(mj.dom))
    for a, b in zip(MT.mcpes_to_numpy(mt), MJ.mcpes_to_numpy(mj)):
        np.testing.assert_array_equal(a, b)


def test_sample_mcpes_from_batch_matches_jax_with_jax_uniforms():
    rec, count = random_records(seed=3)
    wj, aj, wt, at = tables()
    geo_j, geo_t = string_j(**GEO), string_t(device="cpu", **GEO)
    batch = PJ.records_to_photon_batch(rec, count, geo_j)
    idx = PJ.photon_batch_dom_index(batch, geo_j)
    key = jax.random.PRNGKey(11)
    mj = MJ.sample_mcpes_from_batch(batch, idx, key, wj, aj)
    u = np.asarray(jax.random.uniform(key, (len(batch.time),)))
    mt = MT.sample_mcpes_from_batch(batch, PT.photon_batch_dom_index(
        batch, geo_t), None, wt, at, uniforms=u)
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert int(mt.valid.sum()) > 0


def test_merge_mcpes_window():
    dom = np.array([3, 3, 3, 5, 5, 3])
    t = np.array([10.0, 11.0, 30.0, 1.0, 100.0, 10.5])
    ident = np.array([0, 1, 2, 3, 4, 5])
    md, mt, npe, mid = MT.merge_mcpes(dom, t, ident, window_ns=2.0)
    np.testing.assert_array_equal(md, [3, 3, 5, 5])
    np.testing.assert_allclose(mt, [10.0, 30.0, 1.0, 100.0])
    np.testing.assert_array_equal(npe, [3, 1, 1, 1])
    assert mid[0] == 0 and npe.sum() == len(dom)
    for a, b in zip((md, mt, npe, mid),
                    MJ.merge_mcpes(dom, t, ident, window_ns=2.0)):
        np.testing.assert_array_equal(a, b)
    d, t, npe, i = MT.merge_mcpes(np.zeros(0, np.int32), np.zeros(0),
                                  np.zeros(0, np.int32), 5.0)
    assert len(d) == len(t) == len(npe) == len(i) == 0


def test_photon_batch_both_contracts_and_npz_round_trip(tmp_path):
    """records_to_photon_batch equals clsim_tpu's on ring records, takes
    the flat (1, R) contract (compact_records) to the same batch, remaps
    (string, om) to the DOM index and back, and survives npz exactly."""
    rec, count = random_records()
    geo_j, geo_t = string_j(**GEO), string_t(device="cpu", **GEO)
    bj = PJ.records_to_photon_batch(rec, count, geo_j)
    rec_t = {k: torch.as_tensor(v) for k, v in rec.items()}
    bt = PT.records_to_photon_batch(rec_t, torch.as_tensor(count), geo_t)
    flat, n = PT.compact_records(rec_t, torch.as_tensor(count))
    assert flat["time"].shape == (1, int(n[0])) == (1, len(bt.time))
    bf = PT.records_to_photon_batch(flat, n, geo_t)
    for f in bt._fields:
        np.testing.assert_array_equal(getattr(bt, f), np.asarray(
            getattr(bj, f)), f)
        np.testing.assert_array_equal(getattr(bf, f), getattr(bt, f), f)
    idx = PT.photon_batch_dom_index(bt, geo_t)
    np.testing.assert_array_equal(idx, PJ.photon_batch_dom_index(bj, geo_j))
    np.testing.assert_array_equal(idx, flat["dom"][0].numpy())
    path = tmp_path / "p.npz"
    PT.save_photons_npz(path, bt)
    loaded = PT.load_photons_npz(path)
    for f in bt._fields:
        np.testing.assert_array_equal(getattr(loaded, f), getattr(bt, f), f)
    bad = bt._replace(om_id=bt.om_id + 1000)
    with pytest.raises(ValueError, match="not in this geometry"):
        PT.photon_batch_dom_index(bad, geo_t)


def test_check_photon_positions():
    rec = {k: torch.zeros(1, 4) for k in ("time", "pos_x", "pos_y",
                                            "pos_z")}
    rec["pos_x"][0] = torch.tensor([0.5, -0.5, 0.0, 9.0])
    rec["pos_z"][0, 2] = 0.5
    count = torch.tensor([3])          # the fourth entry is not a record
    assert MT.check_photon_positions(rec, count, 0.5, 1.0) == 0
    assert MT.check_photon_positions(rec, count, 0.5, 5.0) == 0
    rec["pos_y"][0, 2] = 0.2
    with pytest.warns(RuntimeWarning, match="not on the DOM sphere"):
        assert MT.check_photon_positions(rec, count, 0.5, 1.0) == 1
    with pytest.raises(RuntimeError):
        MT.check_photon_positions(rec, count, 0.5, 1.0, only_warn=False)


# --- Simulation over three slot batches ------------------------------------

CFG = dict(n_slots=100, save_photons=True, photon_capacity_per_slot=32)


def cascade(P, T):
    return P.cascade(T.EMinus, pos=(12.0, 0.0, 100.0), time=0.0,
                     energy=30.0, zenith=np.pi / 2, azimuth=np.pi)


@pytest.fixture(scope="module")
def sims():
    # photons_per_step=20 at 100 slots: 30 GeV gives three slot batches
    kw = dict(photons_per_step=20)
    sim_t = SimT(medium=ice_t(device="cpu", b400=0.04, a_dust400=0.02),
                 geometry=string_t(device="cpu", **GEO), config=CfgT(**CFG), **kw)
    sim_j = SimJ(medium=ice_j(b400=0.04, a_dust400=0.02),
                 geometry=string_j(**GEO), config=CfgJ(**CFG), **kw)
    return sim_t, sim_j


def test_simulate_keeps_records_of_every_slot_batch(sims):
    """The port accumulates records over all slot batches; clsim_tpu keeps
    only the last batch's (clsim_tpu/api.py:184-186, where run_steps takes
    rec_count/rec from the last result), so a multi-batch simulate_hits
    there undercounts.  This is a documented divergence from the
    reference, not parity."""
    sim_t, sim_j = sims
    batches = sim_t.steps_from_particles([cascade(PartT, PTT)],
                                         np.random.default_rng(13))
    assert len(batches) == 3
    res_t = sim_t.simulate([cascade(PartT, PTT)], seed=13)
    n = int(res_t.rec_count[0])
    assert res_t.rec["time"].shape == (1, n)
    assert n == float(res_t.n_hits) > 30      # all three batches' records
    # clsim_tpu: the records are those of the last batch alone
    rng = np.random.default_rng(13)
    batches_j = sim_j.steps_from_particles([cascade(PartJ, PTJ)], rng)
    assert len(batches_j) == 3
    res_j = sim_j.run_steps(batches_j, 13)
    last = auto_j(StepsJ(*[jnp.asarray(f) for f in batches_j[2]]),
                  sim_j.medium, sim_j.geometry, sim_j.spectra,
                  jax.random.fold_in(jax.random.PRNGKey(13), 2),
                  sim_j.config)
    n_j = int(np.asarray(res_j.rec_count).sum())
    assert n_j == float(last.n_hits) < float(res_j.n_hits)


def test_simulate_hits_and_two_phase_flow(sims, tmp_path):
    """simulate_hits, simulate_photons -> npz -> simulate_hits_from_photons
    and the per-DOM efficiency through the port's Simulation: MCPEs are a
    time-ordered subset of the records, the two-phase flow sees the same
    photons, and a dead DOM yields no MCPE."""
    sim_t, _ = sims
    c = cascade(PartT, PTT)
    res = sim_t.simulate([c], seed=13)
    dom, t, ident = sim_t.simulate_hits([c], seed=13)
    assert 0 < len(t) <= int(res.rec_count[0])
    assert (np.diff(t) >= 0).all() and (ident == 0).all()
    assert set(dom.tolist()) <= set(res.rec["dom"][0].long().tolist())
    path = tmp_path / "p.npz"
    batch = sim_t.simulate_photons([c], seed=13, save_path=path)
    assert len(batch.time) == int(res.rec_count[0])
    np.testing.assert_array_equal(np.sort(batch.time),
                                  np.sort(res.rec["time"][0].numpy()))
    d2, t2, _ = sim_t.simulate_hits_from_photons(path, seed=99)
    assert abs(len(t2) - len(t)) < 5.0 * np.sqrt(len(t) + len(t2)) + 5
    eff = np.ones(24, np.float32)
    dead = np.unique(dom)[:2]
    eff[dead] = 0.0
    d3, _, _ = sim_t.simulate_hits([c], seed=13, per_dom_efficiency=eff)
    assert not np.isin(d3, dead).any() and len(d3) < len(dom)
    md, mt, npe, _ = sim_t.simulate_hits([c], seed=13, merge_window_ns=10.0)
    assert npe.sum() == len(t)


def test_record_entry_points_need_save_photons():
    sim = SimT(medium=ice_t(device="cpu"), geometry=string_t(device="cpu", **GEO),
               config=CfgT(n_slots=128))
    for fn in (sim.simulate_hits, sim.simulate_photons):
        with pytest.raises(ValueError, match="save_photons=True"):
            fn([cascade(PartT, PTT)], 0)
