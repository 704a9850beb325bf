"""The port's detailed propagators (sources/detailed.py) against the JAX
package's, mirroring tests/test_detailed.py's seven cases: for the same
numpy rng the step batches (and the muon's secondaries) are equal byte for
byte, given the same bias-weighted yield tables, and the port meets each
case's physics contract on its own."""

import numpy as np
import pytest
import torch

from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX as REF_J
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum as cher_j
from clsim_tpu.ops.spectrum import photons_per_meter as ppm_j
from clsim_tpu.sources import convert as CVJ
from clsim_tpu.sources import detailed as DJ
from clsim_tpu.sources import particles as PJ
from clsim_tpu.sources import ppc as PPCJ

from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX as REF_T
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.ops.spectrum import make_cherenkov_spectrum as cher_t
from clsim_tpu_torch.sources import convert as CVT
from clsim_tpu_torch.sources import detailed as DT
from clsim_tpu_torch.sources import particles as PT
from clsim_tpu_torch.sources import ppc as PPCT

torch.set_num_threads(1)

SIDES = ((PJ, CVJ, DJ, PPCJ), (PT, CVT, DT, PPCT))


def setups():
    return ((ice_j(), cher_j(REF_J, 265.0, 675.0)),
            (ice_t(device="cpu"), cher_t(REF_T, 265.0, 675.0)))


def same_yields(obj_j, obj_t):
    """Give the port's object the JAX one's yield tables: the float32
    quadratures agree to 1e-5 (test_torch_physics), and the Poisson draws
    must see the same means."""
    for name in ("_ppm_grid", "mean_ppm", "mean_photons_per_meter"):
        if hasattr(obj_j, name):
            a, b = getattr(obj_j, name), getattr(obj_t, name)
            np.testing.assert_allclose(b, a, rtol=1e-5)
            setattr(obj_t, name, np.copy(a))
    if hasattr(obj_j, "beta_threshold"):
        assert obj_t.beta_threshold == obj_j.beta_threshold
        np.testing.assert_array_equal(obj_t._beta_grid, obj_j._beta_grid)


def detailed_pair(**kw):
    (mj, sj), (mt, st) = setups()
    dj = DJ.DetailedCascadePropagator(mj, sj, **kw)
    dt = DT.DetailedCascadePropagator(mt, st, **kw)
    same_yields(dj, dt)
    return dj, dt


def ppc_pair():
    (mj, sj), (mt, st) = setups()
    gj, gt = PPCJ.PPCStepGenerator(mj, sj), PPCT.PPCStepGenerator(mt, st)
    same_yields(gj, gt)
    return gj, gt


def assert_batches_equal(bj, bt):
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def cascade(P, energy, pos=(0.0, 0.0, 0.0), time=0.0):
    return P.Particle(ptype=P.ParticleType.EMinus, x=pos[0], y=pos[1],
                      z=pos[2], time=time, energy=energy, dir_x=0.0,
                      dir_y=0.0, dir_z=1.0)


def muon(P):
    return P.Particle(ptype=P.ParticleType.MuMinus, x=0, y=0, z=0, time=0,
                      energy=1000.0, dir_x=1.0, dir_y=0.0, dir_z=0.0,
                      length=500.0)


def convert_both(props, particles, seed):
    """Each propagator's convert of its side's particle with the same
    seed: (steps, secondaries) of the JAX side and of the port."""
    out = []
    for prop, p in zip(props, particles):
        steps, sec = [], []
        prop.convert(p, 7, sec.append, steps.append,
                     np.random.default_rng(seed))
        out.append((steps, sec))
    return out


def total(batches):
    return sum(int(np.asarray(b.num_photons).sum()) for b in batches)


def test_detailed_yield_matches_ppc_at_beta_one():
    dets = detailed_pair(beta_spread=0.0)
    (sj, _), (st, _) = convert_both(dets, [cascade(PJ, 200.0),
                                           cascade(PT, 200.0)], 1)
    assert_batches_equal(sj, st)
    _, gt = ppc_pair()
    rng = np.random.default_rng(2)
    n_ppc = np.mean([total(gt.convert(cascade(PT, 200.0), 0, rng))
                     for _ in range(5)])
    assert total(st) == pytest.approx(n_ppc, rel=0.03)


def test_detailed_beta_spread_lowers_yield():
    dets0, dets = detailed_pair(beta_spread=0.0), \
        detailed_pair(beta_spread=0.02)
    parts = [cascade(PJ, 500.0), cascade(PT, 500.0)]
    (b0j, _), (b0t, _) = convert_both(dets0, parts, 3)
    (b1j, _), (b1t, _) = convert_both(dets, parts, 4)
    assert_batches_equal(b0j, b0t)
    assert_batches_equal(b1j, b1t)
    n0, n1 = total(b0t), total(b1t)
    assert 0.75 * n0 < n1 < 0.99 * n0
    betas = np.concatenate([b.beta for b in b1t])
    assert (betas <= 1.0).all() and (betas < 1.0).any()
    assert (betas > dets[1].beta_threshold).all()


def test_detailed_profile_and_caps():
    dets = detailed_pair(photons_per_step=150)
    (sj, _), (st, _) = convert_both(
        dets, [cascade(P, 50.0, (1.0, 2.0, 3.0), 10.0) for P in (PJ, PT)], 5)
    assert_batches_equal(sj, st)
    (b,) = st
    assert (b.num_photons <= 150).all() and (b.identifier == 7).all()
    assert (b.z >= 3.0 - 1e-6).all() and b.z.max() > 4.0
    assert np.allclose(b.x, 1.0) and np.allclose(b.y, 2.0)
    assert b.dir_z.mean() > 0.7


def test_detailed_ppm_monotone_in_beta():
    (mj, sj), (mt, st) = setups()
    dj = DJ.DetailedCascadePropagator(mj, sj)
    dt = DT.DetailedCascadePropagator(mt, st)
    betas = np.linspace(dt.beta_threshold, 1.0, 16)
    ppm = dt.ppm(betas)
    np.testing.assert_allclose(ppm, dj.ppm(betas), rtol=1e-5, atol=1e-6)
    assert (np.diff(ppm) >= -1e-9).all()
    assert ppm[0] == pytest.approx(0.0, abs=1e-6)
    ref = float(ppm_j(mj.ref_index, sj.bias_x, sj.bias_y, mj.min_wlen,
                      mj.max_wlen))
    assert ppm[-1] == pytest.approx(ref, rel=1e-5)


def test_detailed_in_hybrid_conversion_queue():
    dets = detailed_pair(max_energy_gev=30.0)
    out = []
    for (P, CV, _, _), det, gen in zip(SIDES, dets, ppc_pair()):
        conv = CV.SourceConverter(
            CV.hybrid_parameterizations(gen, crossover_energy_em=30.0),
            propagators=[det])
        out.append(conv.convert([(cascade(P, 5.0), 0),
                                 (cascade(P, 100.0), 1)],
                                np.random.default_rng(6)))
    assert_batches_equal(*out)
    ids = np.concatenate([b.identifier for b in out[1]])
    assert (ids == 0).any() and (ids == 1).any()
    betas = np.concatenate([b.beta[b.identifier == 0] for b in out[1]])
    assert (betas < 1.0).any()


def muon_pair(**kw):
    (mj, sj), (mt, st) = setups()
    pj = DJ.DetailedMuonPropagator(mj, sj, **kw)
    pt = DT.DetailedMuonPropagator(mt, st, **kw)
    same_yields(pj, pt)
    return pj, pt


def test_detailed_muon_secondaries_produce_steps():
    props = muon_pair(loss_e_max_gev=20.0)
    (bj, secj), (bt, sect) = convert_both(props, [muon(PJ), muon(PT)], 7)
    assert_batches_equal(bj, bt)
    assert bt and total(bt) > 0 and len(sect) == len(secj) > 0
    for a, s in zip(secj, sect):
        assert (a.ptype.value, a.x, a.y, a.z, a.time, a.energy) == \
            (s.ptype.value, s.x, s.y, s.z, s.time, s.energy)
        assert s.ptype == PT.ParticleType.EMinus and 0.5 <= s.energy <= 20.0
        assert 0.0 <= s.x <= 500.0 and s.y == 0.0 and s.z == 0.0
        assert s.time == pytest.approx(s.x / 0.299792458, rel=1e-6)
    out = []
    for (P, CV, _, _), prop, gen in zip(SIDES, props, ppc_pair()):
        conv = CV.SourceConverter(CV.default_parameterizations(gen),
                                  propagators=[prop])
        out.append(conv.convert([(muon(P), 7)], np.random.default_rng(8)))
    assert_batches_equal(*out)
    assert total(out[1]) > total(bt)
    assert any((np.abs(b.dir_y) + np.abs(b.dir_z) > 1e-6).any()
               for b in out[1])


def test_detailed_muon_total_yield_matches_ppc_extr():
    props = muon_pair(loss_e_max_gev=10.0)
    convs = [CV.SourceConverter(CV.default_parameterizations(gen),
                                propagators=[prop])
             for (_, CV, _, _), prop, gen in zip(SIDES, props, ppc_pair())]
    # the first events byte for byte, then the port's mean yield
    for seed in range(3):
        assert_batches_equal(*[c.convert([(muon(P), 0)],
                                         np.random.default_rng(seed))
                               for c, (P, _, _, _) in zip(convs, SIDES)])
    rng = np.random.default_rng(9)
    K = 120
    n_det = np.mean([total(convs[1].convert([(muon(PT), 0)], rng))
                     for _ in range(K)])
    gen = convs[1].parameterizations[0].converter
    n_ppc = np.mean([total(gen.convert(muon(PT), 0, rng)) for _ in range(K)])
    assert n_det == pytest.approx(n_ppc, rel=0.08), (n_det, n_ppc)
