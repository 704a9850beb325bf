"""Step generation (numpy, copied from clsim_tpu.sources) through the port:
for a fixed numpy seed the StepBatches must equal the JAX package's byte
for byte, given the same per-meter photon yield."""

import dataclasses

import numpy as np
import pytest
import torch

from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum as cher_j
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX as REF_J
from clsim_tpu.sources import convert as CVJ
from clsim_tpu.sources import particles as PJ
from clsim_tpu.sources import ppc as PPCJ

from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.ops.spectrum import make_cherenkov_spectrum as cher_t
from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX as REF_T
from clsim_tpu_torch.sources import convert as CVT
from clsim_tpu_torch.sources import particles as PT
from clsim_tpu_torch.sources import ppc as PPCT

torch.set_num_threads(1)

BIAS_X = np.arange(260.0, 690.0, 10.0)
BIAS_Y = np.linspace(0.2, 1.0, BIAS_X.size)


def generators():
    gj = PPCJ.PPCStepGenerator(
        ice_j(), cher_j(REF_J, 265.0, 675.0, BIAS_X, BIAS_Y),
        use_native=False)
    gt = PPCT.PPCStepGenerator(
        ice_t(device="cpu"), cher_t(REF_T, 265.0, 675.0, BIAS_X, BIAS_Y))
    # the float32 yield integrals agree to 1e-5 (test_torch_physics); use
    # the same value so that the Poisson draws see the same mean
    np.testing.assert_allclose(gt.mean_photons_per_meter,
                               gj.mean_photons_per_meter, rtol=1e-5)
    gt.mean_photons_per_meter = gj.mean_photons_per_meter.copy()
    return gj, gt


def assert_batches_equal(bj, bt):
    assert len(bj) == len(bt) > 0
    for a, b in zip(bj, bt):
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            assert x.tobytes() == y.tobytes(), f


def particle(mod, kind, energy=3000.0):
    if kind == "cascade":
        return mod.Particle.cascade(mod.ParticleType.EMinus, (5.0, -3.0, 20.0),
                                    1.0, energy, 1.1, 0.4)
    return mod.Particle(ptype=mod.ParticleType.MuMinus, x=-40.0, y=10.0,
                        z=30.0, time=0.0, energy=800.0, dir_x=0.6,
                        dir_y=0.0, dir_z=-0.8, length=120.0)


@pytest.mark.parametrize("kind", ["cascade", "muon"])
def test_ppc_steps_byte_for_byte(kind):
    gj, gt = generators()
    bj = gj.convert(particle(PJ, kind), 3, np.random.default_rng(77))
    bt = gt.convert(particle(PT, kind), 3, np.random.default_rng(77))
    assert_batches_equal(bj, bt)


def test_muon_slicer_conversion_queue_byte_for_byte():
    gj, gt = generators()
    out = []
    for P, CV, g in ((PJ, CVJ, gj), (PT, CVT, gt)):
        mu = particle(P, "muon")
        loss = P.Particle.cascade(P.ParticleType.Hadrons,
                                  (-40.0 + 0.6 * 50, 10.0, 30.0 - 0.8 * 50),
                                  50.0 / 0.299792458, 120.0, 0.64, 0.0)
        mu = dataclasses.replace(mu, daughters=(loss,), final_energy=100.0)
        conv = CV.SourceConverter(CV.default_parameterizations(g),
                                  propagators=[CV.MuonSlicerPropagator()])
        out.append(conv.convert([(mu, 0)], np.random.default_rng(5)))
    assert_batches_equal(*out)


def test_assign_steps_to_slots_matches():
    gj, gt = generators()
    bj = gj.convert(particle(PJ, "cascade", 30.0), 0, np.random.default_rng(9))
    bt = gt.convert(particle(PT, "cascade", 30.0), 0, np.random.default_rng(9))
    for n_slots in (64, 1024):
        assert_batches_equal(PPCJ.assign_steps_to_slots(bj[0], n_slots),
                             PPCT.assign_steps_to_slots(bt[0], n_slots))
