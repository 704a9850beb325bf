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
from clsim_tpu import types as TJ

from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.ops.spectrum import make_cherenkov_spectrum as cher_t
from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX as REF_T
from clsim_tpu_torch.sources import convert as CVT
from clsim_tpu_torch.sources import particles as PT
from clsim_tpu_torch.sources import ppc as PPCT
from clsim_tpu_torch import types as TT

torch.set_num_threads(1)

BIAS_X = np.arange(260.0, 690.0, 10.0)
BIAS_Y = np.linspace(0.2, 1.0, BIAS_X.size)


def generators(bias_x=BIAS_X, bias_y=BIAS_Y):
    gj = PPCJ.PPCStepGenerator(
        ice_j(), cher_j(REF_J, 265.0, 675.0, bias_x, bias_y),
        use_native=False)
    gt = PPCT.PPCStepGenerator(
        ice_t(device="cpu"), cher_t(REF_T, 265.0, 675.0, bias_x, bias_y),
        use_native=False)
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


def synthetic_steps(num_photons, seed=4):
    """A JAX and a port StepBatch of the same seeded host arrays."""
    r = np.random.default_rng(seed)
    n = len(num_photons)
    f = lambda: r.standard_normal(n).astype(np.float32)
    fields = dict(x=f(), y=f(), z=f(), t=f(), dir_x=f(), dir_y=f(),
                  dir_z=f(), length=r.random(n).astype(np.float32),
                  beta=r.random(n).astype(np.float32),
                  num_photons=np.asarray(num_photons, np.int32),
                  weight=r.random(n).astype(np.float32),
                  identifier=r.integers(0, 9, n).astype(np.int32),
                  source_type=r.integers(0, 3, n).astype(np.int32))
    return TJ.StepBatch(**fields), TT.StepBatch(**fields)


def acceptance_bias():
    from clsim_tpu_torch.util.golden import CONFIGS
    sim, _ = CONFIGS["config1_cascade"]("cpu")
    return sim._bias_x, sim._bias_y


def assignment_case(case):
    """(JAX batch, port batch, n_slots) of one assignment case."""
    r = np.random.default_rng(11)
    if case in ("cascade64", "cascade1024", "phase3"):
        energy, n_slots = dict(cascade64=(30.0, 64),
                               cascade1024=(30.0, 1024),
                               phase3=(1.0e5, 262144))[case]
        # the main path's Cherenkov yield: the DOM acceptance as the bias
        # (~35 photons/m, ~1.8e7 photons and ~92,000 steps at 100 TeV)
        gj, gt = generators(*acceptance_bias()) if case == "phase3" \
            else generators()
        bj = gj.convert(particle(PJ, "cascade", energy), 0,
                        np.random.default_rng(9))
        bt = gt.convert(particle(PT, "cascade", energy), 0,
                        np.random.default_rng(9))
        return bj[0], bt[0], n_slots
    num = dict(
        zeros=np.where(r.random(500) < 0.4, 0, r.integers(1, 300, 500)),
        all_zero=np.zeros(40, np.int64),
        huge=np.concatenate([[10_000_000], r.integers(0, 200, 30)]),
        many=r.integers(1, 200, 5000))[case]
    return (*synthetic_steps(num), 1024)


@pytest.mark.parametrize("case", ["cascade64", "cascade1024", "zeros",
                                  "all_zero", "huge", "many", "phase3"])
def test_assign_steps_to_slots_matches(case):
    """Bit for bit with the JAX package's per-step loop: zero-photon steps,
    no photons at all, one huge step, more steps than slots (several
    batches), 64 and 1,024 slots, and the main path's 100 TeV cascade at
    262,144 slots."""
    bj, bt, n_slots = assignment_case(case)
    out_j = PPCJ.assign_steps_to_slots(bj, n_slots)
    out_t = PPCT.assign_steps_to_slots(bt, n_slots)
    if case == "many":
        assert len(out_t) > 1
    assert_batches_equal(out_j, out_t)
