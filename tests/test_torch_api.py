"""End to end: Simulation.simulate of clsim_tpu_torch on the CPU, mirroring
tests/test_api.py::test_cascade_simulation_end_to_end, compared with
clsim_tpu statistically (the two packages draw different random streams,
and the JAX step generator may use its native sampler)."""

import math

import numpy as np
import pytest
import torch

from clsim_tpu.api import Simulation as SimJ
from clsim_tpu.geometry import single_string_geometry as string_j
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.sources import Particle as PartJ, ParticleType as PTJ
from clsim_tpu.types import PropagationConfig as CfgJ

from clsim_tpu_torch.api import Simulation as SimT
from clsim_tpu_torch.geometry import single_string_geometry as string_t
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.parallel.mesh import make_mesh
from clsim_tpu_torch.sources import Particle as PartT, ParticleType as PTT
from clsim_tpu_torch.types import PropagationConfig as CfgT

torch.set_num_threads(1)

GEO = dict(n_doms=24, spacing=17.0, x=20.0, z_top=200.0, oversize=5.0)


def cascade(P, T):
    # aim the cascade at the string (zenith pi/2 + azimuth pi => +x travel)
    return P.cascade(T.EMinus, pos=(0.0, 0.0, 0.0), time=0.0, energy=100.0,
                     zenith=np.pi / 2, azimuth=np.pi)


@pytest.fixture(scope="module")
def results():
    sim_j = SimJ(medium=ice_j(b400=0.04, a_dust400=0.006),
                 geometry=string_j(**GEO), config=CfgJ(n_slots=2048))
    sim_t = SimT(medium=ice_t(device="cpu", b400=0.04, a_dust400=0.006),
                 geometry=string_t(device="cpu", **GEO), config=CfgT(n_slots=2048))
    out = {}
    for name, sim, P, T in (("jax", sim_j, PartJ, PTJ),
                            ("torch", sim_t, PartT, PTT)):
        ppm = sim.step_generator.mean_photons_per_meter[0]
        res = sim.simulate([cascade(P, T)], seed=7)
        out[name] = (res, ppm * 5.21 * 0.924 / 0.9216 * 100.0)
    return out


def test_cascade_simulation_end_to_end(results):
    res, expected = results["torch"]
    assert float(res.n_generated) == pytest.approx(expected, rel=0.1)
    assert float(res.n_hits) > 0
    assert tuple(res.hist.shape) == (24, 512)
    assert float(res.hist.double().sum()) == pytest.approx(
        float(res.weight_hits), rel=1e-4)
    assert res.diag_totals is None          # CPU tensors: the torch engine


def test_cascade_yield_and_hit_rate_match_jax(results):
    (rj, ej), (rt, et) = results["jax"], results["torch"]
    assert float(rj.n_generated) == pytest.approx(ej, rel=0.1)
    assert et == pytest.approx(ej, rel=1e-5)
    nj, nt = float(rj.n_generated), float(rt.n_generated)
    pj, pt = float(rj.n_hits) / nj, float(rt.n_hits) / nt
    z = (pj - pt) / math.sqrt(pj * (1 - pj) / nj + pt * (1 - pt) / nt)
    assert abs(z) < 5.0, (pj, pt, z)


def test_unported_entry_points_raise():
    """The record entry points need save_photons=True (as in the JAX
    package); a mesh refuses save_photons (ROADMAP C2: the JAX sharded
    propagate returns no records, tests/test_torch_parallel.py)."""
    sim = SimT(medium=ice_t(device="cpu"), geometry=string_t(device="cpu", **GEO),
               config=CfgT(n_slots=256))
    for fn in (sim.simulate_hits, sim.simulate_photons):
        with pytest.raises(ValueError, match="save_photons=True"):
            fn([], 0)
    with pytest.raises(ValueError, match="C2"):
        SimT(medium=ice_t(device="cpu"), geometry=string_t(device="cpu", **GEO),
             config=CfgT(n_slots=256, save_photons=True),
             mesh=make_mesh(device="cpu"))


def test_fused_backend_on_cpu_runs_plain_version():
    """backend='fused' drives the kernel's call loop; on CPU tensors every
    call runs the plain version, and the counters come back."""
    sim = SimT(medium=ice_t(device="cpu", b400=0.04, a_dust400=0.006),
               geometry=string_t(device="cpu", **GEO), config=CfgT(n_slots=2048),
               backend="fused")
    res = sim.simulate([cascade(PartT, PTT)], seed=3)
    diag = res.diagnostics
    assert diag["generated"] == float(res.n_generated) > 0
    assert diag["abandoned"] == 0 and diag["dropped"] == 0
    assert float(res.hist.double().sum()) == pytest.approx(
        float(res.weight_hits), rel=1e-4)
