"""The port's float64 oracle (validate/oracle.py) against the JAX package's
(clsim_tpu/validate/oracle.py): tests/test_oracle.py's workload (tilt +
anisotropy, pancake 4) cut to ~2,000 photons, carried across to the port's
containers; with the same numpy rng both oracles give the same histogram,
hit count, weight sum and per-hit weights, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from clsim_tpu.geometry import hexagonal_geometry
from clsim_tpu.hits.acceptance import icecube_dom_acceptance
from clsim_tpu.medium.anisotropy import AnisotropyParams
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.medium.tilt import TiltParams
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum
from clsim_tpu.types import PropagationConfig as CfgJ
from clsim_tpu.types import StepBatch
from clsim_tpu.validate import oracle as OJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.types import PropagationConfig as CfgT
from clsim_tpu_torch.validate import oracle as OT

N_STEPS, PHOTONS_PER_STEP = 512, 4


def workload(bias):
    r = np.random.default_rng(5)
    medium = make_homogeneous_ice(n_layers=14, z_start=-350.0,
                                  layer_height=50.0)
    medium = medium._replace(
        b400=jnp.asarray(0.015 + 0.03 * r.random(14), jnp.float32),
        a_dust400=jnp.asarray(0.003 + 0.006 * r.random(14), jnp.float32),
        delta_tau=jnp.asarray(0.5 + r.random(14), jnp.float32),
        anisotropy=AnisotropyParams(
            azimuth=jnp.float32(3.9), mag_along=jnp.float32(0.04),
            mag_perp=jnp.float32(-0.08), enabled=True),
        tilt=TiltParams(
            distances=jnp.asarray([-900.0, -250.0, 350.0, 1000.0]),
            first_z=jnp.float32(-450.0), z_spacing=jnp.float32(110.0),
            z_corrections=jnp.asarray(15.0 * r.standard_normal((4, 9)),
                                      jnp.float32),
            azimuth_cos=jnp.float32(np.cos(3.93)),
            azimuth_sin=jnp.float32(np.sin(3.93)), enabled=True))
    geo = hexagonal_geometry(n_rings=1, string_spacing=70.0,
                             doms_per_string=12, dom_spacing=16.0,
                             z_top=90.0, oversize=9.0)
    if bias:
        acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                     efficiency=1.0)
        nb = np.asarray(acc.values).shape[0]
        spec = make_cherenkov_spectrum(
            DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
            bias_wlen_nm=float(acc.first_x) + float(acc.dx) * np.arange(nb),
            bias_values=np.asarray(acc.values))
    else:
        spec = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    cfg = dict(n_slots=N_STEPS, pancake_factor=4.0, hist_t_min=0.0,
               hist_t_max=2000.0, hist_n_bins=50, max_layer_steps=8,
               max_segment_m=120.0, stop_on_detection=True)
    rr = np.random.default_rng(77)
    costh = rr.uniform(-1, 1, N_STEPS)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, N_STEPS)
    full = lambda v, dt=np.float32: np.full(N_STEPS, v, dt)
    steps = StepBatch(
        x=full(9.0), y=full(-4.0), z=full(13.0), t=full(0.0),
        dir_x=(sinth * np.cos(phi)).astype(np.float32),
        dir_y=(sinth * np.sin(phi)).astype(np.float32),
        dir_z=costh.astype(np.float32), length=full(3.0), beta=full(1.0),
        num_photons=full(PHOTONS_PER_STEP, np.int32), weight=full(1.0),
        identifier=full(0, np.int32), source_type=full(0, np.int32))
    return medium, geo, spec, cfg, steps


@pytest.mark.parametrize("bias", [False, True])
def test_oracle_propagate_matches_jax_exactly(bias):
    medium, geo, spec, cfg, steps = workload(bias)
    spectrum_xy = (np.asarray(spec.x), np.asarray(spec.beta))
    bias_xy = (np.asarray(spec.bias_x), np.asarray(spec.bias_y))
    out_j = OJ.oracle_propagate(steps, medium, geo, spectrum_xy, bias_xy,
                                CfgJ(**cfg), np.random.default_rng(123),
                                photons_per_step=PHOTONS_PER_STEP,
                                collect_weights=True)
    medium_t = C.medium_from_numpy(C.numpy_tree(medium), device="cpu")
    geo_t = C.geometry_from_numpy(C.numpy_tree(geo), device="cpu")
    steps_t = C.steps_from_numpy(steps._asdict(), device="cpu")
    out_t = OT.oracle_propagate(steps_t, medium_t, geo_t, spectrum_xy,
                                bias_xy, CfgT(**cfg),
                                np.random.default_rng(123),
                                photons_per_step=PHOTONS_PER_STEP,
                                collect_weights=True)
    hist_j, hits_j, w_j, wts_j, bins_j = out_j
    hist_t, hits_t, w_t, wts_t, bins_t = out_t
    assert hits_t == hits_j > 5
    assert w_t == w_j
    assert hist_t.tobytes() == hist_j.tobytes()
    assert wts_t.tobytes() == wts_j.tobytes()
    assert bins_t.tobytes() == bins_j.tobytes()
