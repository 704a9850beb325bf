"""Tabulated media (K1 B7) through the port against clsim_tpu: the port's
engine against the JAX engine and the kernel's plain version against the
JAX Pallas kernel in interpret mode, on tests/test_kernel.py's workload
(N = 2048, T = 16) in Antares sea water (the setup of
test_kernel_water_medium_matches_engine) and in a photonics-table ice, on
a shared uniform stream with tests/test_kernel.py::_compare's tolerances;
then tests/test_antares.py's beam attenuation and end-to-end hits through
the port."""

import dataclasses

import numpy as np
import pytest
import torch

import test_kernel as TK
from test_engine import _beam_steps, _spectra
from test_torch_engine import compare, port_inputs
from test_torch_media import photonics_text

from clsim_tpu.medium.antares import make_antares_water as water_j
from clsim_tpu.medium.photonics import parse_photonics_ice_table as phot_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.propagate import kernel as KJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.geometry import build_geometry
from clsim_tpu_torch.hits.acceptance import (antares_om_acceptance,
                                             antares_om_angular_sensitivity)
from clsim_tpu_torch.hits.mcpe import mcpes_to_numpy, sample_mcpes
from clsim_tpu_torch.medium.antares import make_antares_water
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)


def media_workload(kind):
    """The test_kernel workload in Antares water (120 m segments, the
    medium's own Cherenkov spectrum) or in a 10-layer photonics table over
    the workload's depths."""
    _, geo, _, cfg, steps, u = TK._workload()
    medium = (water_j() if kind == "water"
              else phot_j(photonics_text(z_start=-300.0)))
    spectra = stack_spectra([make_cherenkov_spectrum(
        medium.ref_index, medium.min_wlen, medium.max_wlen)])
    cfg = dataclasses.replace(cfg, max_segment_m=120.0)
    return medium, geo, spectra, cfg, steps, u


@pytest.mark.parametrize("kind", ["water", "photonics"])
def test_engine_matches_jax_engine(kind):
    inputs = media_workload(kind)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    _, acc_j = TK._run_engine_with_uniforms(steps_j, medium_j, geo_j,
                                            spectra_j, cfg_j, u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    res = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
    compare(acc_j.n_generated, acc_j.n_hits, acc_j.hist,
            res.n_generated, res.n_hits, res.hist)


@pytest.mark.parametrize("kind", ["water", "photonics"])
def test_plain_version_matches_jax_interpret_kernel(kind):
    inputs = media_workload(kind)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    assert KJ.fused_supported(medium_j, spectra_j, cfg_j) is None
    res_j, tot_j = TK._run_kernel(steps_j, medium_j, geo_j, spectra_j, cfg_j,
                                  u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    assert KT.fused_supported(medium, spectra, cfg) is None
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    assert KT.spec_unsupported(spec) is None
    assert KT.kernel_med(spec) == (KT.MED_WATER if kind == "water"
                                   else KT.MED_TABLES)
    assert spec.ref_table == (kind == "photonics")
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    assert tables.wtab.shape == (6 if spec.ref_table else 4, spec.n_wtab)
    state, hist, cnt = KT.run_fused_iterations(
        KT.init_state(steps), KT.pack_steps(steps), tables, spec, uniforms=u)
    compare(tot_j[KJ.CNT_GEN], tot_j[KJ.CNT_HITS], res_j.hist,
            cnt[KT.CNT_GEN], cnt[KT.CNT_HITS], hist)
    assert float(cnt[KT.CNT_DROPPED]) == 0.0
    # the bound's counts: water's scatters, of which the u5 < liu_fraction
    # share drew Rayleigh (within 5 sigma of the binomial); the photonics
    # ice (Liu/HG) counts none, nor do its SubPlans count global-plan work
    n_scat, n_ray = float(cnt[KT.CNT_SCAT]), float(cnt[KT.CNT_RAYLEIGH])
    f = float(medium.scattering.liu_fraction)
    if kind == "water":
        assert n_scat > 1000
        assert abs(n_ray / n_scat - f) < 5 * np.sqrt(f * (1 - f) / n_scat)
    else:
        assert n_scat == n_ray == 0
    assert float(cnt[KT.CNT_CAND:KT.CNT_SCAT].sum()) == 0


def test_beam_attenuation_in_water():
    """tests/test_antares.py::test_beam_attenuation_in_water through the
    port: straight-line survival through scatter-free water follows the
    tabulated absorption at the sampled wavelength (rel 0.07)."""
    m = make_antares_water(device="cpu")
    m = m._replace(water_scat_inv=torch.full_like(m.water_scat_inv, 1e-9))
    d = 40.0
    geo = build_geometry([1], [1], [d], [0.0], [0.0], oversize=5.0,
                         device="cpu")
    spectra = C.spectra_from_numpy(C.numpy_tree(_spectra(mono_wlen=470.0)),
                                   device="cpu")
    cfg = PropagationConfig(n_slots=256)
    steps = C.steps_from_numpy(C.numpy_tree(_beam_steps(cfg.n_slots, 32)),
                               device="cpu")
    res = ET.propagate(steps, m, geo, spectra, 4, cfg)
    inv = float(m.abs_coeffs(torch.tensor(470.0))[1])
    r_entry = d - geo.collision_radius
    assert float(res.n_hits) / float(res.n_generated) == pytest.approx(
        np.exp(-r_entry * inv), rel=0.07)


def test_antares_end_to_end_hits():
    """tests/test_antares.py::test_antares_end_to_end_hits through the
    port: a beam through Antares water onto a storey of OMs, records ->
    MCPEs with the Antares acceptance and the Spring09 angular curve with
    its cutoff: 0 < MCPEs < hits."""
    medium = make_antares_water(device="cpu")
    geo = build_geometry([0, 0, 1], [0, 1, 0], [40.0, 40.0, 40.0],
                         [0.0, 0.0, 6.0], [0.0, -12.0, 1.0], oversize=8.0,
                         device="cpu")
    cfg = PropagationConfig(n_slots=512, pancake_factor=1.0,
                            hist_t_min=0.0, hist_t_max=1500.0,
                            hist_n_bins=50, max_layer_steps=4,
                            max_segment_m=60.0, save_photons=True,
                            photon_capacity_per_slot=4)
    spectra = C.spectra_from_numpy(C.numpy_tree(_spectra()), device="cpu")
    steps = C.steps_from_numpy(C.numpy_tree(_beam_steps(cfg.n_slots, 16)),
                               device="cpu")
    res = ET.propagate(steps, medium, geo, spectra, 9, cfg)
    assert float(res.n_hits) > 100
    mcpes = sample_mcpes(res.rec, res.rec_count,
                         torch.Generator().manual_seed(1),
                         antares_om_acceptance(device="cpu"),
                         antares_om_angular_sensitivity("Spring09",
                                                        device="cpu"),
                         pmt_axis=(0.0, 0.0, -1.0))
    dom, t, ident = mcpes_to_numpy(mcpes)
    assert 0 < dom.shape[0] < float(res.n_hits)
    assert (t >= 0).all()


def test_fused_call_loop_drains_in_water_on_cpu():
    """The fused call loop in water on CPU tensors (the plain version per
    call, global plan on a surveyed geometry): every photon generated,
    nothing abandoned, the histogram sums to the hit weight."""
    from test_torch_collision import jittered, quiet
    medium, geo, spectra, cfg, steps, u = media_workload("water")
    st, md, gt, sp, cf, _ = port_inputs(medium, jittered(geo), spectra, cfg,
                                        steps, u)
    res, tot = quiet(KT.propagate_fused, st, md, gt, sp, 3, cf,
                     iters_per_call=64, max_calls=64)
    assert float(tot[KT.CNT_GEN]) == float(st.num_photons.sum())
    assert float(tot[KT.CNT_ALIVE]) == 0.0
    assert float(tot[KT.CNT_HITS]) > 20
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(res.weight_hits), rtol=1e-5)
