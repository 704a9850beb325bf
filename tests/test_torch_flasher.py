"""LED flasher runs (K1·B4) through the port against clsim_tpu: the flasher
steps byte for byte, the stacked-spectrum dispatch and the non-uniform bias
grid of the kernel's plain version and the port's engine against the JAX
engine on tests/test_kernel.py's shared stream (N = 2048, T = 16), the
kernel spec and tables, the config3_flasher golden through the port's
engine, and the port's refusal of a source_type without a stacked
spectrum, where the JAX package samples the Cherenkov spectrum or returns
NaN.

Tolerances: tests/test_kernel.py::_compare's (equal generated counts, hits
within max(2, 1%), histogram L1 <= 2e-3 of the total); L1 <= 4e-3 on the
non-uniform bias (tests/test_kernel.py:554-575); the golden's contract
(compare_to_golden: exact n_generated, L1 <= 1e-3)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_kernel as TK
from test_torch_engine import compare, port_inputs
from test_torch_sources import assert_batches_equal

from clsim_tpu.geometry import hexagonal_geometry as hex_j
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX as REF_J
from clsim_tpu.ops import spectrum as SJ
from clsim_tpu.propagate import kernel as KJ
from clsim_tpu.sources import flasher as FJ
from clsim_tpu.sources import flasher_extras as XJ
from clsim_tpu.sources import particles as PJ
from clsim_tpu.types import PropagationConfig as CfgJ
from clsim_tpu.util.golden import CONFIGS, GOLDEN_SEED, compare_to_golden

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.api import Simulation
from clsim_tpu_torch.geometry import hexagonal_geometry as hex_t
from clsim_tpu_torch.geometry import single_string_geometry
from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX as REF_T
from clsim_tpu_torch.medium.properties import make_homogeneous_ice
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.ops import spectrum as ST
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.sources import flasher as FT
from clsim_tpu_torch.sources import flasher_extras as XT
from clsim_tpu_torch.sources import particles as PT
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(2)

BIAS_X = np.arange(260.0, 690.0, 10.0)
BIAS_Y = np.linspace(0.2, 1.0, BIAS_X.size)
LEDS = (405, 340, 370, 450, 505)
LED_INDEX = {w: i + 1 for i, w in enumerate(LEDS)}


# ---------------------------------------------------------------------------
# a source_type without a stacked spectrum (fixed in the port)
# ---------------------------------------------------------------------------

def test_jax_samples_cherenkov_or_nan_for_a_source_type_without_spectrum():
    """The divergence the port fixes.  With one stacked spectrum the JAX
    package's sample_wavelength_dispatch ignores source_type and samples
    the Cherenkov spectrum (clsim_tpu/ops/spectrum.py:172-174); with two, a
    source_type of 2 gives NaN wavelengths.  The port refuses both on the
    host (ops/spectrum.check_source_types, see below)."""
    cher = SJ.make_cherenkov_spectrum(REF_J, 265.0, 675.0)
    led = FJ.led_spectrum(405)
    u = jnp.asarray([0.5, 0.1, 0.01, 0.001], jnp.float32)
    one = SJ.stack_spectra([cher])
    as_led = np.asarray(SJ.sample_wavelength_dispatch(
        one, jnp.ones(4, jnp.int32), u))
    as_cher = np.asarray(SJ.sample_wavelength_dispatch(
        one, jnp.zeros(4, jnp.int32), u))
    np.testing.assert_array_equal(as_led, as_cher)
    assert as_cher.min() >= 265.0 and as_cher.max() <= 675.0
    two = SJ.stack_spectra([cher, led])
    past = np.asarray(SJ.sample_wavelength_dispatch(
        two, jnp.full(4, 2, jnp.int32), u))
    assert np.isnan(past).all()
    for n_tables, bad in ((1, 1), (2, 2)):
        with pytest.raises(ValueError, match=f"source_type {bad}.*only "
                           f"{n_tables} spectra"):
            ST.check_source_types(0, bad, n_tables)
    ST.check_source_types(0, 1, 2)


@pytest.mark.parametrize("n_tables", [1, 2])
@pytest.mark.parametrize("entry", ["engine", "fused"])
def test_port_refuses_a_source_type_without_spectrum(entry, n_tables):
    """engine.propagate and kernel.propagate_fused raise ValueError, naming
    the fix, for a step whose source_type has no stacked spectrum (with one
    table too); the CUDA kernel is never reached."""
    steps, medium, geo, _, cfg, u = port_inputs(*TK._workload())
    spectra = ST.stack_spectra(
        [ST.make_cherenkov_spectrum(REF_T, 265.0, 675.0)]
        + [FT.led_spectrum(405)] * (n_tables - 1), device="cpu")
    steps = steps._replace(source_type=torch.full_like(steps.source_type,
                                                       n_tables))
    with pytest.raises(ValueError, match="stack the LED spectrum"):
        if entry == "engine":
            ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
        else:
            KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                               iters_per_call=TK.T, max_calls=1, uniforms=u)


def test_simulation_refuses_a_flasher_pulse_without_led_spectra():
    """The user error behind the fault: a FlasherPulse (spectrum_index 1 by
    default) given to a Simulation built without flasher_spectra.  The
    Simulation checks the host steps before they are uploaded."""
    sim = Simulation(medium=make_homogeneous_ice(device="cpu"),
                     geometry=single_string_geometry(device="cpu"),
                     config=PropagationConfig(n_slots=256))
    pulse = PT.FlasherPulse(x=0.0, y=0.0, z=0.0, time=0.0, dir_x=1.0,
                            dir_y=0.0, dir_z=0.0, num_photons_no_bias=1e3)
    with pytest.raises(ValueError, match="spectrum_index"):
        sim.simulate([pulse], seed=1)


# ---------------------------------------------------------------------------
# flasher steps byte for byte
# ---------------------------------------------------------------------------

def _pulses(P, X, kind, geo):
    if kind == "led":
        return [P.FlasherPulse(x=3.0, y=-2.0, z=-30.0, time=5.0, dir_x=0.8,
                               dir_y=0.0, dir_z=0.6,
                               num_photons_no_bias=2.5e5,
                               angular_smear_polar=0.2,
                               angular_smear_azimuthal=0.3,
                               pulse_width=20.0, spectrum_index=1)]
    if kind == "cone":
        return [P.FlasherPulse(x=0.0, y=0.0, z=10.0, time=0.0, dir_x=0.0,
                               dir_y=0.0, dir_z=1.0,
                               num_photons_no_bias=4e6,
                               angular_smear_polar=0.7,
                               angular_smear_azimuthal=2 * np.pi,
                               pulse_width=4.0, spectrum_index=1,
                               emission_mode="cone")]
    if kind == "standard_dom":
        return X.flasher_info_to_pulses(X.fake_flasher_info(1, 30), geo,
                                        photons_at_max_brightness=1e5)
    if kind == "color_dom":
        return X.flasher_info_to_pulses(
            X.fake_flasher_info(14, 8, mask=0xFFF), geo, LED_INDEX,
            photons_at_max_brightness=1e5)
    return X.standard_candle_pulses(1, photons_per_pulse=3e7)


@pytest.mark.parametrize("kind", ["led", "cone", "standard_dom", "color_dom",
                                  "standard_candle"])
def test_flasher_steps_byte_for_byte(kind):
    """FlasherPulses (LED and cone mode), flasher_info_to_pulses (a
    standard DOM's six LEDs and a color DOM's twelve) and Standard Candle 1
    give the same pulses and, for a fixed numpy seed, the same StepBatches
    in both packages."""
    kw = dict(n_rings=2, string_spacing=125.0, doms_per_string=60,
              dom_spacing=17.0, z_top=500.0, oversize=5.0)
    geo_j, geo_t = hex_j(**kw), hex_t(device="cpu", **kw)
    pj, pt = _pulses(PJ, XJ, kind, geo_j), _pulses(PT, XT, kind, geo_t)
    assert [vars(p) for p in pj] == [vars(p) for p in pt]
    gj = FJ.FlasherStepGenerator(SJ.make_cherenkov_spectrum(
        REF_J, 265.0, 675.0, BIAS_X, BIAS_Y))
    gt = FT.FlasherStepGenerator(ST.make_cherenkov_spectrum(
        REF_T, 265.0, 675.0, BIAS_X, BIAS_Y))
    rj, rt = np.random.default_rng(31), np.random.default_rng(31)
    bj = [b for i, p in enumerate(pj) for b in gj.convert(p, i, rj)]
    bt = [b for i, p in enumerate(pt) for b in gt.convert(p, i, rt)]
    assert_batches_equal(bj, bt)
    if kind == "color_dom":
        assert {int(b.source_type[0]) for b in bt} == {2, 3, 4, 5}


def test_flasher_info_to_pulses_reads_a_geometry_numpy_cannot():
    """The port's geometry lives on the card, where np.asarray cannot read
    its tensors; flasher_info_to_pulses reads them through
    geometry.to_numpy.  Tensors that require grad stand in for the card's
    here (np.asarray refuses them as well)."""
    geo = hex_t(device="cpu", n_rings=1, doms_per_string=60,
                dom_spacing=17.0, z_top=500.0, oversize=5.0)
    held = geo._replace(**{f: getattr(geo, f).float().requires_grad_(True)
                           for f in ("dom_x", "dom_y", "dom_z")})
    with pytest.raises(RuntimeError):
        np.asarray(held.dom_x)
    info = XT.fake_flasher_info(1, 30)
    assert [vars(p) for p in XT.flasher_info_to_pulses(info, held)] == \
        [vars(p) for p in XT.flasher_info_to_pulses(info, geo)]


# ---------------------------------------------------------------------------
# the stacked-spectrum dispatch and the non-uniform bias on the shared stream
# ---------------------------------------------------------------------------

def _flasher_workload():
    """tests/test_kernel.py::test_kernel_flasher_spectrum_dispatch's inputs:
    aniso + tilt, half the slots source_type 1 with a narrow 405 nm LED."""
    medium, geo, _, cfg, steps, u = TK._workload(aniso=True, tilt=True)
    wl = np.linspace(380.0, 430.0, 11)
    led = SJ.make_tabulated_spectrum(wl, np.exp(-0.5 * ((wl - 405) / 10) ** 2))
    spectra = SJ.stack_spectra([SJ.make_cherenkov_spectrum(REF_J, 265.0,
                                                           675.0), led])
    st = np.zeros(TK.N, np.int32)
    st[TK.N // 2:] = 1
    return medium, geo, spectra, cfg, steps._replace(
        source_type=jnp.asarray(st)), u


def _bias_workload():
    """tests/test_kernel.py::test_kernel_nonuniform_bias's inputs: a
    geomspace bias grid of 23 points."""
    medium, geo, _, cfg, steps, u = TK._workload()
    bx = np.geomspace(265.0, 675.0, 23)
    by = 0.2 + 0.15 * np.sin(np.linspace(0, 5, 23)) ** 2
    spectra = SJ.stack_spectra([SJ.make_cherenkov_spectrum(
        REF_J, 265.0, 675.0, bias_wlen_nm=bx, bias_values=by)])
    return medium, geo, spectra, cfg, steps, u


@pytest.mark.parametrize("workload,tol", [(_flasher_workload, 2e-3),
                                          (_bias_workload, 4e-3)])
@pytest.mark.parametrize("path", ["plain", "engine"])
def test_flasher_dispatch_and_bias_match_jax_engine(workload, tol, path):
    """The kernel's plain version (the kernel's spec and tables: stacked
    spectra, the bias table) and the port's engine against the JAX engine
    on the same stream."""
    inputs = workload()
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    _, acc_j = TK._run_engine_with_uniforms(steps_j, medium_j, geo_j,
                                            spectra_j, cfg_j, u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    if path == "engine":
        res = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
        gen, hits, hist = res.n_generated, res.n_hits, res.hist
    else:
        spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
        assert KT.spec_unsupported(spec) is None
        assert KT.kernel_mode(spec) == 0
        assert (spec.n_tables, spec.bias_uniform) == (
            (2, True) if workload is _flasher_workload else (1, False))
        tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
        _, hist, cnt = KT.run_fused_iterations(
            KT.init_state(steps), KT.pack_steps(steps), tables, spec,
            uniforms=u)
        gen, hits = cnt[KT.CNT_GEN], cnt[KT.CNT_HITS]
    compare(acc_j.n_generated, acc_j.n_hits, acc_j.hist, gen, hits, hist,
            tol=tol)


# ---------------------------------------------------------------------------
# the kernel's spec and tables
# ---------------------------------------------------------------------------

def _spectra_j(n_tables, uniform):
    bias = {} if uniform else dict(
        bias_wlen_nm=np.geomspace(265.0, 675.0, 23),
        bias_values=0.2 + 0.15 * np.sin(np.linspace(0, 5, 23)) ** 2)
    cher = SJ.make_cherenkov_spectrum(REF_J, 265.0, 675.0, **bias)
    return SJ.stack_spectra([cher] + [FJ.led_spectrum(w)
                                      for w in LEDS[:n_tables - 1]])


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("n_tables", [1, 2, 6])
def test_spec_and_tables_of_stacked_spectra(n_tables, uniform):
    """fused_spec's n_tables, n_spec, n_bias and bias_uniform equal the JAX
    _build_spec's; the (n_tables, 3, n_spec) spectrum table holds every
    stacked spectrum and the (2, n_bias) bias table the grid."""
    medium_j, geo_j, _, cfg_j, _, _ = TK._workload()
    spectra_j = _spectra_j(n_tables, uniform)
    _, plan_j = KJ.plan_collision(geo_j, cfg_j)
    spec_j = KJ._build_spec(medium_j, geo_j, spectra_j, cfg_j, TK.N, TK.T, 1,
                            32, 1024, 2, True, True, plan=plan_j)
    _, medium, geo, _, cfg, _ = port_inputs(*TK._workload())
    spectra = C.spectra_from_numpy(C.numpy_tree(spectra_j), device="cpu")
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    for f in ("n_tables", "n_spec", "n_bias", "bias_uniform"):
        assert getattr(spec, f) == getattr(spec_j, f), f
    assert spec.n_tables == n_tables and spec.bias_uniform == uniform
    assert KT.spec_unsupported(spec) is None
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    assert tables.spec_tab.shape == (n_tables, 3, spec.n_spec)
    for s in range(n_tables):
        for row, f in enumerate(("x", "acu", "beta")):
            np.testing.assert_array_equal(tables.spec_tab[s, row].numpy(),
                                          np.asarray(getattr(spectra_j, f)[s]))
    np.testing.assert_array_equal(tables.bias_tab.numpy(), np.stack(
        [np.asarray(spectra_j.bias_x), np.asarray(spectra_j.bias_y)]))
    assert KT._params(spec, tables, True, 0, 0).n_tables == n_tables


# ---------------------------------------------------------------------------
# the flasher golden
# ---------------------------------------------------------------------------

def test_config3_flasher_golden_through_port_engine():
    """tests/golden/config3_flasher.npz reproduced through the port's engine
    in key mode, as tests/test_torch_golden.py reproduces config1.  The
    flasher step generator is numpy in both packages, so the port's own
    Simulation makes the slot batches, and they equal the JAX Simulation's
    byte for byte; slot batch i draws the threefry stream of
    fold_in(PRNGKey(seed), i), as the JAX package's run_steps does."""
    sim_j, sources = CONFIGS["config3_flasher"]()
    batches_j = sim_j.steps_from_particles(
        sources, np.random.default_rng(GOLDEN_SEED))
    p = sources[0]
    sim = Simulation(
        medium=make_homogeneous_ice(b400=0.04, a_dust400=0.006,
                                    device="cpu"),
        geometry=single_string_geometry(n_doms=24, spacing=17.0, x=40.0,
                                        z_top=200.0, oversize=5.0,
                                        device="cpu"),
        config=PropagationConfig(n_slots=4096, hist_t_min=0.0,
                                 hist_t_max=3200.0, hist_n_bins=400),
        flasher_spectra=[FT.led_spectrum(405)])
    # the golden was made by the JAX package's construction, which the port
    # repaired (ROADMAP C1): the LED spectrum stacked unbiased and a
    # correction factor of 1, set here on the Simulation on purpose
    sim.spectra = ST.stack_spectra([sim.cherenkov, FT.led_spectrum(405)],
                                   device="cpu")
    sim.flasher_generator.correction_factors = {}
    pulse = PT.FlasherPulse(**vars(p))
    batches = sim.steps_from_particles([pulse],
                                       np.random.default_rng(GOLDEN_SEED))
    assert_batches_equal(batches_j, batches)
    key = rng.base_key(GOLDEN_SEED)
    hist, gen, hits, weight = 0.0, 0.0, 0.0, 0.0
    for i, batch in enumerate(batches):
        steps = C.steps_from_numpy(batch._asdict(), device="cpu")
        res = ET.propagate(steps, sim.medium, sim.geometry, sim.spectra, 0,
                           sim.config, key=rng.fold_in(key, i))
        hist = hist + res.hist.double().numpy()
        gen += float(res.n_generated)
        hits += float(res.n_hits)
        weight += float(res.weight_hits)
    golden = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                       "config3_flasher.npz")))
    compare_to_golden(dict(hist=hist, n_generated=np.asarray(gen),
                           n_hits=np.asarray(hits),
                           weight_hits=np.asarray(weight)), golden)


# ---------------------------------------------------------------------------
# the flasher bias correction (ROADMAP C1, repaired in the port)
# ---------------------------------------------------------------------------

def _c1_pulse(photons):
    """A 405 nm LED 3 m from a DOM of the string, pointed at it."""
    return PT.FlasherPulse(x=0.0, y=0.0, z=-4.0, time=0.0, dir_x=1.0,
                           dir_y=0.0, dir_z=0.0, num_photons_no_bias=photons,
                           angular_smear_polar=0.1,
                           angular_smear_azimuthal=0.1, pulse_width=5.0,
                           spectrum_index=1)


def _c1_sim(package, unweighted):
    """The golden's string 3 m from the flasher: the 405 nm LED stacked
    after the Cherenkov spectrum, weighted or unweighted."""
    if package == "jax":
        from clsim_tpu.api import Simulation as SimJ
        from clsim_tpu.geometry import single_string_geometry as string_j
        from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
        return SimJ(medium=ice_j(b400=0.04, a_dust400=0.006),
                    geometry=string_j(n_doms=24, spacing=17.0, x=3.0,
                                      z_top=200.0, oversize=5.0),
                    config=CfgJ(n_slots=4096),
                    flasher_spectra=[FJ.led_spectrum(405)],
                    unweighted_photons=unweighted)
    return Simulation(
        medium=make_homogeneous_ice(b400=0.04, a_dust400=0.006, device="cpu"),
        geometry=single_string_geometry(n_doms=24, spacing=17.0, x=3.0,
                                        z_top=200.0, oversize=5.0,
                                        device="cpu"),
        config=PropagationConfig(n_slots=4096),
        flasher_spectra=[FT.led_spectrum(405)],
        unweighted_photons=unweighted)


def test_weighted_flash_weight_equals_unweighted():
    """A weighted Simulation samples the LED spectrum with the acceptance
    bias and scales the pulse's photons by the correction factor
    integral(bias * spectrum) / integral(spectrum), so its hit weight (each
    hit 1 / bias) estimates the unweighted hit count: the two agree within
    5 sigma (the weighted sum's sigma from its ~100 hits, each of about the
    mean weight).  Unweighted, the spectrum and the factor stay as given."""
    pulse = _c1_pulse(6e4)
    res_w = _c1_sim("torch", False).simulate([pulse], seed=3)
    res_u = _c1_sim("torch", True).simulate([pulse], seed=3)
    w, hits_w = float(res_w.weight_hits), float(res_w.n_hits)
    u = float(res_u.weight_hits)
    assert float(res_u.n_hits) == u > 1e4      # unit weights
    assert hits_w >= 50
    sigma = np.sqrt(hits_w * (w / hits_w) ** 2 + u)
    assert abs(w - u) < 5 * sigma, (w, u, sigma)


def test_weighted_flash_photons_scaled_by_correction_factor():
    """The weighted n_generated is within 5 sigma (Poisson) of
    num_photons_no_bias x the factor of the 405 nm spectrum, whose value
    (~1.85e-3, the acceptance near 405 nm) the sources' own
    bias_correction_factor gives on the LED's emission table; the
    unweighted Simulation keeps the factor 1 and an unbiased spectrum."""
    sim = _c1_sim("torch", False)
    f = sim.flasher_generator.correction_factors[1]
    led = FT.led_spectrum(405)
    assert f == pytest.approx(FT.bias_correction_factor(
        led.x, led.beta, sim._bias_x, sim._bias_y), rel=1e-6)
    assert 1e-3 < f < 3e-3
    n = 2e6
    res = sim.simulate([_c1_pulse(n)], seed=5)
    mean = n * f
    assert abs(float(res.n_generated) - mean) < 5 * np.sqrt(mean)
    sim_u = _c1_sim("torch", True)
    assert sim_u.flasher_generator.correction_for(_c1_pulse(n)) == 1.0
    np.testing.assert_array_equal(sim_u.spectra.beta[1].numpy(), led.beta)


def test_jax_package_flash_weights_differ_by_inverse_bias():
    """Documents the fault the port repaired (ROADMAP C1): the JAX
    package's weighted Simulation stacks the LED spectrum unbiased and
    builds its FlasherStepGenerator without correction factors, so the
    weighted and unweighted runs propagate the same photons and the weighted
    hit weight is the unweighted one times the mean 1 / bias over the hits,
    ~541 at 405 nm (E_405nm[1 / bias] of the LED's emission spectrum)."""
    pulse = PJ.FlasherPulse(**vars(_c1_pulse(2e4)))
    res_w = _c1_sim("jax", False).simulate([pulse], seed=3)
    res_u = _c1_sim("jax", True).simulate([pulse], seed=3)
    assert float(res_w.n_generated) == float(res_u.n_generated)
    assert float(res_w.n_hits) == float(res_u.n_hits) > 1e3
    ratio = float(res_w.weight_hits) / float(res_u.weight_hits)
    sim = _c1_sim("torch", False)
    led = FT.led_spectrum(405)
    inv_bias = np.sum(led.beta / np.interp(led.x, sim._bias_x, sim._bias_y)
                      ) / np.sum(led.beta)
    assert 500 < ratio < 590 and ratio == pytest.approx(inv_bias, rel=0.1)
