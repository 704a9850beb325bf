"""The deposit modes on the global collision plans and the tabulated media
(K1·B3/B7 × B6/B8b) in the port against clsim_tpu: the kernel's plain
version (the fused call loop on CPU tensors, with the kernel's own plan and
tables) against the JAX engine on tests/test_kernel.py's shared stream
(N = 2048, T = 16) for the expected estimator (soft binning, angular
polynomial), non-stopping detect and the fixed horizon, on a global affine
plan (tests/test_kernel.py::test_kernel_nonuniform_z_geometry's two
ladders), the general plan (a surveyed, jittered geometry), in sea water and
in a photonics table; then propagate_expected_diff's gradient and one
IceFit step with the fused forward on a global-plan geometry, with one and
two stacked spectra, against the JAX diff (tests/test_diff.py's workload,
N = 512, T = 12).

Tolerances: tests/test_kernel.py::_compare's (equal generated counts, hits
within max(2, 1%), histogram L1 <= 2e-3 of the total), the summed deposited
weight within rel 1e-4 (float32 sums in another order); the diff's
tests/test_torch_diff.py tolerances (primal L1 <= 4e-3, gradient rel 1e-4
against JAX, rel 1e-5 against the port engine's own autograd, rel 0.02
against central differences of the forward); IceFit's fused step against
its engine step as tests/test_torch_fit.py holds it (rel 1e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_diff as TD
import test_kernel as TK
from test_torch_collision import jittered, quiet, two_ladders
from test_torch_engine import compare, port_inputs
from test_torch_media import photonics_text

from clsim_tpu.medium.antares import make_antares_water as water_j
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX as REF_J
from clsim_tpu.medium.photonics import parse_photonics_ice_table as phot_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.propagate.diff import propagate_expected_diff as ped_j
from clsim_tpu.sources.flasher import led_spectrum as led_j
from clsim_tpu_torch.parallel import mesh as M
from clsim_tpu_torch.propagate import diff as DT
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT

torch.set_num_threads(1)

KEY = (0, 9)
EXPECTED = dict(estimator="expected", soft_binning=True,
                expected_angular_poly=(0.3, 0.6), fixed_abs_lens=8.0)
MODES = {"expected": (EXPECTED, KT.DEP_EXPECTED),
         "nonstopping": (dict(stop_on_detection=False), KT.DEP_PASS),
         "fixed_abs": (dict(fixed_abs_lens=8.0),
                       KT.DEP_STOP | KT.MODE_FIXED),
         "nonstopping_fixed": (dict(stop_on_detection=False,
                                    fixed_abs_lens=8.0),
                               KT.DEP_PASS | KT.MODE_FIXED)}
GEOMETRIES = {"two_ladders": (two_ladders, KT.COLL_AFFINE),
              "jittered": (jittered, KT.COLL_GENERAL)}
MEDIA = {"ice": KT.MED_CLOSED, "water": KT.MED_WATER,
         "photonics": KT.MED_TABLES}


def workload(mode, geometry, medium):
    """tests/test_kernel.py's workload (anisotropy and tilt on in the
    layered ice) on a global-plan geometry, in the given medium (water and
    the photonics table as tests/test_torch_water.py builds them: 120 m
    segments, the medium's own Cherenkov spectrum) and deposit mode."""
    ice = medium == "ice"
    medium_j, geo0, spectra, cfg, steps, u = TK._workload(aniso=ice,
                                                          tilt=ice)
    if not ice:
        medium_j = (water_j() if medium == "water"
                    else phot_j(photonics_text(z_start=-300.0)))
        spectra = stack_spectra([make_cherenkov_spectrum(
            medium_j.ref_index, medium_j.min_wlen, medium_j.max_wlen)])
        cfg = dataclasses.replace(cfg, max_segment_m=120.0)
    cfg = dataclasses.replace(cfg, **MODES[mode][0])
    return (medium_j, GEOMETRIES[geometry][0](geo0), spectra, cfg, steps, u)


@pytest.mark.parametrize("mode,geometry,medium", [
    ("expected", "two_ladders", "ice"),
    ("expected", "jittered", "ice"),
    ("expected", "jittered", "water"),
    ("expected", "two_ladders", "photonics"),
    ("nonstopping", "two_ladders", "ice"),
    ("fixed_abs", "two_ladders", "ice"),
    ("nonstopping_fixed", "jittered", "water"),
])
def test_plain_deposit_modes_on_global_plans_match_jax_engine(
        mode, geometry, medium):
    """Each (mode, plan, medium) is its own instantiation (kernel_mode's
    DEP, FIXED, COLL and MED bits), served by the spec gate; the plain
    version with the kernel's plan and tables reproduces the JAX engine on
    the shared stream."""
    inputs = workload(mode, geometry, medium)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    _, acc_j = quiet(TK._run_engine_with_uniforms, steps_j, medium_j, geo_j,
                     spectra_j, cfg_j, u_j)
    steps, md, geo, spectra, cfg, u = port_inputs(*inputs)
    spec, _ = quiet(KT.fused_spec, md, geo, spectra, cfg, TK.N, TK.T)
    assert KT.spec_unsupported(spec) is None
    assert KT.kernel_mode(spec) == (MODES[mode][1]
                                    | GEOMETRIES[geometry][1] << KT.COLL_SHIFT
                                    | MEDIA[medium] << KT.MED_SHIFT)
    res, totals = quiet(KT.propagate_fused, steps, md, geo, spectra, 0, cfg,
                        iters_per_call=TK.T, max_calls=1, uniforms=u)
    compare(acc_j.n_generated, acc_j.n_hits, acc_j.hist,
            res.n_generated, res.n_hits, res.hist)
    np.testing.assert_allclose(float(res.weight_hits),
                               float(acc_j.weight_hits), rtol=1e-4)
    assert float(totals[KT.CNT_DROPPED]) == 0.0
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(totals[KT.CNT_WSUM]), rtol=1e-5)
    if cfg.estimator == "expected":
        # survival weights: every deposit is below its photon's w0
        assert 0.0 < float(res.weight_hits) < float(res.n_hits) * 1.01


# ---------------------------------------------------------------------------
# the fit's forward and gradient on a global plan, one and two spectra
# ---------------------------------------------------------------------------

def diff_setup(n_tables):
    """tests/test_diff.py's workload on its strings laid out as two ladders
    (the global affine plan, COLL 1, the plan of IceCube at the default
    configuration); with two tables half the slots are 405 nm LED photons
    (source_type 1)."""
    medium, geo0, spectra, cfg, steps = TD._setup()
    geo = two_ladders(geo0)
    if n_tables == 2:
        spectra = stack_spectra([make_cherenkov_spectrum(REF_J, 265.0, 675.0),
                                 led_j(405)])
        st = np.zeros(TD.N, np.int32)
        st[TD.N // 2:] = 1
        steps = steps._replace(source_type=jnp.asarray(st))
    jax_inputs = (medium, geo, spectra, cfg, steps)
    st, m, g, sp, c, _ = port_inputs(*jax_inputs,
                                     np.zeros((1, 8, 1), np.float32))
    return jax_inputs, (st, m, g, sp, c)


@pytest.mark.parametrize("n_tables", [1, 2])
def test_expected_diff_gradient_on_global_plan_matches_jax(n_tables):
    """propagate_expected_diff on the global affine plan: the forward (the
    kernel's plain version) against the JAX diff's interpret kernel, the
    a_dust400 gradient (engine autograd) against JAX's, the port engine's
    own and central differences of the forward."""
    (medium_j, geo_j, spectra_j, cfg_j, steps_j), (st, m, g, sp, c) = \
        diff_setup(n_tables)
    spec, _ = quiet(KT.fused_spec, m, g, sp, c, TD.N, TD.T, threefry=True)
    assert KT.spec_unsupported(spec) is None
    assert (spec.n_tables, KT.kernel_mode(spec)) == (
        n_tables, KT.DEP_EXPECTED | KT.MODE_THREEFRY
        | KT.COLL_AFFINE << KT.COLL_SHIFT)
    key_j = jnp.asarray(KEY, jnp.uint32)
    proj = np.random.default_rng(2).random(
        (geo_j.n_doms, cfg_j.hist_n_bins)).astype(np.float32)
    a0 = 0.01
    hj = np.asarray(quiet(ped_j, steps_j, medium_j, geo_j, spectra_j, key_j,
                          cfg_j, n_iterations=TD.T, interpret=True),
                    np.float64)
    ht = quiet(DT.propagate_expected_diff, st, m, g, sp, KEY, c,
               n_iterations=TD.T).double().numpy()
    assert hj.sum() > 1.0
    assert np.abs(hj - ht).sum() <= 4e-3 * hj.sum()

    def loss_j(a):
        mm = medium_j._replace(a_dust400=jnp.full(4, a, jnp.float32))
        return jnp.sum(ped_j(steps_j, mm, geo_j, spectra_j, key_j, cfg_j,
                             n_iterations=TD.T, interpret=True) * proj)

    def loss_t(a, fn):
        return (fn(m._replace(a_dust400=torch.ones(4) * a)) *
                torch.as_tensor(proj)).sum()

    fused = lambda mm: quiet(DT.propagate_expected_diff, st, mm, g, sp, KEY,
                             c, n_iterations=TD.T)
    engine = lambda mm: ET.propagate(st, mm, g, sp, 0, c,
                                     max_iterations=TD.T, key=KEY).hist
    g_j = float(quiet(jax.grad(loss_j), jnp.float32(a0)))
    grads = []
    for fn in (fused, engine):
        a = torch.tensor(a0, requires_grad=True)
        grads.append(float(torch.autograd.grad(loss_t(a, fn), a)[0]))
    g_t, g_e = grads
    assert g_t == pytest.approx(g_j, rel=1e-4)
    assert g_t == pytest.approx(g_e, rel=1e-5)
    eps = 2e-4
    with torch.no_grad():
        fd = (float(loss_t(torch.tensor(a0 + eps), fused))
              - float(loss_t(torch.tensor(a0 - eps), fused))) / (2 * eps)
    assert g_t == pytest.approx(fd, rel=0.02)
    assert g_t < 0.0   # more dust -> fewer weighted hits


def test_icefit_fused_step_on_global_plan_with_stacked_spectra():
    """IceFit(forward='fused') on the global affine plan with two stacked
    spectra takes the engine forward's SGD step (the fit of a flash on
    IceCube at the default configuration, at test size)."""
    _, (st, m, g, sp, c) = diff_setup(2)
    a0 = np.full(4, 0.012, np.float32)
    target = ET.propagate(st, m, g, sp, 0, c, max_iterations=TD.T,
                          key=KEY).hist
    out = {}
    for forward in ("engine", "fused"):
        fit = M.IceFit(c, g, sp, max_iterations=TD.T, learning_rate=1e-4,
                       forward=forward)
        params, loss = quiet(fit.step, {"a_dust400": a0}, m, st, KEY, target)
        out[forward] = (params["a_dust400"].numpy(), float(loss))
    (pe, le), (pf, lf) = out["engine"], out["fused"]
    assert np.isfinite(lf) and lf > 0.0
    assert lf == pytest.approx(le, rel=1e-4)
    assert np.abs(pf - a0).max() > 0.0
    np.testing.assert_allclose(pf - a0, pe - a0, rtol=1e-4, atol=1e-12)
