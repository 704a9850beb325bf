"""Every configuration the JAX kernel serves, in the port's fused call loop
(the CUDA kernel's plain version on CPU tensors) against clsim_tpu's Pallas
kernel in interpret mode, on tests/test_kernel.py's workload (N = 2048,
T = 16, anisotropy and tilt on):

  * in-kernel threefry (propagate_fused(threefry_key=)) in stopping,
    non-stopping, fixed-horizon and non-stopping + fixed detect, and with
    records; the port's threefry run against its run fed
    rng.make_uniform_stream of the same key, bit for bit;
  * the expected estimator with the 11-coefficient hole-ice angular
    polynomial (HOLE_ICE_H2_50CM), on a shared stream and with threefry;
  * the closed-form ice with the Antares tabulated scattering angle (the
    kernel's MED_CLOSED_SCAT), in detect and in expected mode;
  * the spec gate on every geometry and ice the repository builds.

Tolerances (tests/test_kernel.py::_compare): equal generated counts, hits
within max(2, 1%), histogram L1 <= 2e-3 of the total; records sorted by
(dom, time) within tests/test_kernel.py:523-529's tolerances."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_kernel as TK
from test_torch_engine import compare, port_inputs
from test_torch_records import REC_TOLS

from clsim_tpu.hits.acceptance import HOLE_ICE_H2_50CM as HOLE_ICE_J
from clsim_tpu.medium.antares import make_antares_water as water_j
from clsim_tpu.propagate import kernel as KJ

from clsim_tpu_torch.hits.acceptance import HOLE_ICE_H2_50CM
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)

KEY = (0x80000001, 77)
DETECT = {
    "stopping": dict(),
    "nonstopping": dict(stop_on_detection=False),
    "fixed": dict(fixed_abs_lens=8.0),
    "nonstopping_fixed": dict(stop_on_detection=False, fixed_abs_lens=8.0),
}
HOLE_ICE = tuple(float(c) for c in HOLE_ICE_H2_50CM["coefficients"])
EXPECTED_HOLE_ICE = dict(estimator="expected", soft_binning=True,
                         fixed_abs_lens=8.0, expected_angular_poly=HOLE_ICE)


def workload(**change):
    medium, geo, spectra, cfg, steps, u = TK._workload(aniso=True, tilt=True)
    return medium, geo, spectra, dataclasses.replace(cfg, **change), steps, u


def jax_kernel(inputs, key=None):
    """The JAX Pallas kernel in interpret mode, one call of T iterations,
    on the workload's stream or (key) in-kernel threefry."""
    medium, geo, spectra, cfg, steps, u = inputs
    if key is None:
        return TK._run_kernel(steps, medium, geo, spectra, cfg, u)
    return KJ.propagate_fused(
        steps, medium, geo, spectra, seed=0, cfg=cfg, iters_per_call=TK.T,
        flush_every=1, queue_rows=32, block_lanes=1024, max_calls=1,
        threefry_key=jnp.asarray(key, jnp.uint32), interpret=True)


def port_fused(inputs, key=None, **kw):
    """The port's fused call loop (the plain version on CPU tensors), one
    call of T iterations, on the workload's stream or (key) threefry."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    src = dict(uniforms=u) if key is None else dict(threefry_key=key)
    return KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                              iters_per_call=TK.T, max_calls=1, **src, **kw)


def compare_runs(res_j, tot_j, res_t, tot_t):
    compare(tot_j[KJ.CNT_GEN], tot_j[KJ.CNT_HITS], res_j.hist,
            tot_t[KT.CNT_GEN], tot_t[KT.CNT_HITS], res_t.hist)
    assert float(tot_t[KT.CNT_DROPPED]) == 0.0
    np.testing.assert_allclose(float(res_t.hist.double().sum()),
                               float(tot_t[KT.CNT_WSUM]), rtol=1e-5)


@pytest.mark.parametrize("mode", list(DETECT))
def test_threefry_detect_matches_jax_interpret_kernel(mode):
    inputs = workload(**DETECT[mode])
    res_j, tot_j = jax_kernel(inputs, KEY)
    res_t, tot_t = port_fused(inputs, KEY)
    compare_runs(res_j, tot_j, res_t, tot_t)
    spec, _ = KT.fused_spec(*port_inputs(*inputs)[1:5], TK.N, TK.T,
                            threefry=True)
    assert KT.spec_unsupported(spec) is None
    assert KT.kernel_mode(spec) & KT.MODE_THREEFRY
    assert not spec.expected
    # the key's stream, materialized and fed: the same numbers, bit for bit
    u = rng.make_uniform_stream(KEY, TK.T, TK.N)
    steps, medium, geo, spectra, cfg, _ = port_inputs(*inputs)
    res_u, tot_u = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                      iters_per_call=TK.T, max_calls=1,
                                      uniforms=u)
    assert torch.equal(res_t.hist, res_u.hist)
    assert torch.equal(tot_t, tot_u)


def test_threefry_records_match_jax_record_loop():
    """Records with threefry (stopping detect): the flat records equal those
    of the JAX package's record call loop (_run_fused_records, fed the key
    table), sorted by (dom, time), within tests/test_kernel.py:523-529's
    tolerances."""
    inputs = workload(save_photons=True)
    res_j, tot_j = jax_kernel(inputs, KEY)
    res_t, tot_t = port_fused(inputs, KEY)
    compare_runs(res_j, tot_j, res_t, tot_t)
    n = int(res_t.rec_count[0])
    assert n == int(res_j.rec_count[0]) == float(tot_t[KT.CNT_HITS]) > 20
    fj = {k: np.asarray(v)[0] for k, v in res_j.rec.items()}
    ft = {k: v[0].numpy() for k, v in res_t.rec.items()}
    oj = np.lexsort((fj["time"], fj["dom"]))
    ot = np.lexsort((ft["time"], ft["dom"]))
    for key, tol in REC_TOLS:
        np.testing.assert_allclose(ft[key][ot], fj[key][oj], atol=tol,
                                   rtol=1e-3, err_msg=key)


def test_threefry_records_need_room_for_every_record():
    """A threefry record run has one call: a record that finds the buffer
    full would wait for a launch that never comes, so propagate_fused
    refuses a capacity below the photons + 1 and names why; at photons + 1
    the run drains with every record."""
    inputs = workload(save_photons=True)
    photons = int(np.asarray(inputs[4].num_photons).sum())
    with pytest.raises(ValueError, match="rec_capacity"):
        port_fused(inputs, KEY, rec_capacity=photons)
    res, tot = port_fused(inputs, KEY, rec_capacity=photons + 1)
    assert float(tot[KT.CNT_STALLED]) == 0.0
    assert int(res.rec_count[0]) == float(tot[KT.CNT_HITS]) > 20


@pytest.mark.parametrize("threefry", [False, True])
def test_hole_ice_polynomial_matches_jax_interpret_kernel(threefry):
    """The default hole-ice acceptance's 11 coefficients in the expected
    estimator: the kernel reads them from a device table of any length."""
    assert len(HOLE_ICE) == 11
    np.testing.assert_array_equal(HOLE_ICE, HOLE_ICE_J["coefficients"])
    inputs = workload(**EXPECTED_HOLE_ICE)
    key = KEY if threefry else None
    res_j, tot_j = jax_kernel(inputs, key)
    res_t, tot_t = port_fused(inputs, key)
    compare_runs(res_j, tot_j, res_t, tot_t)
    np.testing.assert_allclose(float(tot_t[KT.CNT_WSUM]),
                               float(tot_j[KJ.CNT_WSUM]), rtol=1e-4)
    steps, medium, geo, spectra, cfg, _ = port_inputs(*inputs)
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T,
                                   threefry=threefry)
    assert KT.spec_unsupported(spec) is None
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    np.testing.assert_array_equal(tables.ang.numpy(),
                                  np.float32(HOLE_ICE))


@pytest.mark.parametrize("change", [dict(), EXPECTED_HOLE_ICE])
def test_closed_ice_with_tabulated_angle_matches_jax_interpret_kernel(change):
    """The closed-form ice with the Antares scattering angle table (Rayleigh
    fraction in liu_fraction): the kernel's MED_CLOSED_SCAT, as the JAX
    kernel samples the tabulated angle whatever the medium."""
    medium, geo, spectra, cfg, steps, u = workload(**change)
    medium = medium._replace(scattering=water_j().scattering)
    assert medium.medium_kind == "icecube"
    inputs = (medium, geo, spectra, cfg, steps, u)
    res_j, tot_j = jax_kernel(inputs)
    res_t, tot_t = port_fused(inputs)
    compare_runs(res_j, tot_j, res_t, tot_t)
    _, md, gt, sp, cf, _ = port_inputs(*inputs)
    spec, _ = KT.fused_spec(md, gt, sp, cf, TK.N, TK.T)
    assert KT.spec_unsupported(spec) is None
    assert KT.kernel_med(spec) == KT.MED_CLOSED_SCAT
    assert KT.kernel_mode(spec) >> KT.MED_SHIFT == KT.MED_CLOSED_SCAT
    # the plain version counts the tabulated angle's scatters
    assert float(tot_t[KT.CNT_SCAT]) >= float(tot_t[KT.CNT_RAYLEIGH]) > 0


def _geometries():
    dev = "cpu"
    return {"hex61": chip_smoke.hex61(dev), "ic86": chip_smoke.ic86(dev),
            "jittered ic86": chip_smoke.ic86(dev, jitter=chip_smoke.JITTER_M),
            "ARCA block": chip_smoke.arca_block(dev),
            "test workload": port_inputs(*workload())[2]}


def _media():
    from clsim_tpu_torch.medium.antares import make_antares_water
    tilted = port_inputs(*workload())[1]
    seeded, r = chip_smoke.seeded_ice(171, -855.0, 10.0, "cpu")
    return {"seeded ice, aniso + tilt":
            chip_smoke.aniso_tilt(seeded, r, True, True, "cpu"),
            "test workload ice, aniso + tilt": tilted,
            "photonics ice": chip_smoke.photonics_ice("cpu"),
            "Antares water": make_antares_water(device="cpu"),
            "ice with the Antares angle": tilted._replace(
                scattering=make_antares_water(device="cpu").scattering)}


def test_spec_gate_serves_every_geometry_and_ice_the_repo_builds():
    """Every geometry (hex61, ic86, jittered ic86, the ARCA block, the
    tests' hexagon) in every ice the repository builds (the seeded layered
    ice and the tests' ice with tilt and anisotropy, a photonics table,
    Antares water, ice with the Antares angle) passes the kernel's gate at
    the default configuration and at the tests' and the bench's, in
    stopping detect, with records and threefry, and in the expected
    estimator with the hole-ice polynomial and threefry: no geometry or ice
    reaches the static limits."""
    cfgs = [PropagationConfig(n_slots=TK.N),
            port_inputs(*workload())[4],
            PropagationConfig(n_slots=TK.N, pancake_factor=5.0,
                              max_layer_steps=4, max_segment_m=35.0)]
    modes = [(dict(), False), (dict(save_photons=True), True),
             (EXPECTED_HOLE_ICE, True)]
    media = _media()
    served = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for gname, geo in _geometries().items():
            for mname, medium in media.items():
                spectra = chip_smoke.medium_spectra(medium, geo, "cpu")
                for cfg in cfgs:
                    for change, threefry in modes:
                        c = dataclasses.replace(cfg, **change)
                        assert KT.fused_supported(medium, spectra, c) is None
                        spec, _ = KT.fused_spec(medium, geo, spectra, c,
                                                TK.N, TK.T, threefry)
                        reason = KT.spec_unsupported(spec)
                        assert reason is None, (gname, mname, c, reason)
                        served += 1
    assert served == 5 * 5 * 3 * 3
