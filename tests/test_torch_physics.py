"""Physics functions of clsim_tpu_torch against clsim_tpu on the same seeded
inputs (float32 on the CPU; rtol 1e-5 unless stated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clsim_tpu.hits import acceptance as AJ
from clsim_tpu.medium import anisotropy as ANJ
from clsim_tpu.medium import functions as FJ
from clsim_tpu.medium import tilt as TLJ
from clsim_tpu.ops import rotations as RJ
from clsim_tpu.ops import samplers as SJ
from clsim_tpu.ops import spectrum as SPJ

from clsim_tpu_torch.convert import spectra_from_numpy
from clsim_tpu_torch.hits import acceptance as AT
from clsim_tpu_torch.medium import anisotropy as ANT
from clsim_tpu_torch.medium import functions as FT
from clsim_tpu_torch.medium import tilt as TLT
from clsim_tpu_torch.ops import rotations as RT
from clsim_tpu_torch.ops import samplers as ST
from clsim_tpu_torch.ops import spectrum as SPT

torch.set_num_threads(1)
RTOL = 1e-5


def close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol, atol=atol)


def f32(rng, lo, hi, n=4096):
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def test_ice_optical_functions(rng):
    wl = f32(rng, 265.0, 675.0)
    t = torch.as_tensor(wl)
    for a, b in zip(FJ.abs_separable_coeffs(1.08, 6954.0, 6618.0, 650.0, 0.1, wl),
                    FT.abs_separable_coeffs(1.08, 6954.0, 6618.0, 650.0, 0.1, t)):
        close(a, b)
    close(FJ.scat_separable_coeff(0.9, wl), FT.scat_separable_coeff(0.9, t))
    close(FJ.phase_ref_index(FJ.DEFAULT_ICE_REF_INDEX, wl),
          FT.phase_ref_index(FT.DEFAULT_ICE_REF_INDEX, t))
    close(FJ.group_ref_index(FJ.DEFAULT_ICE_REF_INDEX, wl),
          FT.group_ref_index(FT.DEFAULT_ICE_REF_INDEX, t))
    pj = FJ.AbsLenParams(1.08, 6954.0, 6618.0, 650.0, 0.0, 0.006, 0.5)
    close(FJ.absorption_length_icecube(pj, wl),
          FT.absorption_length_icecube(FT.AbsLenParams(*pj), t))


def test_tilt_z_shift_including_extrapolation(rng):
    zc = (20.0 * rng.standard_normal((4, 9))).astype(np.float32)
    kw = dict(first_z=-400.0, z_spacing=100.0, azimuth_cos=np.cos(3.93),
              azimuth_sin=np.sin(3.93))
    d = [-800.0, -200.0, 300.0, 900.0]
    pj = TLJ.TiltParams(distances=jnp.asarray(d, jnp.float32),
                        z_corrections=jnp.asarray(zc),
                        **{k: jnp.float32(v) for k, v in kw.items()})
    pt = TLT.TiltParams(distances=torch.tensor(d),
                        z_corrections=torch.as_tensor(zc),
                        **{k: torch.tensor(v, dtype=torch.float32)
                           for k, v in kw.items()})
    # x/y reach beyond the distance grid (linear extrapolation), z beyond
    # the z grid (clamped index)
    x, y, z = f32(rng, -1500, 1500), f32(rng, -1500, 1500), f32(rng, -700, 700)
    a = TLJ.tilt_z_shift(pj, x, y, z)
    b = TLT.tilt_z_shift(pt, *map(torch.as_tensor, (x, y, z)))
    close(a, b, atol=1e-5)


def test_anisotropy_scaling_and_transforms(rng):
    v = rng.standard_normal((3, 4096))
    v = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    pj = ANJ.AnisotropyParams(jnp.float32(3.9), jnp.float32(0.04),
                              jnp.float32(-0.08), True)
    pt = ANT.AnisotropyParams(torch.tensor(3.9), torch.tensor(0.04),
                              torch.tensor(-0.08), True)
    tv = [torch.as_tensor(c) for c in v]
    close(ANJ.abs_len_scaling(pj, *v), ANT.abs_len_scaling(pt, *tv))
    for fj, ft in ((ANJ.pre_scatter_transform, ANT.pre_scatter_transform),
                   (ANJ.post_scatter_transform, ANT.post_scatter_transform)):
        for a, b in zip(fj(pj, *v), ft(pt, *tv)):
            close(a, b, atol=1e-6)


def test_spectrum_tables_yield_and_bias(rng):
    acc_j = AJ.icecube_dom_acceptance(AJ.DOM_RADIUS * 5.0, efficiency=0.36)
    acc_t = AT.icecube_dom_acceptance(AT.DOM_RADIUS * 5.0, efficiency=0.36,
                                      device="cpu")
    close(acc_j.values, acc_t.values)
    nb = np.asarray(acc_j.values).shape[0]
    bx = 260.0 + 10.0 * np.arange(nb)
    by = np.asarray(acc_j.values)
    sj = SPJ.make_cherenkov_spectrum(FJ.DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
                                     bias_wlen_nm=bx, bias_values=by)
    st = SPT.make_cherenkov_spectrum(FT.DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
                                     bias_wlen_nm=bx, bias_values=by)
    for f in sj._fields:       # host-built tables: identical
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f), err_msg=f)
    close(SPJ.photons_per_meter(FJ.DEFAULT_ICE_REF_INDEX, bx, by, 265.0,
                                675.0),
          SPT.photons_per_meter(FT.DEFAULT_ICE_REF_INDEX, bx, by, 265.0,
                                675.0))
    tab_j = SPJ.stack_spectra([sj])
    tab_t = spectra_from_numpy(tab_j._asdict(), device="cpu")
    u = f32(rng, 0.0, 1.0)
    src = np.zeros(u.shape, np.int32)
    wl_j = SPJ.sample_wavelength_dispatch(tab_j, jnp.asarray(src),
                                          jnp.asarray(u))
    wl_t = SPT.sample_wavelength_dispatch(tab_t, torch.as_tensor(src),
                                          torch.as_tensor(u))
    close(wl_j, wl_t)
    close(SPJ.wavelength_bias(sj, np.asarray(wl_j)),
          SPT.wavelength_bias(tab_t, torch.tensor(np.asarray(wl_j))))


def test_interpolated_inverse_cdf(rng):
    x = np.linspace(0.0, 2.0, 33).astype(np.float32)
    y = (1.0 + np.sin(3 * x) ** 2).astype(np.float32)
    y[5] = 0.0                        # a zero-density support point
    tj = SJ.build_interpolated_dist(x, y)
    tt = ST.build_interpolated_dist(torch.as_tensor(x), torch.as_tensor(y))
    for a, b in zip(tj, tt):
        close(a, b)
    u = f32(rng, 0.0, 1.0)
    close(SJ.sample_interpolated_dist(tj, u),
          ST.sample_interpolated_dist(tt, torch.as_tensor(u)), atol=1e-6)


@pytest.mark.parametrize("g,liu", [(0.9, 0.45), (0.0, 0.3), (0.6, 1.0)])
def test_hg_liu_mixture(rng, g, liu):
    us, uv = f32(rng, 0.0, 1.0), f32(rng, 0.0, 1.0)
    a = SJ.mixed_cos(jnp.float32(g), jnp.float32(liu), us, uv)
    b = ST.mixed_cos(torch.tensor(g), torch.tensor(liu), torch.as_tensor(us),
                     torch.as_tensor(uv))
    close(a, b, atol=2e-6)


def test_rotations_including_vertical(rng):
    v = rng.standard_normal((3, 4096))
    v = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    v[:, :4] = [[0, 0, 0, 0], [0, 0, 0, 0], [1, -1, 1, -1]]  # vertical
    cosa = f32(rng, -1.0, 1.0)
    sina = np.sqrt(1 - cosa ** 2).astype(np.float32)
    ua = f32(rng, 0.0, 1.0)
    a = RJ.scatter_direction_by_angle(cosa, sina, *v, ua)
    b = RT.scatter_direction_by_angle(*map(torch.as_tensor,
                                           (cosa, sina, *v, ua)))
    for p, q in zip(a, b):
        close(p, q, atol=2e-6)
    for p, q in zip(RJ.cart_to_sph(*v), RT.cart_to_sph(*map(torch.as_tensor,
                                                            v))):
        close(p, q, atol=2e-6)


def test_dom_acceptance_and_angular_sensitivity(rng):
    acc_j = AJ.icecube_dom_acceptance()
    acc_t = AT.icecube_dom_acceptance(device="cpu")
    wl = f32(rng, 250.0, 700.0)
    close(FJ.eval_table(acc_j, wl), FT.eval_table(acc_t, torch.as_tensor(wl)))
    cj, ct = AJ.dom_angular_sensitivity(), AT.dom_angular_sensitivity(device="cpu")
    close(cj, ct)
    c = f32(rng, -1.0, 1.0)
    close(FJ.eval_polynomial(cj, c), FT.eval_polynomial(ct, torch.as_tensor(c)),
          atol=1e-6)
