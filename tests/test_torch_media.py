"""Tabulated media of the port against clsim_tpu: the sea-water functions,
the Antares water and its Petzold tables, the photonics-table parser (with
tests/test_medium.py's synthetic table and bad files), the medium's
separable coefficients for both tabulated kinds, the water samplers and the
medium carried across by convert.medium_from_numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clsim_tpu.medium import antares as AJ
from clsim_tpu.medium import functions as FJ
from clsim_tpu.medium import photonics as PJ
from clsim_tpu.ops import samplers as SJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.medium import antares as AT
from clsim_tpu_torch.medium import functions as FT
from clsim_tpu_torch.medium import photonics as PT
from clsim_tpu_torch.ops import samplers as ST

torch.set_num_threads(1)
RTOL = 1e-6


def close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def wavelengths(n=1000, lo=290.0, hi=610.0, seed=0):
    """n wavelengths from a seed, the grid ends included."""
    w = np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)
    w[:2] = lo, hi
    return w


def photonics_text(seed=7, L=10, nw=16, z_start=-500.0):
    """tests/test_medium.py::test_photonics_table_parser's synthetic table:
    dust shape x layer amplitude + pure ice, upside-down and shuffled
    layers."""
    rng = np.random.default_rng(seed)
    w_start, dw = 300.0, 20.0
    wl = w_start + dw / 2 + dw * np.arange(nw)
    mean_cos = 0.94
    b400 = 0.03 + 0.02 * rng.random(L)
    scat_inv_geo = np.outer(b400, (wl / 400.0) ** -0.9)
    a_amp = 0.005 + 0.004 * rng.random(L)
    abs_inv = np.outer(a_amp, (wl / 400.0) ** -1.08) \
        + (0.01 * np.exp(-6618.0 / wl) * 400.0)[None, :]
    n_phase = 1.32 + 10.0 / wl
    lines = [f"NLAYER {L}", f"NWVL {nw} {w_start} {dw}"]
    for i in rng.permutation(L):
        z0, z1 = z_start + 50.0 * i, z_start + 50.0 * (i + 1)
        if i % 3 == 0:
            z0, z1 = z1, z0
        lines += [f"LAYER {z0} {z1}",
                  "ABS " + " ".join(map(str, abs_inv[i])),
                  "SCAT " + " ".join(map(str, scat_inv_geo[i]
                                         * (1 - mean_cos))),
                  "COS " + " ".join([str(mean_cos)] * nw),
                  "N_GROUP " + " ".join(map(str, n_phase * 1.03)),
                  "N_PHASE " + " ".join(map(str, n_phase))]
    return "\n".join(lines)


MEDIUM_FIELDS = ("layers_z_start", "layer_height", "alpha", "kappa", "abs_A",
                 "abs_B", "abs_D", "abs_E", "b400", "a_dust400", "delta_tau",
                 "density", "efficiency", "water_scat_inv", "water_abs_inv",
                 "fac_gs", "fac_pa", "fac_qa", "fac_ra", "ref_n_table",
                 "ref_g_table")
STATIC_FIELDS = ("n_layers", "min_wlen", "max_wlen", "medium_kind",
                 "water_wlen_first", "water_wlen_step")


def assert_media_equal(mj, mt, rtol=RTOL):
    """Field for field, the nested ref_index and scattering included."""
    for f in STATIC_FIELDS:
        assert getattr(mt, f) == getattr(mj, f), f
    for f in MEDIUM_FIELDS:
        a, b = getattr(mj, f), getattr(mt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            close(b.cpu(), a, rtol)
    close(mt.ref_index.n.cpu(), mj.ref_index.n, rtol)
    close(mt.ref_index.g.cpu(), mj.ref_index.g, rtol)
    sj, st = mj.scattering, mt.scattering
    assert st.kind == sj.kind
    close(st.mean_cos.cpu(), sj.mean_cos)
    close(st.liu_fraction.cpu(), sj.liu_fraction)
    for f in ("table_cos", "table_cdf"):
        assert (getattr(sj, f) is None) == (getattr(st, f) is None), f
        if getattr(sj, f) is not None:
            close(getattr(st, f).cpu(), getattr(sj, f), rtol)


def test_sea_water_functions():
    w = wavelengths()
    qj = FJ.QuanFryParams(38.44, 13.1, 213.0)
    qt = FT.QuanFryParams(38.44, 13.1, 213.0)
    close(FT.phase_ref_index_quan_fry(qt, w),
          FJ.phase_ref_index_quan_fry(qj, w))
    close(FT.group_ref_index_quan_fry(qt, w),
          FJ.group_ref_index_quan_fry(qj, w))
    pj = FJ.ScatLenParticParams(0.0075, 0.011)
    pt = FT.ScatLenParticParams(0.0075, 0.011)
    close(FT.scattering_inv_length_partic(pt, w),
          FJ.scattering_inv_length_partic(pj, w))
    vals = np.random.default_rng(1).random(33).astype(np.float32)
    tj = FJ.TableParams(jnp.float32(290.0), jnp.float32(10.0),
                        jnp.asarray(vals))
    tt = FT.TableParams(torch.tensor(290.0), torch.tensor(10.0),
                        torch.as_tensor(vals))
    wide = wavelengths(lo=250.0, hi=650.0)     # beyond the grid: clamped
    close(FT.eval_table(tt, wide), FJ.eval_table(tj, wide))
    coeffs = vals[:7]
    c = np.linspace(-1, 1, 1000).astype(np.float32)
    close(FT.eval_polynomial(torch.as_tensor(coeffs), c),
          FJ.eval_polynomial(jnp.asarray(coeffs), c), atol=1e-6)


def test_antares_water_and_petzold_tables():
    for a, b in zip(AT.petzold_angle_tables(), AJ.petzold_angle_tables()):
        close(a, b)
    mj = AJ.make_antares_water()
    mt = AT.make_antares_water(device="cpu")
    assert_media_equal(mj, mt)
    mj2 = AJ.make_antares_water(salinity=36.0, temperature=14.0,
                                vol_conc_small_ppm=0.01)
    mt2 = AT.make_antares_water(salinity=36.0, temperature=14.0,
                                vol_conc_small_ppm=0.01, device="cpu")
    assert_media_equal(mj2, mt2)


def test_photonics_parser_matches_jax():
    text = photonics_text()
    mj = PJ.parse_photonics_ice_table(text)
    mt = PT.parse_photonics_ice_table(text, device="cpu")
    assert mt.medium_kind == "separable_table" and mt.n_layers == 10
    assert_media_equal(mj, mt)


def test_photonics_parser_rejects_bad_files():
    """Every bad file of tests/test_medium.py::
    test_photonics_table_rejects_bad_files, with the same message."""
    base = ("NLAYER 1\nNWVL 2 300 20\nLAYER 0 50\nABS 0.1 0.1\n"
            "SCAT 0.1 0.1\nCOS 0.9 0.9\nN_GROUP 1.35 1.35\n"
            "N_PHASE 1.31 1.31\n")
    PT.parse_photonics_ice_table(base, device="cpu")
    bad = [
        (base.replace("NLAYER 1\n", ""), "NLAYER"),
        (base.replace("COS 0.9 0.9", "COS 0.9 0.8"), "mean cosine"),
        ("NLAYER 2\nNWVL 2 300 20\n"
         "LAYER 0 50\nABS 0.1 0.1\nSCAT 0.1 0.1\nCOS 0.9 0.9\n"
         "N_GROUP 1.35 1.35\nN_PHASE 1.31 1.31\n"
         "LAYER 50 100\nABS 0.1 0.1\nSCAT 0.1 0.1\nCOS 0.9 0.9\n"
         "N_GROUP 1.40 1.40\nN_PHASE 1.31 1.31\n", "N_GROUP"),
        ("NLAYER 2\nNWVL 2 300 20\n"
         "LAYER 0 50\nABS 0.1 0.1\nSCAT 0.1 0.1\nCOS 0.9 0.9\n"
         "N_GROUP 1.35 1.35\nN_PHASE 1.31 1.31\n"
         "LAYER 60 110\nABS 0.1 0.1\nSCAT 0.1 0.1\nCOS 0.9 0.9\n"
         "N_GROUP 1.35 1.35\nN_PHASE 1.31 1.31\n", "hole")]
    for text, match in bad:
        with pytest.raises(ValueError, match=match):
            PJ.parse_photonics_ice_table(text)
        with pytest.raises(ValueError, match=match):
            PT.parse_photonics_ice_table(text, device="cpu")


@pytest.mark.parametrize("kind", ["water", "separable_table"])
def test_separable_coefficients(kind):
    """abs_coeffs / scat_coeff / phase_ref_index / group_ref_index of both
    tabulated kinds on 1,000 wavelengths, the grid ends and points beyond
    them included."""
    if kind == "water":
        mj, mt = AJ.make_antares_water(), AT.make_antares_water(device="cpu")
    else:
        text = photonics_text()
        mj = PJ.parse_photonics_ice_table(text)
        mt = PT.parse_photonics_ice_table(text, device="cpu")
    w = wavelengths(lo=mj.min_wlen - 20.0, hi=mj.max_wlen + 20.0)
    w[2:4] = mj.min_wlen, mj.max_wlen
    wj, wt = jnp.asarray(w), torch.as_tensor(w)
    for a, b in zip(mt.abs_coeffs(wt), mj.abs_coeffs(wj)):
        close(a, b)
    close(mt.scat_coeff(wt), mj.scat_coeff(wj))
    close(mt.phase_ref_index(wt), mj.phase_ref_index(wj))
    close(mt.group_ref_index(wt), mj.group_ref_index(wj))
    layer = torch.as_tensor(np.arange(len(w)) % mt.n_layers)
    close(mt.inv_absorption_length(layer, wt),
          mj.inv_absorption_length(jnp.asarray(layer.numpy()), wj))


def test_water_samplers_on_equal_uniforms():
    u = np.random.default_rng(2).random(20000).astype(np.float32)
    u[:3] = 0.0, 0.5, np.float32(1.0 - 2 ** -24)
    close(ST.rayleigh_cos(torch.as_tensor(u)), SJ.rayleigh_cos(jnp.asarray(u)),
          atol=1e-6)
    ang, acu, dens = AJ.petzold_angle_tables()
    got = ST.sample_interpolated_fast(*(torch.as_tensor(a)
                                        for a in (ang, acu, dens, u)))
    want = SJ.sample_interpolated_fast(*(jnp.asarray(a)
                                         for a in (ang, acu, dens, u)))
    close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["water", "separable_table"])
def test_convert_round_trip(kind):
    """convert.medium_from_numpy carries both tabulated kinds field for
    field; a tabulated kind without its tables is refused."""
    mj = (AJ.make_antares_water() if kind == "water"
          else PJ.parse_photonics_ice_table(photonics_text()))
    tree = C.numpy_tree(mj)
    mt = C.medium_from_numpy(tree, device="cpu")
    assert_media_equal(mj, mt, rtol=0.0)
    back = C.numpy_tree(mt)
    assert back["medium_kind"] == kind
    broken = dict(tree, water_abs_inv=None, fac_qa=None)
    with pytest.raises(ValueError, match="tables"):
        C.medium_from_numpy(broken, device="cpu")
