"""The sensors of the port against clsim_tpu.hits: the Gen2 (D-Egg, WOM),
Antares and KM3NeT acceptance tables (exact) and angular curves (rtol 1e-6)
with the AngularSensitivity cutoff, hit_probability with an
AngularSensitivity, and the multi-PMT layout, PMT assignment and hit
sampling on equal uniforms."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clsim_tpu.hits import acceptance as AJ
from clsim_tpu.hits import mcpe as MJ
from clsim_tpu.hits import multi_pmt as PJ

from clsim_tpu_torch.hits import acceptance as AT
from clsim_tpu_torch.hits import mcpe as MT
from clsim_tpu_torch.hits import multi_pmt as PT

torch.set_num_threads(1)

TABLES = [
    ("degg_acceptance", dict(), dict(active_fraction=0.8)),
    ("wom_acceptance", dict(), dict(active_fraction=0.5)),
    ("antares_om_acceptance", dict(), dict(dom_radius=0.2)),
    ("km3net_dom_acceptance", dict(), dict(wpd_qe=True)),
    ("km3net_dom_acceptance", dict(with_winston_cone=True),
     dict(peak_qe=0.3)),
]


@pytest.mark.parametrize("name,kw1,kw2", TABLES)
def test_acceptance_tables_are_exact(name, kw1, kw2):
    for kw in (kw1, kw2):
        tj = getattr(AJ, name)(**kw)
        tt = getattr(AT, name)(device="cpu", **kw)
        for f in ("first_x", "dx", "values"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(tj, f)),
                                          err_msg=f"{name} {f}")


def cosines(n=4001):
    c = np.linspace(-1.2, 1.2, n).astype(np.float32)
    return c, jnp.asarray(c), torch.as_tensor(c)


def test_angular_curves_and_cutoff():
    c, cj, ct = cosines()
    for pmt in ("down", "up", "both"):
        pj = AJ.degg_angular_sensitivity(pmt)
        pt = AT.degg_angular_sensitivity(pmt, device="cpu")
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_allclose(AT.angular_factor(pt, ct).numpy(),
                                   np.asarray(AJ.angular_factor(pj, cj)),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        AT.degg_angular_sensitivity("sideways", device="cpu")
    (wj, lim_j), (wt, lim_t) = (AJ.wom_angular_sensitivity(),
                                AT.wom_angular_sensitivity(device="cpu"))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert lim_t == lim_j
    np.testing.assert_array_equal(
        AT.cos_cherenkov_angular_sensitivity(device="cpu").numpy(),
        np.asarray(AJ.cos_cherenkov_angular_sensitivity()))
    for name in AJ.ANTARES_ANGULAR_MODELS:
        aj = AJ.antares_om_angular_sensitivity(name)
        at = AT.antares_om_angular_sensitivity(name, device="cpu")
        assert at.cos_min == aj.cos_min
        np.testing.assert_array_equal(at.coefficients.numpy(),
                                      np.asarray(aj.coefficients))
        got = AT.angular_factor(at, ct).numpy()
        np.testing.assert_allclose(got, np.asarray(AJ.angular_factor(aj, cj)),
                                   rtol=1e-6, atol=1e-6)
        # the hard cutoff below cos_min
        assert (got[np.clip(c, -1, 1) < at.cos_min] == 0.0).all()
        assert (got >= 0.0).all() and (got <= 1.0).all()
    with pytest.raises(ValueError, match="unknown Antares"):
        AT.antares_om_angular_sensitivity("nope", device="cpu")


def test_hit_probability_with_angular_sensitivity():
    r = np.random.default_rng(3)
    n = 5000
    w = r.uniform(0.0, 3.0, n).astype(np.float32)
    wl = r.uniform(280.0, 620.0, n).astype(np.float32)
    c = r.uniform(-1.0, 1.0, n).astype(np.float32)
    pj = MJ.hit_probability(jnp.asarray(w), jnp.asarray(wl), jnp.asarray(c),
                            AJ.antares_om_acceptance(),
                            AJ.antares_om_angular_sensitivity("Genova"), 0.9)
    pt = MT.hit_probability(torch.as_tensor(w), torch.as_tensor(wl),
                            torch.as_tensor(c),
                            AT.antares_om_acceptance(device="cpu"),
                            AT.antares_om_angular_sensitivity(
                                "Genova", device="cpu"), 0.9)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-7)


def records(n_slots=64, cap=4, seed=5):
    """Ring records on random points of an OM of radius 0.2159 m, with the
    photon entering the sphere."""
    r = np.random.default_rng(seed)
    shape = (n_slots, cap)
    v = r.standard_normal((3,) + shape)
    v *= 0.2159 / np.linalg.norm(v, axis=0)
    theta = np.arccos(r.uniform(-1, 1, shape))
    phi = r.uniform(0, 2 * np.pi, shape)
    rec = dict(pos_x=v[0], pos_y=v[1], pos_z=v[2], dir_theta=theta,
               dir_phi=phi, weight=r.uniform(0.5, 4.0, shape),
               wavelength=r.uniform(300.0, 600.0, shape),
               time=r.uniform(0.0, 900.0, shape),
               dom=r.integers(0, 12, shape).astype(np.float64))
    rec = {k: a.astype(np.float32) for k, a in rec.items()}
    count = r.integers(0, cap + 2, n_slots).astype(np.int32)
    return rec, count


def test_multi_pmt_layout_assignment_and_sampling():
    lj = PJ.km3net_31_pmt_layout()
    lt = PT.km3net_31_pmt_layout(device="cpu")
    np.testing.assert_allclose(lt.dirs.numpy(), np.asarray(lj.dirs),
                               rtol=0, atol=0)
    assert lt.cos_opening == lj.cos_opening and lt.dirs.shape == (31, 3)
    rec, count = records()
    rj = {k: jnp.asarray(v) for k, v in rec.items()}
    rt = {k: torch.as_tensor(v) for k, v in rec.items()}
    flat = lambda k: rec[k].reshape(-1)
    pj = PJ.assign_pmts(lj, *(jnp.asarray(flat(k))
                              for k in ("pos_x", "pos_y", "pos_z")))
    pt = PT.assign_pmts(lt, *(torch.as_tensor(flat(k))
                              for k in ("pos_x", "pos_y", "pos_z")))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert (pt >= 0).any() and (pt < 0).any()
    # the sampling on equal uniforms: the JAX package draws from its key,
    # the port takes those uniforms
    key = jax.random.PRNGKey(8)
    u = np.asarray(jax.random.uniform(key, (rec["time"].size,)))
    acc_j, ang_j = AJ.km3net_dom_acceptance(), AJ.dom_angular_sensitivity()
    acc_t = AT.km3net_dom_acceptance(device="cpu")
    ang_t = AT.dom_angular_sensitivity(device="cpu")
    out_j = PJ.sample_multi_pmt_hits(rj, jnp.asarray(count), key, lj, acc_j,
                                     ang_j, efficiency=1.5)
    out_t = PT.sample_multi_pmt_hits(rt, torch.as_tensor(count), None, lt,
                                     acc_t, ang_t, efficiency=1.5,
                                     uniforms=u)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(out_t[0].sum()) < int(np.minimum(count, 4).sum())
    # the Generator path draws its own uniforms
    g = torch.Generator().manual_seed(3)
    acc_g = PT.sample_multi_pmt_hits(rt, torch.as_tensor(count), g, lt,
                                     acc_t, ang_t)[0]
    assert not bool((acc_g & (out_t[2] < 0)).any())
