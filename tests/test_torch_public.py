"""Five public functions of clsim_tpu that the port added last, each against
the JAX function on seeded numpy inputs:

  * ops/spectrum.sample_wavelength: the same float32 inverse-CDF arithmetic
    on the same tables, rel 1e-5 (the quadratic solve's sqrt(1 + x) - 1
    loses digits where x is small: 2 of 4,096 draws differ by 2e-6);
  * ops/samplers.normal_box_muller: float32 log and cos of two libraries,
    within 1e-5 absolute.  At u1 = 0 the JAX function returns inf on the
    CPU: its floor 1e-38 is a float32 subnormal, which XLA flushes to 0
    before the log; the port's stays finite;
  * medium/anisotropy.numpy_abs_len_scaling and medium/tilt.
    numpy_tilt_z_shift: the same float64 numpy code, bit for bit; and each
    oracle against the port's torch function in float32 (rel 1e-4 and
    5e-3 m, tests/test_medium.py's tolerances);
  * native.build_native: True where the library builds, False where it
    cannot, as the JAX function returns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clsim_tpu.medium import anisotropy as AJ
from clsim_tpu.medium import tilt as TJ
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.ops import samplers as SJ
from clsim_tpu.ops import spectrum as SPJ

from clsim_tpu_torch import native as NT
from clsim_tpu_torch.medium import anisotropy as AT
from clsim_tpu_torch.medium import tilt as TT
from clsim_tpu_torch.ops import samplers as ST
from clsim_tpu_torch.ops import spectrum as SPT

torch.set_num_threads(1)


@pytest.mark.parametrize("bias", [False, True])
def test_sample_wavelength_matches_jax(bias):
    kw = {}
    if bias:
        x = np.arange(260.0, 690.0, 10.0)
        kw = dict(bias_wlen_nm=x, bias_values=np.linspace(0.2, 1.0, x.size))
    spec_j = SPJ.make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
                                         **kw)
    spec_t = SPT.WavelengthSpectrum(*[np.asarray(f) for f in spec_j])
    u = np.random.default_rng(11).random(4096).astype(np.float32)
    wj = np.asarray(SPJ.sample_wavelength(spec_j, jnp.asarray(u)))
    wt = SPT.sample_wavelength(spec_t, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=0.0)
    assert spec_t.x[0] <= wt.min() and wt.max() <= spec_t.x[-1]


def test_normal_box_muller_matches_jax():
    r = np.random.default_rng(12)
    u1, u2 = r.random((2, 8192)).astype(np.float32)
    u1[:2] = (1e-30, 1.0)
    nj = np.asarray(SJ.normal_box_muller(jnp.asarray(u1), jnp.asarray(u2)))
    nt = ST.normal_box_muller(torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_allclose(nt.numpy(), nj, rtol=0.0, atol=1e-5)
    assert abs(float(nt.mean())) < 0.05 and abs(float(nt.std()) - 1) < 0.05
    zero, half = np.zeros(1, np.float32), np.full(1, 0.5, np.float32)
    assert np.isinf(np.asarray(SJ.normal_box_muller(jnp.asarray(zero),
                                                    jnp.asarray(half))))
    assert torch.isfinite(ST.normal_box_muller(torch.as_tensor(zero),
                                               torch.as_tensor(half))).all()


def test_numpy_abs_len_scaling_matches_jax_and_the_torch_function():
    r = np.random.default_rng(13)
    p = AT.AnisotropyParams(azimuth=torch.tensor(3.770),
                            mag_along=torch.tensor(0.04),
                            mag_perp=torch.tensor(-0.08))
    for _ in range(50):
        d = r.normal(size=3)
        d /= np.linalg.norm(d)
        expected = AJ.numpy_abs_len_scaling(3.770, 0.04, -0.08, d)
        assert AT.numpy_abs_len_scaling(3.770, 0.04, -0.08, d) == expected
        got = float(AT.abs_len_scaling(p, *[torch.tensor(v, dtype=torch.float32)
                                            for v in d]))
        assert got == pytest.approx(expected, rel=1e-4)


def test_numpy_tilt_z_shift_matches_jax_and_the_torch_function():
    r = np.random.default_rng(14)
    distances = np.array([-600.0, -250.0, 0.0, 300.0, 700.0])
    zcoords = np.arange(-500.0, 510.0, 10.0)
    zshift = 30.0 * r.standard_normal((distances.size, zcoords.size))
    az = 225.0 * np.pi / 180.0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    p = TT.TiltParams(distances=f32(distances), first_z=f32(zcoords[0]),
                      z_spacing=f32(zcoords[1] - zcoords[0]),
                      z_corrections=f32(zshift), azimuth_cos=f32(np.cos(az)),
                      azimuth_sin=f32(np.sin(az)))
    for _ in range(100):
        x, y, z = r.uniform(-600, 600), r.uniform(-600, 600), \
            r.uniform(-500, 500)
        expected = TJ.numpy_tilt_z_shift(distances, zcoords, zshift, az,
                                         x, y, z)
        assert TT.numpy_tilt_z_shift(distances, zcoords, zshift, az,
                                     x, y, z) == expected
        got = float(TT.tilt_z_shift(p, f32(x), f32(y), f32(z)))
        assert got == pytest.approx(expected, abs=5e-3), (x, y, z)


def test_build_native_returns_bool_as_jax_does(monkeypatch, tmp_path):
    from clsim_tpu import native as NJ
    built = NT.build_native()
    assert built is NJ.build_native() and isinstance(built, bool)
    assert built == NT.library_path().exists()
    # no compiler: both report False instead of raising
    monkeypatch.setattr(NT, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(NT.shutil, "which", lambda name: None)

    def no_make(*a, **k):
        raise FileNotFoundError("make")

    monkeypatch.setattr(NJ.subprocess, "run", no_make)
    assert NT.build_native() is NJ.build_native() is False
    with pytest.warns(RuntimeWarning, match="g\\+\\+"):
        assert NT.build_native(quiet=False) is False
