"""Wavelength-dependent optical property functions (deep ice and sea water).

PyTorch counterparts of clsim_tpu.medium.functions, which re-implement the
reference's dual C++/OpenCL ``I3CLSimFunction`` objects
(public/clsim/function/I3CLSimFunction.h).  Each model is a function of
(params, wavelength); parameters may be Python floats or tensors (scalar
or per-layer).  All wavelengths are in **nanometers**, all returned lengths
in **meters**.

Formulas (as in the JAX package):
  * absorption_length_icecube:
      1 / ( (D*aDust400 + E) * x^-kappa + A*exp(-B/x) * (1 + 0.01*deltaTau) )
      (I3CLSimFunctionAbsLenIceCube.cxx:63-67)
  * scattering_length_icecube:
      1 / ( b400 * (x/400)^-alpha )   (I3CLSimFunctionScatLenIceCube.cxx:53-57)
  * refractive index (phase/group): quartic polynomials in x = lambda[um]
      (I3CLSimFunctionRefIndexIceCube.cxx:84-102)
  * sea water: the Quan & Fry phase index and its group index
      (I3CLSimFunctionRefIndexQuanFry.cxx) and the Kopelevich particulate
      scattering (I3CLSimFunctionScatLenPartic.cxx)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _over(c, x):
    """c / x with x a tensor, as a true division (torch computes a Python
    scalar over a tensor as c * (1 / x), which rounds differently)."""
    return torch.full_like(x, c) / x


def _t(x, like=None):
    """float32 tensor view of x (on like's device when x is host data)."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# IceCube deep-ice absorption
# ---------------------------------------------------------------------------

class AbsLenParams(NamedTuple):
    """Parameters of the 6-parameter IceCube absorption model."""
    kappa: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    a_dust400: torch.Tensor   # dust absorption coefficient at 400nm [1/m]
    delta_tau: torch.Tensor   # temperature correction [K]


def absorption_inv_length_icecube(p: AbsLenParams, wlen_nm):
    """Inverse absorption length [1/m]; broadcasting in (params, wlen)."""
    x = _t(wlen_nm)
    dust_term = (p.D * p.a_dust400 + p.E) * x ** (-p.kappa)
    ice_term = p.A * torch.exp(-p.B / x) * (1.0 + 0.01 * p.delta_tau)
    return dust_term + ice_term


def absorption_length_icecube(p: AbsLenParams, wlen_nm):
    return 1.0 / absorption_inv_length_icecube(p, wlen_nm)


def abs_separable_coeffs(kappa, A, B, D, E, wlen_nm):
    """Separable decomposition of the inverse absorption length:

    1/l_abs(layer, lambda) = pa(lambda)*a_dust400[layer] + qa(lambda)
                           + ra(lambda)*delta_tau[layer]
    """
    x = _t(wlen_nm)
    xk = x ** (-kappa)
    ebx = A * torch.exp(-B / x)
    pa = D * xk
    qa = E * xk + ebx
    ra = 0.01 * ebx
    return pa, qa, ra


# ---------------------------------------------------------------------------
# IceCube deep-ice geometric scattering
# ---------------------------------------------------------------------------

class ScatLenParams(NamedTuple):
    alpha: torch.Tensor
    b400: torch.Tensor        # scattering coefficient at 400nm [1/m]


def scattering_inv_length_icecube(p: ScatLenParams, wlen_nm):
    x = _t(wlen_nm)
    return p.b400 * (x / 400.0) ** (-p.alpha)


def scattering_length_icecube(p: ScatLenParams, wlen_nm):
    return 1.0 / scattering_inv_length_icecube(p, wlen_nm)


def scat_separable_coeff(alpha, wlen_nm):
    """1/l_sca(layer, lambda) = gs(lambda) * b400[layer]."""
    x = _t(wlen_nm)
    return (x / 400.0) ** (-alpha)


# ---------------------------------------------------------------------------
# Refractive index (IceCube parameterization)
# ---------------------------------------------------------------------------

class RefIndexParams(NamedTuple):
    """Quartic polynomial coefficients in x = lambda[um] for the phase index
    and for the group-index correction factor (n_group = n_phase * corr)."""
    n: torch.Tensor   # (5,) phase index coefficients n0..n4
    g: torch.Tensor   # (5,) group correction coefficients g0..g4


# default coefficients for deep South Pole ice (the standard "SPICE"
# dispersion parameterization; host arrays, moved to a device by the medium)
DEFAULT_ICE_REF_INDEX = RefIndexParams(
    n=np.array([1.55749, -1.57988, 3.99993, -4.68271, 2.09354], np.float32),
    g=np.array([1.227106, -0.954648, 1.42568, -0.711832, 0.0], np.float32),
)


def _poly4(c, x):
    c = _t(c, like=x).to(x.device)
    return c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))


def phase_ref_index(p: RefIndexParams, wlen_nm):
    x = _t(wlen_nm) * 1e-3  # nm -> um
    return _poly4(p.n, x)


def group_ref_index(p: RefIndexParams, wlen_nm):
    x = _t(wlen_nm) * 1e-3
    return _poly4(p.n, x) * _poly4(p.g, x)


# ---------------------------------------------------------------------------
# Sea water (Antares / KM3NeT) -- Quan & Fry refractive index
# ---------------------------------------------------------------------------

class QuanFryParams(NamedTuple):
    salinity: torch.Tensor      # [psu], e.g. 38.44
    temperature: torch.Tensor   # [deg C], e.g. 13.1
    pressure: torch.Tensor      # [atm], e.g. 240.0


def phase_ref_index_quan_fry(p: QuanFryParams, wlen_nm):
    """Quan & Fry (1995) empirical sea-water phase refractive index with the
    pressure extension used by Antares (I3CLSimFunctionRefIndexQuanFry.cxx)."""
    S, T, P = p.salinity, p.temperature, p.pressure
    x = _t(wlen_nm)
    n0, n1, n2, n3, n4 = 1.31405, 1.45e-5, 1.779e-4, -1.05e-6, 1.6e-8
    n5, n6, n7, n8 = -2.02e-6, 15.868, 0.01155, -0.00423
    n9, n10 = -4382.0, 1.1455e6
    a01 = (n0 + (n2 + n3 * T + n4 * T * T) * S + n5 * T * T
           + n1 * (P - 1.0) * 1.01325)
    a2 = n6 + n7 * S + n8 * T
    return a01 + _over(a2, x) + _over(n9, x * x) + _over(n10, x * x * x)


def group_ref_index_quan_fry(p: QuanFryParams, wlen_nm):
    """Group index from the phase index and its analytic derivative:
    n_g = n_p / (1 + (lambda/n_p) dn_p/dlambda)."""
    x = _t(wlen_nm)
    S, T = p.salinity, p.temperature
    n6, n7, n8 = 15.868, 0.01155, -0.00423
    n9, n10 = -4382.0, 1.1455e6
    np_ = phase_ref_index_quan_fry(p, x)
    a2 = n6 + n7 * S + n8 * T
    # integer powers as the JAX package's integer_pow multiplies them
    x2 = x * x
    dnp = (_over(-a2, x2) - _over(2.0 * n9, x2 * x)
           - _over(3.0 * n10, x2 * x2))
    return np_ / (1.0 + (x / np_) * dnp)


# ---------------------------------------------------------------------------
# Antares particulate scattering (Kopelevich model)
# ---------------------------------------------------------------------------

class ScatLenParticParams(NamedTuple):
    vol_conc_small: torch.Tensor  # [ppm], e.g. 0.0075
    vol_conc_large: torch.Tensor  # [ppm], e.g. 0.0075


def scattering_inv_length_partic(p: ScatLenParticParams, wlen_nm):
    """Inverse particulate+water scattering length [1/m] in sea water
    (I3CLSimFunctionScatLenPartic.cxx, the Kopelevich small/large particle
    volume-concentration model)."""
    x550 = _over(550.0, _t(wlen_nm))
    b_water = 0.0017 * x550 ** 4.3
    b_small = 1.34 * p.vol_conc_small * x550 ** 1.7
    b_large = 0.312 * p.vol_conc_large * x550 ** 0.3
    return b_water + b_small + b_large


# ---------------------------------------------------------------------------
# Generic function models
# ---------------------------------------------------------------------------

class TableParams(NamedTuple):
    """Equidistantly-sampled table with linear interpolation (the equivalent of
    the reference's I3CLSimFunctionFromTable in equal-spacing mode)."""
    first_x: torch.Tensor
    dx: torch.Tensor
    values: torch.Tensor  # (n,)


def eval_table(t: TableParams, x):
    x = _t(x)
    xi = (x - t.first_x) / t.dx
    n = t.values.shape[0]
    i0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, n - 2)
    frac = torch.clamp(xi - i0.to(xi.dtype), 0.0, 1.0)
    v0 = t.values[i0]
    v1 = t.values[i0 + 1]
    return v0 + frac * (v1 - v0)


def eval_polynomial(coeffs, x):
    """Horner evaluation of sum_i coeffs[i] * x^i (the reference's
    I3CLSimFunctionPolynomial, used for DOM angular sensitivity)."""
    x = _t(x)
    coeffs = _t(coeffs, like=x)
    out = torch.zeros_like(x) + coeffs[-1]
    for i in range(coeffs.shape[0] - 2, -1, -1):
        out = out * x + coeffs[i]
    return out
