"""Wavelength-dependent optical property functions (IceCube deep ice).

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

The sea-water models (Quan-Fry, Kopelevich) wait for the media item of
ROADMAP.md queue A.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
