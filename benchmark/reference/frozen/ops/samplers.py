"""Inverse-CDF random-value samplers.

PyTorch counterparts of clsim_tpu.ops.samplers (the reference's
I3CLSimRandomValue hierarchy, public/clsim/random_value/*.h).  Every sampler
is a transform of uniform variates, so two implementations fed the same
uniforms return the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def henyey_greenstein_cos(g, u):
    """cos(theta) ~ HG(g).  Inverse CDF: with s = 2u-1,
    cos = (1 + g^2 - ((1-g^2)/(1+g s))^2) / (2 g)
    (I3CLSimRandomValueHenyeyGreenstein.cxx:52-70); isotropic for |g| ~ 0."""
    g = torch.as_tensor(g, dtype=u.dtype, device=u.device)
    s = 2.0 * u - 1.0
    small = torch.abs(g) < 1e-6
    g_safe = torch.where(small, torch.full_like(g, 1e-6), g)
    frac = (1.0 - g_safe * g_safe) / (1.0 + g_safe * s)
    cos = (1.0 + g_safe * g_safe - frac * frac) / (2.0 * g_safe)
    cos = torch.where(small, s, cos)
    return torch.clamp(cos, -1.0, 1.0)


def simplified_liu_cos(g, u):
    """cos(theta) ~ simplified Liu (SAM): cos = 2*u^beta - 1,
    beta = (1-g)/(1+g) (I3CLSimRandomValueSimplifiedLiu.cxx:52-61)."""
    beta = (1.0 - g) / (1.0 + g)
    return torch.clamp(2.0 * u ** beta - 1.0, -1.0, 1.0)


def mixed_cos(g, liu_fraction, u_select, u_sample):
    """Mixture: with prob. liu_fraction sample simplified-Liu, else HG
    (I3CLSimRandomValueMixed.cxx; MakeIceCubeMediumProperties.py:183-187)."""
    liu = simplified_liu_cos(g, u_sample)
    hg = henyey_greenstein_cos(g, u_sample)
    return torch.where(u_select < liu_fraction, liu, hg)


def rayleigh_cos(u):
    """Rayleigh scattering angle by the closed cubic solve used for water
    phase functions (I3CLSimRandomValueRayleighScatteringCosAngle.cxx):
    cos = cbrt(-q + sqrt(d)) + cbrt(-q - sqrt(d)), d = q^2 + p^3."""
    b = 0.835
    p = 1.0 / 0.835
    q = (b + 3.0) * (u - 0.5) / b
    d = q * q + p * p * p
    u1 = -q + torch.sqrt(d)
    u1 = torch.sign(u1) * torch.abs(u1) ** (1.0 / 3.0)
    v1 = -q - torch.sqrt(d)
    v1 = torch.sign(v1) * torch.abs(v1) ** (1.0 / 3.0)
    return torch.clamp(u1 + v1, -1.0, 1.0)


def normal_box_muller(u1, u2):
    """Standard normal via Box-Muller from two uniform tensors (the
    reference's I3CLSimRandomValueNormalDistribution)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-38)))
    return r * torch.cos(2.0 * math.pi * u2)


# ---------------------------------------------------------------------------
# Tabulated pdf -> linear-interpolated inverse CDF
# (equivalent of I3CLSimRandomValueInterpolatedDistribution)
# ---------------------------------------------------------------------------

def build_interpolated_dist(x, y):
    """Sampling tables (x, acu, beta) for a piecewise-linear pdf given by
    support points x (ascending) and non-negative densities y: the
    reference's trapezoidal construction
    (I3CLSimRandomValueInterpolatedDistribution.cxx:140-177)."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    y = torch.as_tensor(np.asarray(y)) if not isinstance(y, torch.Tensor) else y
    widths = x[1:] - x[:-1]
    segs = widths * (y[1:] + y[:-1]) / 2.0
    acu = torch.cat([torch.zeros(1, dtype=y.dtype, device=y.device),
                     torch.cumsum(segs, 0)])
    total = acu[-1]
    return x, acu / total, y / total


def interp_solve(u, x0, x1, b0, b1, acu0):
    """Inverse-CDF quadratic solve within a located segment
    (…InterpolatedDistribution.cxx:84-135)."""
    slope = (b1 - b0) / (x1 - x0)
    dy = u - acu0
    eps = 1e-20
    s_zero = torch.abs(slope) < eps
    b_zero = torch.abs(b0) < eps
    safe_slope = torch.where(s_zero, torch.ones_like(slope), slope)
    safe_b = torch.where(b_zero, torch.ones_like(b0), b0)
    r_full = x0 + (torch.sqrt(torch.clamp(
        dy * 2.0 * safe_slope / (safe_b * safe_b) + 1.0, min=0.0)) - 1.0) \
        * safe_b / safe_slope
    r_bz = x0 + torch.sqrt(torch.clamp(2.0 * dy / safe_slope, min=0.0))
    r_sz = x0 + dy / safe_b
    return torch.where(b_zero & s_zero, x0,
                       torch.where(b_zero, r_bz,
                                   torch.where(s_zero, r_sz, r_full)))


def locate_segment(acu, u):
    """Segment index k = clip(#{acu <= u} - 1, 0, n-2) of a CDF table."""
    n = acu.shape[-1]
    k = torch.searchsorted(acu.contiguous(), u.contiguous(), right=True) - 1
    return torch.clamp(k, 0, n - 2)


def sample_interpolated_dist(tables, u):
    """Inverse-CDF sample from tables built by build_interpolated_dist;
    agrees with the reference to float precision given the same uniforms."""
    x, acu, beta = tables
    k = locate_segment(acu, u)
    return interp_solve(u, x[k], x[k + 1], beta[k], beta[k + 1], acu[k])


def sample_interpolated_fast(x, acu, beta, u):
    """The JAX package's gather-free form of sample_interpolated_dist (the
    sampler inside its TPU propagation loop); on a GPU a located gather is
    native, so this is the same function."""
    return sample_interpolated_dist((x, acu, beta), u)
