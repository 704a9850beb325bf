"""An analytic referee for photon tables (tabulator/table.py), in float64.

With scattering off (a scattering length far beyond the table's radius) and
no anisotropy, a photon emitted at the source flies straight out and the
comb deposits one entry per step_length of path, at a uniformly random
offset, each weighing A(dir_z) exp(-s / lambda_a(lambda)).  For isotropic
emission at the source the unnormalized content of a radial shell
[r0, r1), summed over azimuth, cos(polar) and time, then has the
expectation

    N * Abar * sum_lambda p(lambda) lambda_a(lambda)
        * (exp(-r0 / lambda_a) - exp(-r1 / lambda_a)) / step_length

with p the wavelength pdf the engine samples from the spectra table (the
piecewise-linear density of ops/samplers.build_interpolated_dist),
lambda_a the medium's absorption length and Abar the isotropic mean of the
angular-acceptance polynomial.  The fixed horizon cuts each photon at
horizon * lambda_a.  This is independent of the JAX package.

radial_z holds the summed content of G independent runs against G times
the expectation, with the standard error taken from the spread of the runs.
"""

from __future__ import annotations

import numpy as np
import torch


def wavelength_nodes(spectra, row: int = 0, n_gauss: int = 16):
    """(lambda, weight) float64 quadrature of E[f(lambda)] under the
    sampled piecewise-linear pdf of spectra row `row` (Gauss-Legendre on
    every segment of nonzero width; the weights sum to 1)."""
    x = spectra.x[row].detach().cpu().numpy().astype(np.float64)
    b = spectra.beta[row].detach().cpu().numpy().astype(np.float64)
    keep = x[1:] > x[:-1]
    x0, x1, b0, b1 = x[:-1][keep], x[1:][keep], b[:-1][keep], b[1:][keep]
    g, gw = np.polynomial.legendre.leggauss(n_gauss)
    t = 0.5 * (g + 1.0)
    lam = x0[:, None] + t[None, :] * (x1 - x0)[:, None]
    p = b0[:, None] + (b1 - b0)[:, None] * t[None, :]
    w = p * 0.5 * gw[None, :] * (x1 - x0)[:, None]
    return lam.ravel(), (w / w.sum()).ravel()


def angular_mean(coeffs) -> float:
    """Isotropic mean of sum_i c_i cos^i over cos in [-1, 1]."""
    c = np.asarray(torch.as_tensor(coeffs).cpu(), np.float64)
    return float(sum(c[i] / (i + 1) for i in range(0, len(c), 2)))


def radial_expectation(medium, spectra, angular_coeffs, r_edges,
                       n_photons: float, step_length: float = 1.0,
                       horizon: float = 46.0, z: float = 0.0) -> np.ndarray:
    """Expected unnormalized content of each radial shell between
    consecutive `r_edges` [m] for n_photons isotropic photons at depth z of
    a homogeneous medium without scattering (float64)."""
    lam, w = wavelength_nodes(spectra)
    layer = int(medium.layer_for_z(torch.tensor(float(z))).item())
    inv_a = medium.inv_absorption_length(
        layer, torch.as_tensor(lam, dtype=torch.float64,
                               device=medium.device))
    la = 1.0 / inv_a.double().cpu().numpy()
    r = np.asarray(r_edges, np.float64)
    cut = horizon * la[:, None]
    e = np.exp(-np.minimum(r[None, :], cut) / la[:, None])
    per = la[:, None] * (e[:, :-1] - e[:, 1:])
    return (n_photons * angular_mean(angular_coeffs)
            * (w[:, None] * per).sum(0) / step_length)


def radial_shells(raw, shape, groups):
    """Per-group radial content of a raw flat table: the sum over every
    other axis (under/overflow bins included) of the radial data bins
    [lo, hi) of each (lo, hi) in `groups` (data bins numbered from 0)."""
    per_r = raw.reshape(shape).sum(dim=tuple(range(1, len(shape))))
    per_r = per_r.double().cpu().numpy()[1:-1]
    return np.array([per_r[lo:hi].sum() for lo, hi in groups])


def radial_z(shell_runs, expected_run) -> np.ndarray:
    """z of the summed shells of G runs ((G, S) array) against G times the
    per-run expectation (S,), with the standard error sqrt(G) * the runs'
    sample standard deviation."""
    runs = np.asarray(shell_runs, np.float64)
    g = runs.shape[0]
    se = np.sqrt(g) * runs.std(0, ddof=1)
    return (runs.sum(0) - g * np.asarray(expected_run)) / se
