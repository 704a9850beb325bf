"""Cherenkov spectrum, wavelength-bias importance sampling, and the
Frank-Tamm photon yield integral.

PyTorch counterpart of clsim_tpu.ops.spectrum.  It implements the
reference's wavelength-bias contract: photon wavelengths are drawn from the
bias-weighted Cherenkov spectrum bias(lambda) * dN/dlambda, the step yield is
the bias-weighted Frank-Tamm integral, and at detection the recorded weight
is step.weight / bias(lambda) (propagation_kernel.c.cl:370).

The sampler is a linear-interpolated inverse-CDF table exactly like the
reference's I3CLSimRandomValueInterpolatedDistribution built by
makeCherenkovWavelengthGenerator (I3CLSimModuleHelper.cxx:176-300).  The
per-spectrum tables are built on the host (numpy); SpectrumTable holds the
stacked tables as tensors on the propagation device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import TWO_PI_OVER_137
from ..medium import functions as F
from .samplers import (interp_solve, locate_segment,
                       sample_interpolated_dist)


def cherenkov_yield_density(ref_index: F.RefIndexParams, wlen_nm, beta=1.0):
    """dN/(dx dlambda): 2*pi*alpha_fs * (1 - 1/(beta n)^2)/lambda^2 in
    photons/(m nm) (I3CLSimModuleHelper.cxx:52-63)."""
    n = F.phase_ref_index(ref_index, wlen_nm)
    return TWO_PI_OVER_137 * (1.0 - 1.0 / (beta * n) ** 2) * 1e9 \
        / (wlen_nm * wlen_nm)


def interp(x, xp, fp):
    """numpy.interp for tensors: linear interpolation, clamped at the ends."""
    n = xp.shape[0]
    k = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True) - 1, 0, n - 2)
    x0, x1 = xp[k], xp[k + 1]
    f0, f1 = fp[k], fp[k + 1]
    t = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-30), 0.0, 1.0)
    return f0 + t * (f1 - f0)


def photons_per_meter(ref_index: F.RefIndexParams,
                      bias_wlen_nm, bias_values,
                      min_wlen_nm: float, max_wlen_nm: float,
                      n_points: int = 1024, beta: float = 1.0):
    """Bias-weighted Frank-Tamm integral: number of Cherenkov photons emitted
    per meter of beta=1 track, counting only bias-sampled photons
    (NumberOfPhotonsPerMeter, I3CLSimLightSourceToStepConverterUtils.cxx:
    71-106, as a float32 trapezoid quadrature).  Returns a float."""
    wl = torch.linspace(min_wlen_nm, max_wlen_nm, n_points,
                        dtype=torch.float32)
    dens = torch.clamp(cherenkov_yield_density(ref_index, wl, beta), min=0.0)
    if bias_values is not None:
        bias = interp(wl, torch.tensor(np.asarray(bias_wlen_nm, np.float32)),
                      torch.tensor(np.asarray(bias_values, np.float32)))
        dens = dens * bias
    return float(torch.trapezoid(dens, wl))


class WavelengthSpectrum(NamedTuple):
    """Inverse-CDF sampling tables for one emission spectrum (host arrays),
    plus the bias curve needed to unweight at detection."""
    x: np.ndarray       # (n,) wavelengths [nm]
    acu: np.ndarray     # (n,) normalized CDF
    beta: np.ndarray    # (n,) normalized density
    bias_x: np.ndarray  # bias table for getWavelengthBias(lambda)
    bias_y: np.ndarray


def _np_interpolated_dist(x, y):
    """Host-side (numpy) samplers.build_interpolated_dist."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    widths = x[1:] - x[:-1]
    segs = widths * (y[1:] + y[:-1]) / 2.0
    acu = np.concatenate([[0.0], np.cumsum(segs)])
    total = acu[-1]
    return (x.astype(np.float32), (acu / total).astype(np.float32),
            (y / total).astype(np.float32))


def _np_phase_ref_index(ref_index: F.RefIndexParams, wl):
    n = np.asarray(ref_index.n.cpu() if isinstance(ref_index.n, torch.Tensor)
                   else ref_index.n, np.float32)
    x = np.asarray(wl, np.float32) * np.float32(1e-3)   # float32, as in JAX
    return n[0] + x * (n[1] + x * (n[2] + x * (n[3] + x * n[4])))


def make_cherenkov_spectrum(ref_index: F.RefIndexParams,
                            min_wlen_nm: float, max_wlen_nm: float,
                            bias_wlen_nm=None, bias_values=None,
                            step_nm: float = 10.0) -> WavelengthSpectrum:
    """Build the (biased) Cherenkov wavelength sampler (host-side numpy).

    Mirrors makeCherenkovWavelengthGenerator: if the bias is a table, use its
    binning; otherwise make a ~10nm grid over the medium range
    (I3CLSimModuleHelper.cxx:224-300)."""
    if bias_wlen_nm is not None:
        wl = np.asarray(bias_wlen_nm, np.float64)
        bias = np.asarray(bias_values, np.float64)
    else:
        n_points = int((max_wlen_nm - min_wlen_nm) / step_nm) + 2
        wl = np.linspace(min_wlen_nm, max_wlen_nm, n_points)
        bias = np.ones_like(wl)
    n = _np_phase_ref_index(ref_index, wl)
    dens = TWO_PI_OVER_137 * (1.0 - 1.0 / (n * n)) * 1e9 / (wl * wl)
    x, acu, beta = _np_interpolated_dist(wl, bias * dens)
    return WavelengthSpectrum(x=x, acu=acu, beta=beta,
                              bias_x=wl.astype(np.float32),
                              bias_y=bias.astype(np.float32))


def make_tabulated_spectrum(wlen_nm, density,
                            bias_wlen_nm=None, bias_values=None) -> WavelengthSpectrum:
    """Sampler for an arbitrary tabulated emission spectrum (flasher LEDs),
    optionally multiplied by the generation bias (makeWavelengthGenerator,
    I3CLSimModuleHelper.cxx:74-170)."""
    wl = np.asarray(wlen_nm, np.float64)
    dens = np.asarray(density, np.float64)
    if bias_values is not None:
        bias = np.interp(wl, np.asarray(bias_wlen_nm), np.asarray(bias_values))
        bias_x = np.asarray(bias_wlen_nm, np.float32)
        bias_y = np.asarray(bias_values, np.float32)
    else:
        bias = np.ones_like(wl)
        bias_x, bias_y = wl.astype(np.float32), bias.astype(np.float32)
    x, acu, beta = _np_interpolated_dist(wl, dens * bias)
    return WavelengthSpectrum(x=x, acu=acu, beta=beta, bias_x=bias_x, bias_y=bias_y)


class SpectrumTable(NamedTuple):
    """Stacked per-source-type spectra (index 0 = Cherenkov, >=1 flashers) as
    tensors -- the equivalent of I3CLSimSpectrumTable + the kernel's
    generateWavelength dispatch (propagation_kernel.c.cl:153-183)."""
    x: torch.Tensor       # (n_spectra, n)
    acu: torch.Tensor     # (n_spectra, n)
    beta: torch.Tensor    # (n_spectra, n)
    bias_x: torch.Tensor  # (nb,)   (bias is shared: the DOM acceptance)
    bias_y: torch.Tensor  # (nb,)


def stack_spectra(spectra, device="cuda") -> SpectrumTable:
    n = max(np.shape(s.x)[0] for s in spectra)

    def pad(a):
        a = np.asarray(a)
        if a.shape[0] == n:
            return a
        return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], 0)])

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SpectrumTable(
        x=t(np.stack([pad(s.x) for s in spectra])),
        acu=t(np.stack([pad(s.acu) for s in spectra])),
        beta=t(np.stack([pad(s.beta) for s in spectra])),
        bias_x=t(spectra[0].bias_x), bias_y=t(spectra[0].bias_y))


def source_type_range(source_type):
    """(smallest, largest) source_type of a step batch's column (numpy or a
    tensor; a tensor on the card syncs), (0, 0) when it is empty."""
    if isinstance(source_type, torch.Tensor):
        if source_type.numel() == 0:
            return 0, 0
        lo, hi = torch.stack([source_type.min(), source_type.max()]).tolist()
        return int(lo), int(hi)
    a = np.asarray(source_type)
    return (int(a.min()), int(a.max())) if a.size else (0, 0)


def check_source_types(lo: int, hi: int, n_tables: int):
    """Raise ValueError when a step's source_type has no stacked spectrum.

    The JAX package samples such a photon from the Cherenkov spectrum when
    one spectrum is stacked (sample_wavelength_dispatch ignores source_type
    there) and returns NaN wavelengths when several are; the CUDA kernel
    would read past its spectrum table.  A FlasherPulse (default
    spectrum_index=1) given to a Simulation built without flasher_spectra
    is the usual cause."""
    bad = hi if hi >= n_tables else lo if lo < 0 else None
    if bad is not None:
        raise ValueError(
            f"a step has source_type {bad}, but only {n_tables} spectra are "
            f"stacked (index 0 Cherenkov, flasher LEDs from 1): stack the "
            "LED spectrum on the Simulation (flasher_spectra=[led_spectrum("
            "405), ...]) and set the pulse's spectrum_index to its position "
            "(FlasherPulse(spectrum_index=...), or flasher_info_to_pulses("
            "spectrum_index_by_wlen=...))")


def sample_wavelength(spec: WavelengthSpectrum, u):
    """Inverse-CDF wavelengths [nm] of one spectrum from uniforms `u` (a
    tensor; the spectrum's host tables go to its device)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=u.device)
    return sample_interpolated_dist((t(spec.x), t(spec.acu), t(spec.beta)),
                                    u)


def wavelength_bias(spectra, wlen_nm):
    """getWavelengthBias(lambda): linear interp of the bias table; the saved
    photon weight is step.weight / bias (propagation_kernel.c.cl:370)."""
    return interp(wlen_nm, spectra.bias_x, spectra.bias_y)


def sample_wavelength_dispatch(table: SpectrumTable, source_type, u):
    """Sample lambda for per-photon source types (0=Cherenkov, >=1 flasher)
    by inverse CDF: locate the CDF segment, then the quadratic solve."""
    n_spectra, n = table.x.shape
    if n_spectra == 1:
        k = locate_segment(table.acu[0], u)
        row = 0
    else:
        st = source_type.to(torch.int64)
        k = torch.clamp((table.acu[st] <= u[:, None]).sum(-1) - 1, 0, n - 2)
        row = st
    return interp_solve(u, table.x[row, k], table.x[row, k + 1],
                        table.beta[row, k], table.beta[row, k + 1],
                        table.acu[row, k])
