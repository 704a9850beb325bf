"""Ice-layer tilt: z-shift scalar field over (distance-along-tilt-azimuth, z).

PyTorch counterpart of clsim_tpu.medium.tilt (the reference's
I3CLSimScalarFieldIceTiltZShift, I3CLSimScalarFieldIceTiltZShift.cxx:145-285).
The photon's effective z for the medium-layer lookup is
z - tilt_z_shift(x, y, z): bilinear interpolation over a uniform z grid and a
small non-uniform distance grid, with linear extrapolation outside the
distance range and clamped-index extrapolation in z.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TiltParams(NamedTuple):
    distances: torch.Tensor    # (nd,) distances along the tilt azimuth [m]
    first_z: torch.Tensor      # () first z coordinate of the grid [m]
    z_spacing: torch.Tensor    # () uniform z spacing [m]
    z_corrections: torch.Tensor  # (nd, nz) z-shift values [m]
    azimuth_cos: torch.Tensor  # () cos of the tilt direction azimuth
    azimuth_sin: torch.Tensor
    enabled: bool = True       # False -> zero shift


def tilt_z_shift(p: TiltParams, x, y, z):
    if not p.enabled:
        return torch.zeros_like(z)
    nd, nz = p.z_corrections.shape

    z_rescaled = (z - p.first_z) / p.z_spacing
    k = torch.clamp(torch.floor(z_rescaled).to(torch.int64), 0, nz - 2)
    fz_above = z_rescaled - k.to(z_rescaled.dtype)
    fz_below = 1.0 - fz_above

    nr = p.azimuth_cos * x + p.azimuth_sin * y

    # first j in [1, nd-1] with nr < distances[j], else nd-1
    j = torch.clamp(torch.searchsorted(p.distances, nr.contiguous(),
                                       right=True), 1, nd - 1)

    zc = p.z_corrections
    d_lo, d_hi = p.distances[j - 1], p.distances[j]
    q_ll, q_lh = zc[j - 1, k], zc[j - 1, k + 1]
    q_hl, q_hh = zc[j, k], zc[j, k + 1]

    frac_lo = (d_hi - nr) / (d_hi - d_lo)
    frac_hi = 1.0 - frac_lo
    val_lo = q_lh * fz_above + q_ll * fz_below
    val_hi = q_hh * fz_above + q_hl * fz_below
    return val_hi * frac_hi + val_lo * frac_lo


def load_tilt(tilt_par_path, tilt_dat_path, detector_center_depth,
              azimuth=225.0 * np.pi / 180.0, device="cuda"):
    """Build TiltParams from PPC tilt.par/tilt.dat files.

    File contract (reference python/util/GetIceTiltZShift.py:46-61):
    tilt.par column 1 = distance from origin along tilt azimuth per map line;
    tilt.dat column 0 = depth, columns 1..nd = z correction per distance; depth
    rows are converted to ascending z via z = center_depth - depth and flipped.
    """
    distances = np.loadtxt(tilt_par_path, unpack=True)[1]
    dat = np.loadtxt(tilt_dat_path, unpack=True)
    zcoords = (detector_center_depth - dat[0])[::-1]
    zshift = np.array([dat[i + 1][::-1] for i in range(len(distances))])

    spacing = np.diff(zcoords)
    if not np.allclose(spacing, spacing[0], atol=1e-6):
        raise ValueError("tilt.dat depth grid is not uniform")

    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return TiltParams(
        distances=f32(distances),
        first_z=f32(zcoords[0]),
        z_spacing=f32(spacing[0]),
        z_corrections=f32(zshift),
        azimuth_cos=f32(np.cos(azimuth)),
        azimuth_sin=f32(np.sin(azimuth)),
        enabled=True,
    )


def disabled_tilt(device="cuda"):
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return TiltParams(
        distances=torch.zeros(2, dtype=torch.float32, device=device),
        first_z=f32(0.0), z_spacing=f32(1.0),
        z_corrections=torch.zeros((2, 2), dtype=torch.float32, device=device),
        azimuth_cos=f32(1.0), azimuth_sin=f32(0.0),
        enabled=False,
    )


def numpy_tilt_z_shift(distances, zcoords, zshift, azimuth, x, y, z):
    """float64 numpy oracle of tilt_z_shift at one point, the reference's
    device code written out (I3CLSimScalarFieldIceTiltZShift.cxx:145-285)."""
    nd = len(distances)
    nz = len(zcoords)
    first_z = zcoords[0]
    spacing = zcoords[1] - zcoords[0]
    z_rescaled = (z - first_z) / spacing
    k = int(np.clip(np.floor(z_rescaled), 0, nz - 2))
    fz_above = z_rescaled - k
    fz_below = 1.0 - fz_above
    lnx, lny = np.cos(azimuth), np.sin(azimuth)
    nr = lnx * x + lny * y
    for j in range(1, nd):
        if (nr < distances[j]) or (j == nd - 1):
            w = distances[j] - distances[j - 1]
            frac_lo = (distances[j] - nr) / w
            frac_hi = 1.0 - frac_lo
            val_lo = zshift[j - 1][k + 1] * fz_above + zshift[j - 1][k] * fz_below
            val_hi = zshift[j][k + 1] * fz_above + zshift[j][k] * fz_below
            return val_hi * frac_hi + val_lo * frac_lo
    return 0.0
