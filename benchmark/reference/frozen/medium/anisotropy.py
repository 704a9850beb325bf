"""Spice-Lea ice anisotropy: directional absorption scaling and pre/post
scatter direction distortion transforms.

PyTorch counterpart of clsim_tpu.medium.anisotropy (the reference's
I3CLSimScalarFieldAnisotropyAbsLenScaling.cxx:63-90 and the matrix
transforms of GetSpiceLeaAnisotropyTransforms.py:38-100).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AnisotropyParams(NamedTuple):
    azimuth: torch.Tensor       # direction of ice tilt (perp. to flow) [rad]
    mag_along: torch.Tensor     # anisotropy magnitude along tilt direction
    mag_perp: torch.Tensor      # anisotropy magnitude along flow
    enabled: bool = True        # False -> all three ops are no-ops


def _basis(p: AnisotropyParams):
    k1 = torch.exp(p.mag_along)
    k2 = torch.exp(p.mag_perp)
    kz = 1.0 / (k1 * k2)
    ca = torch.cos(p.azimuth)
    sa = torch.sin(p.azimuth)
    return k1, k2, kz, ca, sa


def abs_len_scaling(p: AnisotropyParams, dx, dy, dz):
    """Directional absorption-length scale factor for a photon direction:
    the remaining budget in absorption lengths is multiplied by it before the
    meters conversion and divided back out afterwards
    (propagation_kernel.c.cl:615-694)."""
    if not p.enabled:
        return torch.ones_like(dx)
    k1, k2, kz, ca, sa = _basis(p)
    l1, l2, l3 = k1 * k1, k2 * k2, kz * kz
    B2 = 1.0 / l1 + 1.0 / l2 + 1.0 / l3
    n1 = ca * dx + sa * dy
    n2 = -sa * dx + ca * dy
    n3 = dz
    s1, s2, s3 = n1 * n1, n2 * n2, n3 * n3
    nB = s1 / l1 + s2 / l2 + s3 / l3
    An = s1 * l1 + s2 * l2 + s3 * l3
    return 2.0 / ((B2 - nB) * An)


def _apply_diag_in_frame(p: AnisotropyParams, dx, dy, dz, d1, d2, d3):
    """Rotate into the anisotropy frame, scale by diag(d1,d2,d3), rotate back,
    renormalize. (T^T diag T) @ dir."""
    k1, k2, kz, ca, sa = _basis(p)
    n1 = ca * dx + sa * dy
    n2 = -sa * dx + ca * dy
    n3 = dz
    n1, n2, n3 = n1 * d1, n2 * d2, n3 * d3
    ox = ca * n1 - sa * n2
    oy = sa * n1 + ca * n2
    oz = n3
    inv_norm = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv_norm, oy * inv_norm, oz * inv_norm


def pre_scatter_transform(p: AnisotropyParams, dx, dy, dz):
    """dir' = normalize(T^T A T dir), A = diag(e^k1, e^k2, 1/(e^k1 e^k2))."""
    if not p.enabled:
        return dx, dy, dz
    k1, k2, kz, _, _ = _basis(p)
    return _apply_diag_in_frame(p, dx, dy, dz, k1, k2, kz)


def post_scatter_transform(p: AnisotropyParams, dx, dy, dz):
    """dir' = normalize(T^T A^-1 T dir)."""
    if not p.enabled:
        return dx, dy, dz
    k1, k2, kz, _, _ = _basis(p)
    return _apply_diag_in_frame(p, dx, dy, dz, 1.0 / k1, 1.0 / k2, 1.0 / kz)


def numpy_abs_len_scaling(azimuth, mag_along, mag_perp, direction):
    """float64 numpy oracle of abs_len_scaling for one direction (x, y, z),
    the reference's device code written out (the tester pattern, SURVEY.md
    section 4.1)."""
    azx, azy = np.cos(azimuth), np.sin(azimuth)
    k1, k2 = np.exp(mag_along), np.exp(mag_perp)
    kz = 1.0 / (k1 * k2)
    l1, l2, l3 = k1 * k1, k2 * k2, kz * kz
    B2 = 1.0 / l1 + 1.0 / l2 + 1.0 / l3
    x, y, z = direction
    n1 = azx * x + azy * y
    n2 = -azy * x + azx * y
    n3 = z
    s1, s2, s3 = n1 * n1, n2 * n2, n3 * n3
    nB = s1 / l1 + s2 / l2 + s3 / l3
    An = s1 * l1 + s2 * l2 + s3 * l3
    return 1.0 / ((B2 - nB) * An / 2.0)
