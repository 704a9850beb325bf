"""Direction rotation for scattering / Cherenkov cone sampling.

PyTorch counterpart of clsim_tpu.ops.rotations: the reference's
scatterDirectionByAngle (propagation_kernel.c.cl:83-129) rotates a unit
vector by a polar angle (given as cos/sin) around a uniformly random azimuth
about its own axis.
"""

from __future__ import annotations

import math

import torch


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def scatter_direction_by_angle(cosa, sina, dx, dy, dz, u_azimuth):
    """Rotate unit direction (dx,dy,dz) by angle (cosa,sina) with azimuth
    2*pi*u_azimuth about the old direction.  Branchless version of the
    vertical/non-vertical split; renormalizes like the reference."""
    b = 2.0 * math.pi * u_azimuth
    cosb = torch.cos(b)
    sinb = torch.sin(b)

    sinth = safe_sqrt(1.0 - dz * dz)

    # general (non-vertical) branch; the vertical lanes divide by 1 and are
    # replaced below
    safe_sinth = torch.where(sinth > 0.0, sinth, torch.ones_like(sinth))
    gx = dx * cosa - (dy * cosb + dz * dx * sinb) * sina / safe_sinth
    gy = dy * cosa + (dx * cosb - dz * dy * sinb) * sina / safe_sinth
    gz = dz * cosa + sina * sinb * sinth

    # vertical branch
    vx = sina * cosb
    vy = sina * sinb
    vz = cosa * torch.sign(dz)

    vertical = sinth <= 0.0
    nx = torch.where(vertical, vx, gx)
    ny = torch.where(vertical, vy, gy)
    nz = torch.where(vertical, vz, gz)

    inv_norm = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv_norm, ny * inv_norm, nz * inv_norm


def sph_to_cart(theta, phi):
    st = torch.sin(theta)
    return st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)


def cart_to_sph(dx, dy, dz):
    """(theta, phi) with theta in [0, pi], phi in [0, 2pi) -- the reference's
    sphDirFromCar (propagation_kernel.c.cl:186-224)."""
    r_inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    cz = torch.clamp(dz * r_inv, -1.0, 1.0)
    theta = torch.arccos(cz)
    phi = torch.atan2(dy, dx)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return theta, phi
