"""Multi-PMT optical module hit conversion (KM3NeT-style).

PyTorch counterpart of clsim_tpu.hits.multi_pmt, the equivalent of
I3PhotonToMCHitConverterForMultiPMT
(private/clsim/dom/I3PhotonToMCHitConverterForMultiPMT.cxx): an OM carries
many small PMTs at fixed orientations; a photon recorded on the OM sphere is
assigned to the PMT whose cathode it geometrically enters, with the
acceptance product

    p = weight * wavelengthAcceptance(lambda) * angularAcceptance(cos eta)

per PMT (eta vs the PMT axis), accept/reject.  PMT assignment uses the
photon's DOM-relative hit position: it must fall within the PMT's opening
cone (cathode radius / OM radius) around the PMT direction.

The Bernoulli draw comes from an explicit torch.Generator, or from
`uniforms` of the flattened records' shape (so a test can hand in the draw
the JAX package makes), as in hits/mcpe.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..medium.functions import TableParams, eval_table
from .acceptance import angular_factor
from .mcpe import _accept
from .photons import _ring_mask


class MultiPMTLayout(NamedTuple):
    """PMT directions (unit, pointing outward from the OM center) and the
    cathode opening half-angle cosine."""
    dirs: torch.Tensor       # (n_pmt, 3)
    cos_opening: float


# KM3NeT DOM ring arrangement (zenith angle from straight up, PMT count,
# azimuth offset): 12 PMTs in two upper-hemisphere rings at 56 and 72 deg,
# 18 in three lower rings at 107, 124 and 148 deg staggered by 30 deg, plus
# one nadir PMT -- the published 31-PMT multi-PMT DOM design the reference
# converter reads from its detector geometry service
# (I3PhotonToMCHitConverterForMultiPMT.cxx:150-230).
KM3NET_PMT_RINGS = [
    (56.0, 6, 0.0),
    (72.0, 6, 30.0),
    (107.0, 6, 0.0),
    (124.0, 6, 30.0),
    (148.0, 6, 0.0),
    (180.0, 1, 0.0),
]


def km3net_31_pmt_layout(om_radius: float = 0.2159,
                         pmt_cathode_radius: float = 0.04,
                         device="cuda") -> MultiPMTLayout:
    """The 31-PMT KM3NeT DOM from the published ring arrangement
    (KM3NET_PMT_RINGS); the cathode opening half-angle follows from the
    3-inch PMT photocathode radius against the 17-inch sphere."""
    dirs = []
    for zen_deg, count, azi0_deg in KM3NET_PMT_RINGS:
        cz = np.cos(np.radians(zen_deg))
        sz = np.sin(np.radians(zen_deg))
        for k in range(count):
            phi = np.radians(azi0_deg) + 2 * np.pi * k / max(count, 1)
            dirs.append([sz * np.cos(phi), sz * np.sin(phi), cz])
    cos_opening = float(np.cos(np.arcsin(
        min(pmt_cathode_radius / om_radius, 1.0))))
    return MultiPMTLayout(
        dirs=torch.as_tensor(np.asarray(dirs, np.float32), device=device),
        cos_opening=cos_opening)


def assign_pmts(layout: MultiPMTLayout, hit_x, hit_y, hit_z):
    """PMT index (int32) for DOM-relative hit positions, or -1 if no
    cathode covers the entry point."""
    r = torch.sqrt(hit_x ** 2 + hit_y ** 2 + hit_z ** 2)
    rc = torch.clamp(r, min=1e-20)
    nx, ny, nz = hit_x / rc, hit_y / rc, hit_z / rc
    d = layout.dirs.to(hit_x.device)
    cos = (nx[:, None] * d[None, :, 0] + ny[:, None] * d[None, :, 1]
           + nz[:, None] * d[None, :, 2])
    best_cos, best = torch.max(cos, dim=1)
    return torch.where(best_cos >= layout.cos_opening, best.to(torch.int32),
                       torch.full_like(best, -1, dtype=torch.int32))


def sample_multi_pmt_hits(rec: dict, rec_count,
                          generator: Optional[torch.Generator],
                          layout: MultiPMTLayout,
                          wlen_acceptance: TableParams, angular_coeffs,
                          efficiency=1.0, uniforms=None):
    """Photon records (either record contract, hits/photons.py) ->
    (accept, dom, pmt, time), flattened over slots x capacity: accept marks
    the photoelectrons.  The draw comes from `generator` unless `uniforms`
    (of the flattened records' shape) is given."""
    cap = rec["time"].shape[1]
    flat = {k: v.reshape(-1) for k, v in rec.items()}
    valid = _ring_mask(rec_count, cap, flat["time"].device).reshape(-1)

    pmt = assign_pmts(layout, flat["pos_x"], flat["pos_y"], flat["pos_z"])

    theta, phi = flat["dir_theta"], flat["dir_phi"]
    dx = torch.sin(theta) * torch.cos(phi)
    dy = torch.sin(theta) * torch.sin(phi)
    dz = torch.cos(theta)
    d = layout.dirs.to(theta.device)
    ax = d[pmt.clamp(0, d.shape[0] - 1).to(torch.int64)]
    cos_impact = -(dx * ax[:, 0] + dy * ax[:, 1] + dz * ax[:, 2])

    p = flat["weight"] * eval_table(wlen_acceptance, flat["wavelength"])
    p = p * angular_factor(angular_coeffs, cos_impact)
    p = p * efficiency
    accept = _accept(p, None, valid & (pmt >= 0), None, generator, uniforms)
    return accept, flat["dom"].to(torch.int32), pmt, flat["time"]
