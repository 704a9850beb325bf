"""Muon slicing: chop an energy-loss-propagated muon into track slices with
interpolated energies.

Standalone equivalent of I3MuonSlicer (private/clsim/util/I3MuonSlicer.cxx):
given a muon with start energy Ei and its time-sorted stochastic losses
(daughter cascades along the track), emit muon slices between consecutive
losses whose energies interpolate the continuous loss:

    E(t) = Ei - cumulative_stochastic_losses(t)
           - (Ei - Ef - total_stochastic) * (t - ti)/(tf - ti)

Each slice is a track segment (CascadeSegment-style) that the PPC step
generator converts with uniform emission along its length.  The inverse
relabeling (undo slicing, reassign MCPE parents to the original muon) is
`unslice_hits`, the I3MuonSliceRemoverAndPulseRelabeler equivalent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from ..constants import C_LIGHT
from ..sources.particles import MUON_TYPES, Particle, ParticleType


def slice_muon(muon: Particle,
               daughters: Sequence[Particle],
               final_energy: float = 0.0) -> List[Particle]:
    """Return muon slices (between daughters) for a muon of length L.

    `daughters` are the stochastic losses (cascades) already positioned on
    the track, sorted by time; their energies are subtracted from the muon's
    continuous budget exactly like the reference (I3MuonSlicer.cxx:247-360).
    """
    if muon.ptype not in MUON_TYPES:
        raise ValueError("slice_muon needs a muon")
    L = muon.length
    if not (L > 0) or math.isnan(L):
        raise ValueError("muon must have a valid length")
    Ei = muon.energy
    Ef = final_energy
    ti = muon.time
    tf = ti + L / C_LIGHT

    ds = sorted(daughters, key=lambda p: p.time)
    total_stoch = sum(d.energy for d in ds)
    continuous = max(Ei - Ef - total_stoch, 0.0)

    slices: List[Particle] = []
    cum_stoch = 0.0
    t_prev = ti
    points = [d.time for d in ds] + [tf]
    for k, t_next in enumerate(points):
        t_next = min(max(t_next, ti), tf)
        if t_next > t_prev:
            frac = (t_prev - ti) / (tf - ti)
            e_here = max(Ei - cum_stoch - continuous * frac, 0.0)
            d0 = (t_prev - ti) * C_LIGHT
            seg_len = (t_next - t_prev) * C_LIGHT
            slices.append(Particle(
                ptype=muon.ptype,
                x=muon.x + muon.dir_x * d0,
                y=muon.y + muon.dir_y * d0,
                z=muon.z + muon.dir_z * d0,
                time=t_prev, energy=e_here,
                dir_x=muon.dir_x, dir_y=muon.dir_y, dir_z=muon.dir_z,
                length=seg_len))
        if k < len(ds):
            cum_stoch += ds[k].energy
        t_prev = t_next
    return slices


def unslice_hits(hit_identifiers, slice_to_parent: dict):
    """Relabel hit identifiers of slices back to the original muon
    (I3MuonSliceRemoverAndPulseRelabeler equivalent)."""
    return [slice_to_parent.get(int(i), int(i)) for i in hit_identifiers]
