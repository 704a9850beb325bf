"""Particle sanitizers (PyTorch port's copy of clsim_tpu.util.sanitize; the
geometry is the port's DetectorGeometry, read to float64 on the host).

- sanitize_taus: the I3TauSanitizer equivalent
  (private/clsim/util/I3TauSanitizer.cxx): taus without a valid length are
  marked dark (excluded from light generation) instead of being guessed.
- filter_light_sources: the ConvertMCTreeToLightSources filter
  (I3CLSimModule.cxx:1651+): drop dark particles, apply an optional
  closest-DOM distance cutoff against the detector hull.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..geometry import DetectorGeometry, to_numpy
from ..sources.particles import Particle, TAU_TYPES


def sanitize_taus(particles: Sequence[Particle]) -> List[Particle]:
    out = []
    for p in particles:
        if p.ptype in TAU_TYPES and (math.isnan(p.length) or not p.length > 0):
            continue  # "dark" tau: emits no direct light
        out.append(p)
    return out


def filter_light_sources(particles: Sequence[Particle],
                         geometry: Optional[DetectorGeometry] = None,
                         closest_dom_distance_cutoff: float = 300.0
                         ) -> List[Particle]:
    """Drop particles whose closest approach to any DOM exceeds the cutoff
    (the ExtrudedPolygon hull check approximated by a direct point/segment
    distance against the DOM cloud)."""
    if geometry is None:
        return list(particles)
    dx = to_numpy(geometry.dom_x, np.float64)
    dy = to_numpy(geometry.dom_y, np.float64)
    dz = to_numpy(geometry.dom_z, np.float64)
    out = []
    for p in particles:
        px, py, pz = p.x, p.y, p.z
        if not math.isnan(p.length) and p.length > 0:
            # sample a few points along the track
            ts = np.linspace(0.0, p.length, 8)
            qx = px + p.dir_x * ts
            qy = py + p.dir_y * ts
            qz = pz + p.dir_z * ts
            d2 = ((dx[None, :] - qx[:, None]) ** 2
                  + (dy[None, :] - qy[:, None]) ** 2
                  + (dz[None, :] - qz[:, None]) ** 2).min()
        else:
            d2 = ((dx - px) ** 2 + (dy - py) ** 2 + (dz - pz) ** 2).min()
        if d2 <= closest_dom_distance_cutoff ** 2:
            out.append(p)
    return out
