"""DOM acceptance curves: wavelength efficiency and angular sensitivity.

PyTorch counterpart of clsim_tpu.hits.acceptance (IceCube DOM curves only;
the AngularSensitivity cutoff form and the Gen2, Antares and KM3NeT sensors
wait for the media item of ROADMAP.md queue A).  Equivalents of the
reference's acceptance modules:
  * icecube_dom_acceptance  <-> GetIceCubeDOMAcceptance.py:36-116 -- the
    photonics/ROMEO effective-area table (a physical-constants table,
    260..680nm in 10nm bins) divided by the DOM cross-section.
  * dom_angular_sensitivity <-> GetIceCubeDOMAngularSensitivity.py -- a
    polynomial in cos(eta) loaded from a hole-ice parameterization file
    (first value = peak compensation, rest = coefficients).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DOM_RADIUS, PI
from ..medium.functions import TableParams, eval_polynomial

# IceCube PMT+glass+gel effective area [m^2] at normal incidence, 260-680nm in
# 10nm steps (the "dom2007a" ROMEO table adopted from photonics
# lib/efficiency.h; reproduced in GetIceCubeDOMAcceptance.py:62-104)
DOM2007A_EFF_AREA = np.array([
    0.0000064522, 0.0000064522, 0.0000064522, 0.0000064522, 0.0000021980,
    0.0001339040, 0.0005556810, 0.0016953000, 0.0035997000, 0.0061340900,
    0.0074592700, 0.0090579800, 0.0099246700, 0.0105769000, 0.0110961000,
    0.0114214000, 0.0114425000, 0.0111527000, 0.0108086000, 0.0104458000,
    0.0099763100, 0.0093102500, 0.0087516600, 0.0083225800, 0.0079767200,
    0.0075625100, 0.0066377000, 0.0053335800, 0.0043789400, 0.0037583500,
    0.0033279800, 0.0029212500, 0.0025334900, 0.0021115400, 0.0017363300,
    0.0013552700, 0.0010546600, 0.0007201020, 0.0004843820, 0.0002911110,
    0.0001782310, 0.0001144300, 0.0000509155])

DOM_ACCEPTANCE_FIRST_WLEN = 260.0   # nm
DOM_ACCEPTANCE_STEP = 10.0          # nm


def icecube_dom_acceptance(dom_radius: float = DOM_RADIUS,
                           efficiency: float = 1.0,
                           device="cuda") -> TableParams:
    """Wavelength acceptance = efficiency * eff_area / (pi * r^2) as an
    equidistant table (linear interp).  Pass dom_radius = R * oversize to
    fold the oversize factor into the bias exactly like the segments do
    (I3CLSimMakePhotons.py:395-397)."""
    dom_area = PI * dom_radius ** 2
    values = efficiency * DOM2007A_EFF_AREA / dom_area
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return TableParams(
        first_x=f32(DOM_ACCEPTANCE_FIRST_WLEN),
        dx=f32(DOM_ACCEPTANCE_STEP),
        values=f32(values))


# A widely-used hole-ice angular sensitivity polynomial in cos(eta)
# ("as.h2-50cm": 30cm-radius bubble column hole ice).  The file format the
# reference loads ($I3_SRC/ice-models/.../angsens/as.*) is first value = peak
# (compensation factor), remainder = polynomial coefficients; use
# load_angular_sensitivity() for custom files.
HOLE_ICE_H2_50CM = dict(
    peak=0.26266,
    coefficients=np.array([
        0.26266, 0.47659, 0.15480, -0.14588, 0.17316, 1.3070, 0.44441,
        -2.3538, -1.3564, 1.2098, 0.81569]))


def dom_angular_sensitivity(coefficients=None, device="cuda") -> torch.Tensor:
    """Polynomial coefficients (ascending order) of the relative collection
    efficiency vs cos(impact angle); defaults to the hole-ice h2-50cm model.
    Evaluate with medium.functions.eval_polynomial."""
    if coefficients is None:
        coefficients = HOLE_ICE_H2_50CM["coefficients"]
    return torch.as_tensor(np.asarray(coefficients, np.float32), device=device)


def angular_factor(coefficients, cos_eta):
    """Angular acceptance at cos(eta) (clamped to [-1, 1]) for a plain
    polynomial coefficient array, the IceCube hole-ice form (the polynomial
    branch of clsim_tpu.hits.acceptance.angular_factor)."""
    return eval_polynomial(coefficients, torch.clamp(cos_eta, -1.0, 1.0))


def load_angular_sensitivity(path: str):
    """Load a hole-ice angular sensitivity file (as.* format): returns
    (peak, coefficients) -- GetIceCubeDOMAngularSensitivity.py:43 drops the
    first value (the peak) and keeps the polynomial."""
    vals = np.loadtxt(path)
    return float(vals[0]), torch.as_tensor(vals[1:].astype(np.float32))
