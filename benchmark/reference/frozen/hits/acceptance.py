"""DOM acceptance curves: wavelength efficiency and angular sensitivity.

PyTorch counterpart of clsim_tpu.hits.acceptance.  Equivalents of the
reference's acceptance modules:
  * icecube_dom_acceptance  <-> GetIceCubeDOMAcceptance.py:36-116 -- the
    photonics/ROMEO effective-area table (a physical-constants table,
    260..680nm in 10nm bins) divided by the DOM cross-section.
  * dom_angular_sensitivity <-> GetIceCubeDOMAngularSensitivity.py -- a
    polynomial in cos(eta) loaded from a hole-ice parameterization file
    (first value = peak compensation, rest = coefficients).
  * the Gen2 sensors (Gen2Sensors.py: D-Egg, WOM), the Antares OM
    (GetAntaresOMAcceptance.py, GetAntaresOMAngularSensitivity.py) and the
    KM3NeT multi-PMT DOM (GetKM3NeTDOMAcceptance.py); the Antares angular
    curves are AngularSensitivity polynomials with a hard cutoff.
The constant tables are this module's own copy of the reference's.
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


def load_angular_sensitivity(path: str):
    """Load a hole-ice angular sensitivity file (as.* format): returns
    (peak, coefficients) -- GetIceCubeDOMAngularSensitivity.py:43 drops the
    first value (the peak) and keeps the polynomial."""
    vals = np.loadtxt(path)
    return float(vals[0]), torch.as_tensor(vals[1:].astype(np.float32))


def _table(first_x, dx, values, device) -> TableParams:
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return TableParams(first_x=f32(first_x), dx=f32(dx), values=f32(values))


# ---------------------------------------------------------------------------
# Gen2 sensors (python/Gen2Sensors.py -- D-Egg and WOM prototypes; the
# reference marks these numbers deprecated-but-shipped, matched as-is)
# ---------------------------------------------------------------------------

# Combined D-Egg glass (10mm) + high-UV gel (5mm) + Hamamatsu R5912-100
# center-of-photocathode efficiency, 250nm..670nm in 10nm bins
# (Gen2Sensors.py:19-63).
DEGG_CENTER_EFFICIENCY = np.array([
    0.0, 0.0, 0.0, 0.0005, 0.0093, 0.058, 0.1473, 0.2358, 0.2904, 0.3139,
    0.3237, 0.3336, 0.339, 0.3373, 0.3292, 0.3195, 0.3087, 0.3017, 0.2873,
    0.2717, 0.2532, 0.2305, 0.2119, 0.1962, 0.1832, 0.1708, 0.1523, 0.1227,
    0.0928, 0.0728, 0.0597, 0.0494, 0.0404, 0.0318, 0.0241, 0.0174, 0.0118,
    0.0076, 0.0047, 0.0027, 0.0, 0.0, 0.0])

# WOM wavelength-shifting-paint capture efficiency, 245nm.. in 10nm bins
# (Gen2Sensors.py:94-148).
WOM_CAPTURE_EFFICIENCY = np.array([
    0.0, 0.34587, 0.45655, 0.48452, 0.46706, 0.47998, 0.48761, 0.48948,
    0.49017, 0.4905, 0.49127, 0.49325, 0.4966, 0.49651, 0.4857, 0.40011,
    0.15273, 0.00779] + [0.0] * 27)
WOM_RECAPTURE_EFFICIENCY = 0.2403   # KM3NeT PMT QE x shifter emission


def degg_acceptance(active_fraction: float = 1.0,
                    device="cuda") -> TableParams:
    """D-Egg wavelength acceptance (Gen2Sensors.py GetDEggAcceptance):
    center efficiency x 0.9 x (190mm photocathode / 300mm housing)^2."""
    scale = active_fraction * 0.9 * (190.0 / 300.0) ** 2
    return _table(250.0, 10.0, scale * DEGG_CENTER_EFFICIENCY, device)


def degg_angular_sensitivity(pmt: str = "both", coefficients=None,
                             device="cuda") -> torch.Tensor:
    """D-Egg angular sensitivity (Gen2Sensors.py:71-91): the IceCube hole-ice
    polynomial for the down-facing PMT, mirrored in cos(eta) (odd
    coefficients negated) for the up-facing PMT, or the sum for both."""
    down = np.asarray(coefficients if coefficients is not None
                      else HOLE_ICE_H2_50CM["coefficients"], np.float64)
    up = down * np.where(np.arange(down.size) % 2 == 1, -1.0, 1.0)
    pmt = pmt.lower()
    if pmt == "down":
        out = down
    elif pmt == "up":
        out = up
    elif pmt == "both":
        out = down + up
    else:
        raise ValueError(f"unknown PMT orientation {pmt!r}")
    return torch.as_tensor(out.astype(np.float32), device=device)


def wom_acceptance(active_fraction: float = 1.0,
                   device="cuda") -> TableParams:
    """WOM wavelength acceptance (Gen2Sensors.py GetWOMAcceptance)."""
    scale = active_fraction * WOM_RECAPTURE_EFFICIENCY
    return _table(245.0, 10.0, scale * WOM_CAPTURE_EFFICIENCY, device)


# Ice->quartz transmission averaged over the tube cross-section, x sin(eta)
# projected area; valid only for |cos eta| <= 1/1.33, zero outside
# (Gen2Sensors.py:152-170).
WOM_ANGULAR_COEFFICIENTS = np.array([
    0.70161228651625462, 0.0, -0.78196095712541591, 0.0,
    1.9327345553744812, 0.0, -14.801481314906798, 0.0,
    37.180692649664785, 0.0, -34.627444106282297])
WOM_ANGULAR_COS_LIMIT = 1.0 / 1.33


def wom_angular_sensitivity(device="cuda"):
    """(coefficients, cos_limit): evaluate the polynomial where
    |cos eta| <= cos_limit, zero outside (total internal reflection)."""
    return (torch.as_tensor(WOM_ANGULAR_COEFFICIENTS.astype(np.float32),
                            device=device),
            WOM_ANGULAR_COS_LIMIT)


def cos_cherenkov_angular_sensitivity(device="cuda") -> torch.Tensor:
    """The simple no-hole-ice stand-in: the linear ramp (1 + cos) / 2."""
    return torch.tensor([0.5, 0.5], dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Antares / KM3NeT sea-water sensors (the km3 optics constant tables)
# ---------------------------------------------------------------------------

# Hamamatsu BB5912 quantum efficiency (fraction), 300..610 nm in 10 nm bins
# (km3 hit-ini_optic.f via GetAntaresOMAcceptance.py:80-116, listed there
# 610->300 and reversed; physics constant table)
ANTARES_QE_BB5912 = 0.01 * np.array([
    2.526, 7.443, 13.18, 17.68, 20.61, 22.59, 23.48, 22.74, 22.95, 22.95,
    23.34, 23.14, 23.07, 22.65, 22.10, 21.26, 20.22, 18.95, 17.86, 17.11,
    16.37, 15.29, 13.03, 10.13, 8.105, 6.885, 6.004, 5.166, 4.347, 3.496,
    2.714, 1.988])

# glass-sphere absorption length [cm], 300..610 nm
# (GetAntaresOMAcceptance.py:130-175)
ANTARES_GLASS_ABS_CM = np.array([
    0.17, 0.39, 0.84, 1.82, 3.92, 8.41, 18.09, 27.21, 19.23, 61.84,
    128.04, 81.25, 73.02, 77.30, 65.66, 81.63, 109.23, 116.08, 113.90,
    118.86, 126.55, 139.70, 145.68, 150.88, 151.80, 147.16, 142.40,
    138.27, 134.58, 135.64, 142.87, 148.37])

# WACKER gel absorption length [cm], 300..610 nm
# (GetAntaresOMAcceptance.py:183-231)
ANTARES_GEL_ABS_CM = np.array([
    0.00, 8.00, 15.60, 23.08, 30.49, 37.14, 41.88, 45.71, 48.96, 53.29,
    56.64, 59.38, 62.53, 64.48, 66.91, 68.05, 72.31, 74.55, 76.48, 78.18,
    81.08, 84.49, 85.88, 86.95, 90.10, 89.09, 94.36, 96.42, 96.90, 99.89,
    99.94, 100.81])

ANTARES_PMT_COLLECTION_EFF = 0.9      # GetAntaresOMAcceptance.py:61
ANTARES_GLASS_THICKNESS_CM = 1.5
ANTARES_GEL_THICKNESS_CM = 1.0
ANTARES_PMT_DIAMETER_M = 9.3 * 0.0254   # 9.3-inch PMT


def antares_om_acceptance(dom_radius: float = 0.2159,
                          device="cuda") -> TableParams:
    """Antares OM wavelength acceptance: PMT collection efficiency x BB5912
    QE x glass+gel transmission, as effective area over the OM profile
    (GetAntaresOMAcceptance.py:240-291; the table starts with a 0 entry at
    290 nm to share the wavelength range of the other optics curves)."""
    pmt_area = PI * (ANTARES_PMT_DIAMETER_M / 2.0) ** 2
    om_area = PI * dom_radius ** 2
    trans = np.where(
        (ANTARES_GLASS_ABS_CM > 0) & (ANTARES_GEL_ABS_CM > 0),
        np.exp(-ANTARES_GLASS_THICKNESS_CM
               / np.maximum(ANTARES_GLASS_ABS_CM, 1e-9))
        * np.exp(-ANTARES_GEL_THICKNESS_CM
                 / np.maximum(ANTARES_GEL_ABS_CM, 1e-9)), 0.0)
    vals = np.concatenate([
        [0.0],
        pmt_area * ANTARES_PMT_COLLECTION_EFF * ANTARES_QE_BB5912 * trans
        / om_area])
    return _table(290.0, 10.0, vals, device)


# KM3NeT PMT quantum efficiency (WPD document table: 260..650 nm in 10 nm
# bins at peak 0.304; pre-WPD variant: 250..700 nm in 50 nm bins scaled to
# the peak) -- GetKM3NeTDOMAcceptance.py:66-96
KM3NET_QE_WPD = 0.01 * np.array([
    0.0, 0.0, 0.5, 3.1, 9.8, 17.5, 23.2, 26.5, 28.1, 28.1,
    29.1, 30.1, 30.4, 30.1, 29.9, 29.3, 28.6, 27.5, 26.5, 25.0,
    23.2, 21.1, 19.6, 18.5, 17.2, 15.4, 12.1, 9.3, 7.2, 6.2,
    4.6, 3.6, 2.8, 2.1, 1.3, 0.8, 0.5, 0.3, 0.0, 0.0])
KM3NET_QE_SIMPLE = np.array([0.00, 0.87, 1.00, 0.94, 0.78, 0.49,
                             0.24, 0.09, 0.02, 0.00])


def km3net_dom_acceptance(peak_qe: float = None, wpd_qe: bool = False,
                          with_winston_cone: bool = False,
                          device="cuda") -> TableParams:
    """KM3NeT multi-PMT DOM wavelength acceptance for spectrum biasing
    (GetKM3NeTDOMAcceptance.py:200-272): collection efficiency x QE
    (x2 Winston-cone peak correction), glass/gel transmission deliberately
    NOT folded in (the multi-PMT hit converter owns the exact path), and no
    area normalization (the curve is a probability, not an area ratio)."""
    if peak_qe is None:
        peak_qe = 0.304 if wpd_qe else 0.32
    if wpd_qe:
        qx = 260.0 + 10.0 * np.arange(KM3NET_QE_WPD.shape[0])
        qy = KM3NET_QE_WPD * (peak_qe / 0.304)
    else:
        qx = 250.0 + 50.0 * np.arange(KM3NET_QE_SIMPLE.shape[0])
        qy = KM3NET_QE_SIMPLE * peak_qe
    cone = 2.0 if with_winston_cone else 1.0
    wl = np.arange(300.0, 611.0, 10.0)
    vals = np.concatenate([
        [0.0],
        0.9 * np.interp(wl, qx, qy, left=0.0, right=0.0) * cone])
    return _table(290.0, 10.0, vals, device)


class AngularSensitivity:
    """Polynomial angular acceptance in cos(eta) with a hard cutoff below
    `cos_min` (the I3CLSimFunctionPolynomial(range, clip) form used by the
    Antares curves): clip(poly(c), 0, 1) where c >= cos_min, else 0."""

    def __init__(self, coefficients, cos_min: float, device="cuda"):
        self.coefficients = torch.as_tensor(
            np.asarray(coefficients, np.float32), device=device)
        self.cos_min = float(cos_min)

    def __call__(self, cos_eta):
        c = torch.clamp(cos_eta, -1.0, 1.0)
        v = eval_polynomial(self.coefficients.to(c.device), c)
        return torch.where(c >= self.cos_min, torch.clamp(v, 0.0, 1.0),
                           torch.zeros_like(v))


# GetAntaresOMAngularSensitivity.py:36-157 (km3 parameterizations)
ANTARES_ANGULAR_MODELS = {
    "Spring09": ([0.3265, 0.6144, -0.0343, -0.0641, 0.2988, -0.1422], -0.65),
    "Genova": ([0.349, 0.547, 0.063, -0.036, 0.077], -0.80),
    "NIM": ([0.2549, 0.6093, 0.2556, -0.1231], -0.65),
    "old": ([0.153099, 0.627246, 0.41998, -0.322113, 0.218163, -0.166283,
             0.126776, -0.10355, 0.0844767, -0.0720585, 0.0612634,
             -0.0537683, 0.0469892, -0.042072, 0.0374956, -0.0340695,
             0.0308118, -0.0283139, 0.0258992, -0.0240126, 0.0221646,
             -0.0206989, 0.0192477, -0.0180824, 0.0169184, -0.0159738,
             0.0150234, -0.0142452, 0.0134573, -0.0128072, 0.0121454],
            -0.36),
}


def antares_om_angular_sensitivity(name: str = "Spring09",
                                   device="cuda") -> AngularSensitivity:
    """Antares OM angular acceptance parameterizations
    (GetAntaresOMAngularSensitivity.py:36-157)."""
    if name not in ANTARES_ANGULAR_MODELS:
        raise ValueError(f"unknown Antares angular model {name!r}; "
                         f"choose from {sorted(ANTARES_ANGULAR_MODELS)}")
    coeffs, cutoff = ANTARES_ANGULAR_MODELS[name]
    return AngularSensitivity(coeffs, cutoff, device=device)


def angular_factor(angular, cos_eta):
    """Angular acceptance at cos(eta): a plain polynomial coefficient array
    (IceCube hole-ice style, cos clamped to [-1, 1]) or an
    AngularSensitivity with a cutoff (Antares style)."""
    if callable(angular):
        return angular(cos_eta)
    return eval_polynomial(angular, torch.clamp(cos_eta, -1.0, 1.0))
