"""Antares / KM3NeT sea-water medium (PyTorch counterpart of
clsim_tpu.medium.antares, the reference's MakeAntaresMediumProperties,
python/MakeAntaresMediumProperties.py): a single water layer with

  * tabulated absorption lengths (Smith&Baker + Antares site measurements,
    290nm..610nm in 10nm steps),
  * Kopelevich particulate + pure-water scattering
    (I3CLSimFunctionScatLenPartic, small/large volume conc. 0.0075 ppm),
  * Quan&Fry phase refractive index (salinity 38.44 psu, 13.1 C, 215.8 bar),
  * scattering angles from a 17% Rayleigh / 83% tabulated-Petzold mixture.

The tables are this module's own copy of the reference's constants.  The
propagation code consumes the medium through the separable (gs, pa/qa/ra)
interface; water puts the whole wavelength dependence into per-lambda
tables with unit per-layer coefficients (medium/properties.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import functions as F
from .anisotropy import AnisotropyParams
from .properties import MediumProperties, ScatteringAngleDist
from .tilt import disabled_tilt

# Antares absorption lengths [m] from 290nm in 10nm steps
# (MakeAntaresMediumProperties.py:119-127; Smith&Baker + site measurements)
ANTARES_ABS_LEN = np.array([
    4.65116279, 7.1942446, 9.17431193, 10.57082452, 12.62626263, 14.08450704,
    15.89825119, 18.93939394, 21.14164905, 24.09638554, 27.54820937,
    30.76923077, 34.36426117, 39.21568627, 42.19409283, 45.87155963, 50.0,
    52.35602094, 54.94505495, 54.94505495, 51.02040816, 38.91050584,
    28.01120448, 20.96436059, 19.72386588, 17.92114695, 15.67398119,
    14.12429379, 12.51564456, 9.25925926, 6.36942675, 4.09836066,
    3.46020761])
ANTARES_ABS_FIRST_WLEN = 290.0
ANTARES_ABS_STEP = 10.0

# Petzold average-particle volume scattering function: angles [deg] and
# relative values (MakeAntaresMediumProperties.py:45-76); the sampled density
# is 2*pi*sin(theta)*value with a power-law extension below the first bin
PETZOLD_ANG_DEG = np.array([
    1e-9 * 180.0 / math.pi,
    0.100, 0.126, 0.158, 0.200, 0.251, 0.316, 0.398, 0.501, 0.631, 0.794,
    1.000, 1.259, 1.585, 1.995, 2.512, 3.162, 3.981, 5.012, 6.310, 7.943,
    10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0,
    60.0, 65.0, 70.0, 75.0, 80.0, 85.0, 90.0, 95.0, 100.0, 105.0,
    110.0, 115.0, 120.0, 125.0, 130.0, 135.0, 140.0, 145.0, 150.0, 155.0,
    160.0, 165.0, 170.0, 175.0, 180.0])
PETZOLD_VAL = np.array([
    0.0,
    1.767e+03, 1.296e+03, 9.502e+02, 6.991e+02, 5.140e+02,
    3.764e+02, 2.763e+02, 2.188e+02, 1.444e+02, 1.022e+02,
    7.161e+01, 4.958e+01, 3.395e+01, 2.281e+01, 1.516e+01,
    1.002e+01, 6.580e+00, 4.295e+00, 2.807e+00, 1.819e+00,
    1.153e+00, 4.893e-01, 2.444e-01, 1.472e-01, 8.609e-02,
    5.931e-02, 4.210e-02, 3.067e-02, 2.275e-02, 1.699e-02,
    1.313e-02, 1.046e-02, 8.488e-03, 6.976e-03, 5.842e-03,
    4.953e-03, 4.292e-03, 3.782e-03, 3.404e-03, 3.116e-03,
    2.912e-03, 2.797e-03, 2.686e-03, 2.571e-03, 2.476e-03,
    2.377e-03, 2.329e-03, 2.313e-03, 2.365e-03, 2.506e-03,
    2.662e-03, 2.835e-03, 3.031e-03, 3.092e-03, 3.154e-03])
PETZOLD_POWER_LAW_INDEX = -1.346
RAYLEIGH_FRACTION = 0.17  # fraction of the Rayleigh component in the mix


def petzold_angle_tables():
    """(angles[rad], cdf, density) float32 numpy sampling tables of the
    Petzold phase function over the scattering *angle* (the reference
    samples the angle from an InterpolatedDistribution and applies cos)."""
    ang = PETZOLD_ANG_DEG * math.pi / 180.0
    val = PETZOLD_VAL.copy()
    val[0] = (2.0 * math.pi * math.sin(ang[1]) * val[1]
              * (ang[0] / ang[1]) ** PETZOLD_POWER_LAW_INDEX)
    dens = 2.0 * math.pi * val * np.sin(ang)
    dens[0] = 2.0 * math.pi * val[0] * math.sin(ang[0]) if ang[0] > 0 else 0.0
    # trapezoid CDF like the reference sampler
    widths = np.diff(ang)
    segs = widths * (dens[1:] + dens[:-1]) / 2.0
    acu = np.concatenate([[0.0], np.cumsum(segs)])
    total = acu[-1]
    return (ang.astype(np.float32), (acu / total).astype(np.float32),
            (dens / total).astype(np.float32))


def make_antares_water(salinity: float = 38.44,
                       temperature: float = 13.1,
                       pressure_atm: float = 215.82225 / 1.01325,
                       vol_conc_small_ppm: float = 0.0075,
                       vol_conc_large_ppm: float = 0.0075,
                       device="cuda") -> MediumProperties:
    """The Antares site's sea water (MakeAntaresMediumProperties.py)."""
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)

    wl = ANTARES_ABS_FIRST_WLEN + ANTARES_ABS_STEP * np.arange(
        len(ANTARES_ABS_LEN))
    abs_inv = (1.0 / ANTARES_ABS_LEN).astype(np.float32)
    scat_inv = F.scattering_inv_length_partic(
        F.ScatLenParticParams(vol_conc_small=vol_conc_small_ppm,
                              vol_conc_large=vol_conc_large_ppm),
        wl).numpy()

    qf = F.QuanFryParams(salinity=salinity, temperature=temperature,
                         pressure=pressure_atm)
    # fit the propagation's quartic phase/group representation on the
    # Quan&Fry curves over the usable range (float32 curves, as the JAX
    # package evaluates them; the fit is accurate to <2e-4 in n)
    wl_fit = np.linspace(290.0, 610.0, 200)
    x_um = wl_fit * 1e-3
    npz = F.phase_ref_index_quan_fry(qf, wl_fit).numpy().astype(np.float64)
    ngz = F.group_ref_index_quan_fry(qf, wl_fit).numpy().astype(np.float64)
    ncoef = np.polyfit(x_um, npz, 4)[::-1]
    gcoef = np.polyfit(x_um, ngz / npz, 4)[::-1]

    ang, acu, dens = petzold_angle_tables()
    return MediumProperties(
        layers_z_start=t(-310.0),
        layer_height=t(2500.0),
        n_layers=1,
        alpha=t(0.0), kappa=t(0.0),
        abs_A=t(0.0), abs_B=t(0.0), abs_D=t(0.0), abs_E=t(0.0),
        b400=t([1.0]), a_dust400=t([1.0]), delta_tau=t([0.0]),
        ref_index=F.RefIndexParams(n=t(ncoef), g=t(gcoef)),
        scattering=ScatteringAngleDist(
            mean_cos=t(0.0), liu_fraction=t(RAYLEIGH_FRACTION), kind="water",
            table_cos=t(ang),                       # angle support
            table_cdf=t(np.stack([acu, dens]))),    # (2, n): cdf + density
        anisotropy=AnisotropyParams(azimuth=t(0.0), mag_along=t(0.0),
                                    mag_perp=t(0.0), enabled=False),
        tilt=disabled_tilt(device),
        density=t(1.039),
        efficiency=t(1.0),
        min_wlen=290.0, max_wlen=610.0,
        medium_kind="water",
        water_wlen_first=float(wl[0]),
        water_wlen_step=float(ANTARES_ABS_STEP),
        water_scat_inv=t(scat_inv),
        water_abs_inv=t(abs_inv),
    )
