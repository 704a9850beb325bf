"""LED flasher pulses -> steps.

Equivalent of I3CLSimLightSourceToStepConverterFlasher
(private/clsim/I3CLSimLightSourceToStepConverterFlasher.cxx):

  * numPhotons ~ Poisson( NoBias * correctionFactor ), Gaussian above 1e6,
    where correctionFactor = integral(bias * spectrum) / integral(spectrum)
    (PhotonNumberCorrectionFactorAfterBias,
     I3CLSimLightSourceToStepConverterUtils.cxx:118+)
  * steps of photons_per_step (default 400, Flasher.cxx:46); per *step*:
    direction smeared by Gaussian polar/azimuthal widths (:440-478, standard
    non-polar interpretation: azimuth offset in the horizontal plane, then
    polar rotation), emission time smeared by the pulse time profile
  * step.source_type = the pulse's spectrum-table index (>= 1), dispatching
    the device-side wavelength sampler (propagation_kernel.c.cl:174-182)

LED emission spectra: the measured/datasheet tables for all five LEDs are
BUNDLED (sources/flasher_data.py, the same tables the reference loads via
GetIceCubeFlasherSpectrum.py:38-60) and are the default; clsim-style
flasher_data text files can be loaded instead, and Gaussian stand-ins
remain available via `gaussian_approx=True` (the 340/370 nm LEDs are
visibly non-Gaussian, so the stand-ins are for sensitivity studies only).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from ..ops.spectrum import WavelengthSpectrum, make_tabulated_spectrum
from ..types import StepBatch
from .particles import FlasherPulse

DEFAULT_PHOTONS_PER_STEP = 400

# nominal center / sigma [nm] Gaussian stand-ins for the measured LED spectra
LED_GAUSSIAN_APPROX = {
    340: (340.0, 6.5),
    370: (370.0, 8.0),
    405: (405.0, 10.0),
    450: (450.0, 11.0),
    505: (505.0, 15.0),
}


def led_spectrum(nominal_wlen_nm: int,
                 bias_wlen_nm=None, bias_values=None,
                 flasher_data_dir: Optional[str] = None,
                 gaussian_approx: bool = False) -> WavelengthSpectrum:
    """Build the (bias-weighted) sampling spectrum for one LED.

    Default: the BUNDLED measured/datasheet emission table for the LED
    (sources/flasher_data.py -- the tables the reference loads from
    resources/flasher_data, GetIceCubeFlasherSpectrum.py:38-60).  If
    `flasher_data_dir` is given, clsim measured-spectrum text files
    (two columns: wavelength [nm or m], relative intensity) are loaded
    from there instead.  `gaussian_approx=True` selects the legacy
    Gaussian stand-in (sensitivity studies only: the 340/370 nm LEDs are
    non-Gaussian)."""
    table = None
    if flasher_data_dir is not None:
        candidates = [f for f in os.listdir(flasher_data_dir)
                      if f.startswith(f"flasher_led_{nominal_wlen_nm}nm")]
        if candidates:
            data = np.loadtxt(os.path.join(flasher_data_dir, sorted(candidates)[0]),
                              unpack=True)
            wl = data[0] * 1e9 if data[0].max() < 1e-3 else data[0]
            table = (wl, data[1])
    if table is None and not gaussian_approx:
        from .flasher_data import LED_SPECTRA
        meas = LED_SPECTRA.get(int(nominal_wlen_nm))
        if meas is not None:
            table = (meas[:, 0], meas[:, 1])
    if table is None:
        center, sigma = LED_GAUSSIAN_APPROX[int(nominal_wlen_nm)]
        wl = np.linspace(center - 5 * sigma, center + 5 * sigma, 101)
        table = (wl, np.exp(-0.5 * ((wl - center) / sigma) ** 2))
    return make_tabulated_spectrum(table[0], table[1],
                                   bias_wlen_nm=bias_wlen_nm,
                                   bias_values=bias_values)


def bias_correction_factor(spectrum_wlen, spectrum_density,
                           bias_wlen, bias_values) -> float:
    """integral(bias * spectrum) / integral(spectrum)."""
    if bias_values is None:
        return 1.0
    b = np.interp(spectrum_wlen, bias_wlen, bias_values)
    num = np.trapezoid(b * spectrum_density, spectrum_wlen)
    den = np.trapezoid(spectrum_density, spectrum_wlen)
    return float(num / den)


def bias_flasher_spectrum(spectrum: WavelengthSpectrum, bias_wlen_nm,
                          bias_values):
    """(the LED spectrum sampled with the generation bias, its photon-number
    correction factor): the emission density is the spectrum's sampling
    density with any bias it already carries divided out, re-weighted by
    `bias_values`; the factor is integral(bias * density) /
    integral(density) (I3CLSimLightSourceToStepConverterFlasher.cxx:232-253).
    Without a bias the spectrum is returned as it is, with factor 1."""
    if bias_values is None:
        return spectrum, 1.0
    density = np.asarray(spectrum.beta, np.float64) / np.interp(
        spectrum.x, spectrum.bias_x, spectrum.bias_y)
    return (make_tabulated_spectrum(spectrum.x, density,
                                    bias_wlen_nm=bias_wlen_nm,
                                    bias_values=bias_values),
            bias_correction_factor(spectrum.x, density, bias_wlen_nm,
                                   bias_values))


class FlasherStepGenerator:
    """FlasherPulse -> StepBatch converter."""

    def __init__(self, cherenkov_spectrum: WavelengthSpectrum,
                 photons_per_step: int = DEFAULT_PHOTONS_PER_STEP,
                 correction_factors: Optional[dict] = None):
        # bias curve shared with the Cherenkov spectrum (the DOM acceptance)
        self.bias_x = np.asarray(cherenkov_spectrum.bias_x)
        self.bias_y = np.asarray(cherenkov_spectrum.bias_y)
        self.photons_per_step = photons_per_step
        # spectrum-index -> precomputed bias correction factor
        self.correction_factors = correction_factors or {}

    def correction_for(self, pulse: FlasherPulse) -> float:
        if pulse.spectrum_index in self.correction_factors:
            return self.correction_factors[pulse.spectrum_index]
        return 1.0

    def convert(self, pulse: FlasherPulse, identifier: int,
                rng: np.random.Generator) -> List[StepBatch]:
        mean = pulse.num_photons_no_bias * self.correction_for(pulse)
        if mean <= 0:
            return []
        if mean > 1e6:
            num = -1
            while num < 0:
                num = int(rng.normal(mean, math.sqrt(mean)))
        else:
            num = int(rng.poisson(mean))
        if num == 0:
            return []

        pps = self.photons_per_step
        n_full, rest = divmod(num, pps)
        counts = np.full(n_full + (1 if rest else 0), pps, np.int64)
        if rest:
            counts[-1] = rest
        n = len(counts)

        if pulse.emission_mode == "cone":
            # Standard Candle mode (polar interpretation, I3CLSimLightSource
            # ToStepConverterFlasher.cxx:479-520 with the SC distributions of
            # GetFlasherParameterizationList.py:60-66): rotate EXACTLY
            # `angular_smear_polar` away from the axis, azimuth uniform in
            # [0, angular_smear_azimuthal); time delay N(2 ns, width)
            from .ppc import _rotate_by_angle
            cosa = np.full(n, math.cos(pulse.angular_smear_polar))
            sina = np.full(n, math.sin(pulse.angular_smear_polar))
            u_azi = rng.random(n) * (pulse.angular_smear_azimuthal
                                     / (2.0 * np.pi))
            dx, dy, dz = _rotate_by_angle(
                cosa, sina, np.full(n, pulse.dir_x),
                np.full(n, pulse.dir_y), np.full(n, pulse.dir_z), u_azi)
            t = np.full(n, pulse.time)
            if pulse.pulse_width > 0:
                t = t + rng.normal(2.0, pulse.pulse_width, n)
        else:
            # LED mode: direction smearing (non-polar interpretation,
            # Flasher.cxx:460-478): start from the pulse direction's
            # (theta, phi), add the azimuthal offset in the horizontal
            # plane, then rotate by the polar offset
            theta0 = math.acos(max(-1.0, min(1.0, pulse.dir_z)))
            phi0 = math.atan2(pulse.dir_y, pulse.dir_x)
            d_azi = (rng.normal(0.0, 1.0, n) * pulse.angular_smear_azimuthal
                     if pulse.angular_smear_azimuthal > 0 else np.zeros(n))
            d_pol = (rng.normal(0.0, 1.0, n) * pulse.angular_smear_polar
                     if pulse.angular_smear_polar > 0 else np.zeros(n))
            phi = phi0 + d_azi
            theta = theta0 + d_pol
            dx = np.sin(theta) * np.cos(phi)
            dy = np.sin(theta) * np.sin(phi)
            dz = np.cos(theta)

            t = np.full(n, pulse.time)
            if pulse.pulse_width > 0:
                # measured LED output time profile (replaces the round-1
                # |N(0, w)| placeholder; I3CLSimRandomValueIceCubeFlasher
                # TimeProfile.py:138-165 semantics)
                from .flasher_extras import sample_flasher_time
                t = t + sample_flasher_time(pulse.pulse_width, rng, n)

        return [StepBatch(
            x=np.full(n, pulse.x, np.float32),
            y=np.full(n, pulse.y, np.float32),
            z=np.full(n, pulse.z, np.float32),
            t=t.astype(np.float32),
            dir_x=dx.astype(np.float32), dir_y=dy.astype(np.float32),
            dir_z=dz.astype(np.float32),
            length=np.zeros(n, np.float32),
            beta=np.ones(n, np.float32),
            num_photons=counts.astype(np.int32),
            weight=np.ones(n, np.float32),
            identifier=np.full(n, identifier, np.int32),
            source_type=np.full(n, pulse.spectrum_index, np.int32))]


def get_flasher_spectrum(nominal_wlen_nm: int, **kw) -> WavelengthSpectrum:
    """Convenience alias (GetIceCubeFlasherSpectrum equivalent)."""
    return led_spectrum(nominal_wlen_nm, **kw)
