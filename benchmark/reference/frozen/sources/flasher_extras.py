"""Flasher fidelity extras: measured LED time profile, flasher-board info
conversion, fake info generation, and Standard Candle pulses.

TPU-native equivalents of four reference python modules (host-side source
preparation; the device never sees these -- they only shape the FlasherPulse
stream fed to sources/flasher.FlasherStepGenerator):

* ``flasher_time_profile`` / ``sample_flasher_time`` -- the measured IceCube
  LED pulse-shape distribution (I3CLSimRandomValueIceCubeFlasherTimeProfile
  .py:38-165): a narrow-pulse template measured at FB width setting 15,
  composed into rising-edge / plateau / falling-edge for wider settings,
  sampled by piecewise-linear inverse CDF.
* ``FlasherInfo`` + ``flasher_info_to_pulses`` -- the flasher-board ->
  per-LED pulse conversion (FlasherInfoVectToFlasherPulseSeriesConverter
  .py:34-245): 12-bit LED mask, brightness/width -> photon yield, LED
  positions on the flasher board, tilted vs horizontal beam profiles,
  cDOM color LEDs.
* ``fake_flasher_info`` -- FakeFlasherInfoGenerator.py:30-92.
* ``standard_candle_pulses`` -- StandardCandleFlasherPulseSeriesGenerator
  .py:30-105 (SC1/SC2 positions, 4 ns width, 41.13 deg cone).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geometry import to_numpy
from .particles import FlasherPulse

DEG = np.pi / 180.0

# Measured narrow-pulse template at flasher-board width setting 15
# (relative intensity vs ns; I3CLSimRandomValueIceCubeFlasherTimeProfile.py
# :53-95, zero-offset removed and peak-normalized like the reference's
# (y - 0.00118) / 0.49905).  Physics constant table -- see
# https://wiki.icecube.wisc.edu/index.php/LED_output_time_profile
_NARROW_X = np.arange(51, dtype=np.float64)
_NARROW_Y = (np.array([
    1.18000e-03, 2.76900e-02, 1.25170e-01, 2.14840e-01, 3.20890e-01,
    4.32390e-01, 4.64370e-01, 5.00230e-01, 4.31610e-01, 3.16210e-01,
    2.29650e-01, 1.37640e-01, 8.77400e-02, 7.21400e-02, 5.96600e-02,
    4.79700e-02, 4.09500e-02, 2.92500e-02, 3.08100e-02, 2.84700e-02,
    2.61300e-02, 1.83400e-02, 1.83400e-02, 1.99000e-02, 1.28800e-02,
    1.28800e-02, 1.28800e-02, 1.60000e-02, 1.44400e-02, 1.67800e-02,
    7.42000e-03, 6.64000e-03, 9.76000e-03, 1.13200e-02, 7.42000e-03,
    9.76000e-03, 4.30000e-03, 5.86000e-03, 7.42000e-03, 4.30000e-03,
    8.20000e-03, 5.86000e-03, 3.52000e-03, 1.96000e-03, 2.74000e-03,
    4.30000e-03, 5.08000e-03, 2.74000e-03, 3.52000e-03, 4.30000e-03,
    2.74000e-03]) - 0.00118) / 0.49905


def _pulse_narrow(x):
    """Linear interpolation of the measured narrow template, 0 outside."""
    return np.interp(x, _NARROW_X, _NARROW_Y, left=0.0, right=0.0)


def flasher_time_profile(width_ns: float,
                         max_duration_ns: float = 120.0,
                         dt_ns: float = 0.5):
    """Density grid (x, y) of the LED light output vs time for a flasher
    width setting of `width_ns` (= board setting / 2 in ns).

    Reimplements `_the_pulse` (…FlasherTimeProfile.py:110-133): the board
    width in FB units is 2x the ns width; settings <= 15 scale the narrow
    template, wider settings compose a stretched rising edge, a plateau of
    width (W-15)*59.5/109 and the template's falling edge."""
    fb_width = 2.0 * float(width_ns)
    x = np.arange(0.0, max_duration_ns, dt_ns)
    if fb_width <= 0:
        raise ValueError("flasher width must be positive")
    if fb_width <= 15.0:
        y = _pulse_narrow(x * (15.0 / fb_width))
    else:
        plateau = (fb_width - 15.0) * 59.5 / (124.0 - 15.0)
        rising = math.log(fb_width - 12.0) * 1.91 + 5.0
        template_w = 7.0
        # rising edge: first 7 ns of the template stretched to `rising`
        y_rise = _pulse_narrow(np.clip(template_w * x / rising,
                                       0.0, template_w))
        # falling edge: template from 7 ns onward
        xf = x - rising - plateau
        y_fall = _pulse_narrow(np.maximum(xf + template_w, template_w))
        y = np.where(x <= rising, y_rise,
                     np.where(x <= rising + plateau, 1.0, y_fall))
    return x, y


def sample_piecewise_linear(x, y, u):
    """Inverse-CDF sampling of a piecewise-linear density (the numpy twin of
    ops/samplers.sample_interpolated_dist /
    I3CLSimRandomValueInterpolatedDistribution.cxx:84-135)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    seg = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    if total <= 0:
        raise ValueError("density integrates to zero")
    cdf /= total
    u = np.asarray(u, np.float64)
    k = np.clip(np.searchsorted(cdf, u, side="right") - 1, 0, len(seg) - 1)
    x0, x1 = x[k], x[k + 1]
    b0, b1 = y[k] / total, y[k + 1] / total
    dy = u - cdf[k]
    slope = (b1 - b0) / (x1 - x0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r_full = x0 + (np.sqrt(np.maximum(
            dy * 2.0 * slope / np.where(b0 == 0, 1.0, b0) ** 2 + 1.0, 0.0))
            - 1.0) * np.where(slope == 0, 1.0, b0 / np.where(
                slope == 0, 1.0, slope))
        r_bz = x0 + np.sqrt(np.maximum(
            2.0 * dy / np.where(slope == 0, 1.0, slope), 0.0))
        r_sz = x0 + dy / np.where(b0 == 0, 1.0, b0)
    s_zero = np.abs(slope) < 1e-20
    b_zero = np.abs(b0) < 1e-20
    return np.where(b_zero & s_zero, x0,
                    np.where(b_zero, r_bz, np.where(s_zero, r_sz, r_full)))


def sample_flasher_time(width_ns: float, rng: np.random.Generator,
                        n: int) -> np.ndarray:
    """n samples [ns] from the measured LED time profile for this width."""
    x, y = flasher_time_profile(width_ns)
    return sample_piecewise_linear(x, y, rng.random(n))


# ---------------------------------------------------------------------------
# flasher-board info -> per-LED pulses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlasherInfo:
    """Flasher-board configuration for one flashing DOM (the I3FlasherInfo
    POD; FakeFlasherInfoGenerator.py:38-92)."""
    string_id: int
    om_id: int
    flash_time: float = 0.0        # ns
    mask: int = 0b111111000000     # 12-bit LED mask (default: 6 horizontal)
    led_brightness: int = 127      # 0-127
    width: int = 127               # 0-127 board setting (0.5 ns units)
    rate: float = 0.0


def fake_flasher_info(string_id: int, om_id: int, flash_time: float = 0.0,
                      mask: int = 0b111111000000, brightness: int = 127,
                      width: int = 127) -> FlasherInfo:
    """FakeFlasherInfoGenerator equivalent (same defaults: the 6 horizontal
    LEDs, full brightness/width)."""
    return FlasherInfo(string_id=string_id, om_id=om_id,
                       flash_time=flash_time, mask=mask,
                       led_brightness=brightness, width=width)


def flasher_num_photons(brightness: int, width: int,
                        photons_at_max_brightness: float = 1.17e10) -> float:
    """Photon yield for a brightness/width setting
    (FlasherInfoVectToFlasherPulseSeriesConverter.py:121-124; the 1.17e10
    max-brightness normalization comes from SPICE-Lea fits)."""
    b = float(brightness)
    w = float(width)
    return photons_at_max_brightness * (0.0006753 + 0.00005593 * b) \
        * (w + 13.9 - (57.5 / (1.0 + b / 34.4)))


# cDOM flashing DOMs (IceCube-86 color DOMs; converter :44-60) and their
# per-LED colors (:62-75).  Standard DOMs flash 405 nm LEDs.
COLOR_DOMS = {(79, 1), (79, 8), (79, 13), (79, 22), (79, 32), (79, 41),
              (79, 53), (79, 60), (14, 3), (14, 8), (14, 14), (14, 21),
              (14, 28), (14, 41), (14, 51), (14, 58)}
CDOM_LED_WLEN = [505, 450, 505, 450, 505, 450,   # LEDs 1-6: narrow beams
                 340, 370, 340, 370, 340, 370]   # LEDs 7-12: wide beams

# Gaussian beam widths (polar, azimuthal) [rad] by (LED wavelength, tilted)
# (converter :78-92; measured in air, converted to ice for 405 nm)
LED_ANGULAR_PROFILE = {
    (405, True): (9.7 * DEG, 9.8 * DEG),
    (405, False): (9.2 * DEG, 10.1 * DEG),
    (340, False): (36.1 * DEG, 39.6 * DEG),
    (370, False): (39.1 * DEG, 42.9 * DEG),
    (450, False): (4.8 * DEG, 5.3 * DEG),
    (505, False): (4.5 * DEG, 4.9 * DEG),
}

_FLASHER_RADIUS_M = 0.119    # LED radial position on the board (:161)
_FLASHER_Z_M = 0.08          # LED height above DOM center (:162)


def flasher_info_to_pulses(
        info: FlasherInfo, geometry,
        spectrum_index_by_wlen: Optional[Dict[int, int]] = None,
        photons_at_max_brightness: float = 1.17e10) -> List[FlasherPulse]:
    """Expand one board configuration into per-LED FlasherPulses
    (FlasherInfoVectToFlasherPulseSeriesConverter.py:126-245, the old-style
    global-frame branch: DOM axis pointing down, azimuth rotation
    -60 deg * (led % 6), LEDs 0-5 tilted 48 deg up on standard DOMs).

    `spectrum_index_by_wlen` maps the LED nominal wavelength (405/340/370/
    450/505 nm) to the stacked-spectrum index configured on the Simulation;
    default {405: 1}.  The geometry's tensors may lie on any device."""
    if spectrum_index_by_wlen is None:
        spectrum_index_by_wlen = {405: 1}
    sid = to_numpy(geometry.dom_string_id)
    oid = to_numpy(geometry.dom_om_id)
    sel = np.nonzero((sid == info.string_id) & (oid == info.om_id))[0]
    if sel.size != 1:
        raise ValueError(f"flashing DOM ({info.string_id},{info.om_id}) "
                         "not found in geometry")
    d = int(sel[0])
    dom_x = float(to_numpy(geometry.dom_x)[d])
    dom_y = float(to_numpy(geometry.dom_y)[d])
    dom_z = float(to_numpy(geometry.dom_z)[d])

    is_cdom = (info.string_id, info.om_id) in COLOR_DOMS
    n_photons = flasher_num_photons(info.led_brightness, info.width,
                                    photons_at_max_brightness)
    pulses = []
    for i in range(12):
        if not (info.mask & (1 << i)):
            continue
        tilted = (not is_cdom) and i < 6
        wlen = CDOM_LED_WLEN[i] if is_cdom else 405
        pos_index = i % 6
        azi = -60.0 * DEG * pos_index
        tilt = 48.0 * DEG if tilted else 0.0
        # direction: theta = 90deg - tilt in the global frame
        theta = 0.5 * np.pi - tilt
        dx = math.sin(theta) * math.cos(azi)
        dy = math.sin(theta) * math.sin(azi)
        dz = math.cos(theta)
        px = dom_x + math.cos(azi) * _FLASHER_RADIUS_M
        py = dom_y + math.sin(azi) * _FLASHER_RADIUS_M
        pz = dom_z + _FLASHER_Z_M
        sig_pol, sig_azi = LED_ANGULAR_PROFILE[(wlen, tilted)]
        if wlen not in spectrum_index_by_wlen:
            raise ValueError(
                f"no spectrum configured for the {wlen} nm LED; pass "
                "spectrum_index_by_wlen (stack the matching led_spectrum "
                "on the Simulation)")
        pulses.append(FlasherPulse(
            x=px, y=py, z=pz, time=info.flash_time,
            dir_x=dx, dir_y=dy, dir_z=dz,
            num_photons_no_bias=n_photons,
            angular_smear_polar=sig_pol,
            angular_smear_azimuthal=sig_azi,
            pulse_width=float(info.width) / 2.0,   # FWHM [ns] (:228)
            spectrum_index=spectrum_index_by_wlen[wlen]))
    return pulses


# ---------------------------------------------------------------------------
# Standard Candles
# ---------------------------------------------------------------------------

def standard_candle_pulses(candle_number: int = 1,
                           photons_per_pulse: float = 2.5e13,
                           flash_time: float = 0.0,
                           spectrum_index: int = 1) -> List[FlasherPulse]:
    """IceCube Standard Candle I/II pulse
    (StandardCandleFlasherPulseSeriesGenerator.py:67-105): fixed positions,
    4 ns width, cone emission at 41.13 deg polar angle with uniform
    azimuth -- emission_mode='cone' tells the step generator to interpret
    the angular parameters in polar coordinates (the
    interpretAngularDistributionsInPolarCoordinates branch of
    I3CLSimLightSourceToStepConverterFlasher.cxx:479-520)."""
    if candle_number == 1:
        pos = (544.07, 55.89, 136.86)
        direction = (0.0, 0.0, 1.0)      # facing up
    elif candle_number == 2:
        pos = (11.87, 179.19, -205.64)
        direction = (0.0, 0.0, -1.0)     # facing down
    else:
        raise ValueError("candle_number must be 1 or 2")
    return [FlasherPulse(
        x=pos[0], y=pos[1], z=pos[2], time=flash_time,
        dir_x=direction[0], dir_y=direction[1], dir_z=direction[2],
        num_photons_no_bias=photons_per_pulse,
        angular_smear_polar=41.13 * DEG,
        angular_smear_azimuthal=2.0 * np.pi,
        pulse_width=4.0,
        spectrum_index=spectrum_index,
        emission_mode="cone")]
