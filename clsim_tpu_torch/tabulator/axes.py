"""Tabulator binning axes.

PyTorch counterpart of clsim_tpu.tabulator.axes, the equivalent of the
reference's clsim::tabulator::Axis/Axes (private/clsim/tabulator/Axis.{h,cxx},
Axes.{h,cxx}): each axis maps a coordinate to a bin via an invertible
transform (linear or power-law spacing); every axis carries an under- and an
overflow bin; the composed bin index uses row-major strides.  Index
semantics replicate GetIndexCode (Axis.cxx:46-59): clamp(floor(scale *
invtransform(v) - offset), -1, n) + 1, evaluated in float32 as the JAX
package evaluates it, so both give the same integers.

`bin_index`, `flat_index` and `out_of_bounds` take torch tensors (on any
device); `bin_edges` and `bin_volumes` are float64 numpy.

Both axes families accept 4 or 5 axes; the optional 5th is the
receiver-impact-angle cosine (TABULATE_IMPACT_ANGLE,
spherical_coordinates.c.cl:27-31, 64-75): when present, the tabulator
replaces the angular-acceptance weight with an explicit impact-angle
dimension (propagation_kernel.c.cl:245-250).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


_TINY = float(np.finfo(np.float32).tiny)


def _flush(x):
    """float32 subnormals -> 0."""
    return torch.where(torch.abs(x) < _TINY, 0.0, x)


@dataclasses.dataclass(frozen=True)
class Axis:
    """Axis with n_bins regular bins in transformed space plus under/overflow."""
    min: float
    max: float
    n_bins: int
    power: int = 1  # 1 = linear; p > 1 = edges clustered toward min

    def inverse_transform(self, v):
        """non-linear -> linear space (PowerAxis: (v-min)^(1/p))."""
        if self.power == 1:
            return v
        return torch.sign(v - self.min) * torch.abs(v - self.min) ** (
            1.0 / self.power)

    def _inv_np(self, v):
        if self.power == 1:
            return np.asarray(v, np.float64)
        return np.sign(v - self.min) * np.abs(
            np.asarray(v, np.float64) - self.min) ** (1.0 / self.power)

    def index_constants(self):
        """(scale, offset) of bin_index: the bin of v is floor(scale *
        inverse_transform(v) - offset), both applied in float32."""
        scale = float(self.n_bins / (self._inv_np(self.max)
                                     - self._inv_np(self.min)))
        return scale, float(scale * self._inv_np(self.min))

    def bin_index(self, v):
        """Bin index incl. overflow handling: 0=underflow, 1..n, n+1=overflow
        (int64).  Subnormal floats count as zero, as XLA's CPU backend
        flushes them (a coordinate of -1e-45 lands in the first bin, not
        the underflow), and the float is clamped before the integer
        conversion, which gives the JAX package's saturating conversion."""
        scale, offset = self.index_constants()
        x = _flush(scale * self.inverse_transform(_flush(v)))
        raw = torch.floor(x - offset)
        return torch.clamp(raw, -1.0, float(self.n_bins)).to(torch.int64) + 1

    def bin_edges(self) -> np.ndarray:
        imin, imax = self._inv_np(self.min), self._inv_np(self.max)
        lin = np.linspace(imin, imax, self.n_bins + 1)
        if self.power == 1:
            return lin
        return self.min + lin ** self.power

    @property
    def n_total(self):
        return self.n_bins + 2


class _AxesBase:
    """Shared N-dim plumbing: row-major strides over (n_bins+2)-sized dims,
    flat indexing (Axes.cxx GetBinIndexFunction)."""

    n_min = 4
    n_max = 5

    def __init__(self, axes: Sequence[Axis]):
        if not (self.n_min <= len(axes) <= self.n_max):
            raise ValueError(
                f"{type(self).__name__} needs {self.n_min}"
                f"{'' if self.n_min == self.n_max else f'..{self.n_max}'} axes"
                f" (got {len(axes)})")
        self.axes = list(axes)
        self.shape = tuple(a.n_total for a in self.axes)
        nd = len(self.axes)
        strides = [0] * nd
        strides[nd - 1] = 1
        for i in range(nd - 2, -1, -1):
            strides[i] = strides[i + 1] * self.shape[i + 1]
        self.strides = tuple(strides)
        self.n_bins = self.strides[0] * self.shape[0]

    @property
    def n_dim(self) -> int:
        return len(self.axes)

    @property
    def impact_angle(self) -> bool:
        """True when the optional 5th (receiver impact cosine) axis exists."""
        return len(self.axes) > 4

    def flat_index(self, coords):
        """Row-major flat bin index (int64) of the coordinate tensors."""
        idx = 0
        for a, s, c in zip(self.axes, self.strides, coords):
            idx = idx + s * a.bin_index(c)
        return idx


class SphericalAxes(_AxesBase):
    """(r, azimuth[deg, folded to 0..180], cos(polar), residual time
    [, impact cosine]) axes -- the standard photon-table binning
    (Axes.cxx SphericalAxes)."""

    kind = "spherical"

    def out_of_bounds(self, coords):
        """Photons beyond the radius or time range stop contributing
        (Axes.cxx GetBoundsCheckFunction: r > r_max or t > t_max)."""
        return (coords[0] > self.axes[0].max) | (coords[3] > self.axes[3].max)

    def bin_volumes(self) -> np.ndarray:
        """Spatial bin volume per (r, az, cosz) cell; azimuthal bins count
        double when the table folds at 180 deg (Axes.cxx:122-134)."""
        r_edges = self.axes[0].bin_edges()
        az_edges = self.axes[1].bin_edges()
        ct_edges = self.axes[2].bin_edges()
        scale = 1.0 if self.axes[1].max > 180.0 else 2.0
        vr = np.diff(r_edges ** 3) / 3.0
        vaz = scale * np.deg2rad(np.diff(az_edges))
        vct = np.diff(ct_edges)
        return vr[:, None, None] * vaz[None, :, None] * vct[None, None, :]


def default_impact_axis(n_bins: int = 20) -> Axis:
    """Receiver impact-angle cosine axis (I3CLSimStepToTableConverter
    preamble, .cxx:187-188; the tablemaker's default is linear in cos)."""
    return Axis(-1.0, 1.0, n_bins, power=1)


def default_spherical_axes(r_max: float = 580.0, t_max: float = 7000.0,
                           n_impact: int = 0) -> SphericalAxes:
    """The standard photon-table binning used by the reference's tabulator
    segment (python/tablemaker/tabulator.py): power-2 radius, linear azimuth
    and cos(zenith), power-2 time.  n_impact > 0 appends the optional
    impact-angle cosine axis (TABULATE_IMPACT_ANGLE)."""
    axes = [
        Axis(0.0, r_max, 200, power=2),
        Axis(0.0, 180.0, 36, power=1),
        Axis(-1.0, 1.0, 100, power=1),
        Axis(0.0, t_max, 105, power=2),
    ]
    if n_impact:
        axes.append(default_impact_axis(n_impact))
    return SphericalAxes(axes)


class CylindricalAxes(_AxesBase):
    """(rho, azimuth[rad, folded to 0..pi], z of closest approach, residual
    time[, impact cosine]) axes -- the infinite-muon table binning (Axes.cxx
    CylindricalAxes, cylindrical_coordinates.c.cl).  The time residual is
    relative to the geometric Cherenkov cone: t - (l + rho*tan(theta_c))/c."""

    kind = "cylindrical"

    def out_of_bounds(self, coords):
        """Only the time bound terminates photons for cylindrical tables
        (Axes.cxx GetBoundsCheckFunction, CylindricalAxes variant)."""
        return coords[3] > self.axes[3].max

    def bin_volumes(self) -> np.ndarray:
        """(rho1^2-rho0^2)/2 * 2*dphi * dz per (rho, az, z) cell; the factor
        2 accounts for the azimuthal fold at pi (Axes.cxx:155-166)."""
        rho_edges = self.axes[0].bin_edges()
        az_edges = self.axes[1].bin_edges()
        z_edges = self.axes[2].bin_edges()
        vr = np.diff(rho_edges ** 2) / 2.0
        vaz = 2.0 * np.diff(az_edges)
        vz = np.diff(z_edges)
        return vr[:, None, None] * vaz[None, :, None] * vz[None, None, :]


def default_cylindrical_axes(rho_max: float = 580.0, t_max: float = 7000.0,
                             z_half: float = 800.0,
                             n_impact: int = 0) -> CylindricalAxes:
    """The reference's infinite-muon binning
    (python/tablemaker/tabulator.py:631-637)."""
    axes = [
        Axis(0.0, rho_max, 100, power=2),
        Axis(0.0, math.pi, 36, power=1),
        Axis(-z_half, z_half, 80, power=1),
        Axis(0.0, t_max, 105, power=2),
    ]
    if n_impact:
        axes.append(default_impact_axis(n_impact))
    return CylindricalAxes(axes)
