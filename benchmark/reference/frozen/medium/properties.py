"""The medium-property container: layered ice (or single-layer water) with
per-layer parameters.

PyTorch counterpart of clsim_tpu.medium.properties (the reference's
I3CLSimMediumProperties, public/clsim/I3CLSimMediumProperties.h:51-135): a
NamedTuple of tensors; the propagation code evaluates the property
functions directly.

Layer convention (identical to the reference): uniform-height layers in
ascending z, layer index = floor((z_eff - layers_z_start)/layer_height)
clamped to [0, n_layers-1] (propagation_kernel.c.cl:73-76).

Medium kinds, all through the same separable interface
1/l_sca = gs(lambda) b400[layer], 1/l_abs = pa a_dust400 + qa + ra delta_tau:
  * "icecube": closed-form gs/pa/qa/ra (the IceCube ice model);
  * "water" (medium/antares.py): tabulated scattering and absorption on a
    uniform wavelength grid, unit per-layer coefficients;
  * "separable_table" (medium/photonics.py): tabulated gs/pa/qa/ra factors
    of a photonics ice table's rank decomposition, optionally tabulated
    phase and group indices.
A tabulated factor is an indexed lerp on the uniform grid (clamp the index,
take the fraction, gather, lerp).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import C_LIGHT
from . import functions as F
from .anisotropy import AnisotropyParams
from .tilt import TiltParams, disabled_tilt


class ScatteringAngleDist(NamedTuple):
    """Mixed simplified-Liu / Henyey-Greenstein scattering angle model
    (IceCube), or a tabulated phase function mixed with Rayleigh (water).

    For the IceCube model (python/MakeIceCubeMediumProperties.py:183):
      cos(theta) ~ liu_fraction * SimplifiedLiu(g) + (1-liu_fraction) * HG(g)
    For water, liu_fraction is the Rayleigh fraction and `table_*` hold the
    tabulated scattering-angle distribution (sampled by inverse CDF, cos
    applied to the sampled angle).
    """
    mean_cos: torch.Tensor      # <cos theta>, shared by Liu and HG parts
    liu_fraction: torch.Tensor  # fraction of the first (Liu / Rayleigh) part
    kind: str = "icecube"       # "icecube" | "water"
    table_cos: Optional[torch.Tensor] = None   # (n,) angle support [rad]
    table_cdf: Optional[torch.Tensor] = None   # (2, n): CDF and density


class MediumProperties(NamedTuple):
    # layer geometry (n_layers is a Python int)
    layers_z_start: torch.Tensor    # z of the bottom of layer 0 [m]
    layer_height: torch.Tensor      # uniform layer height [m]
    n_layers: int

    # global absorption/scattering shape parameters
    alpha: torch.Tensor
    kappa: torch.Tensor
    abs_A: torch.Tensor
    abs_B: torch.Tensor
    abs_D: torch.Tensor
    abs_E: torch.Tensor

    # per-layer parameters, shape (n_layers,): the model's "weights"
    b400: torch.Tensor          # geometric scattering coefficient at 400nm [1/m]
    a_dust400: torch.Tensor     # dust absorption coefficient at 400nm [1/m]
    delta_tau: torch.Tensor     # temperature correction

    # refractive index (layer-independent, as in every shipped ice model)
    ref_index: F.RefIndexParams

    scattering: ScatteringAngleDist
    anisotropy: AnisotropyParams
    tilt: TiltParams

    # misc
    density: torch.Tensor           # [g/cm^3]
    efficiency: torch.Tensor        # ice-model efficiency correction
    min_wlen: float = 265.0         # [nm]
    max_wlen: float = 675.0         # [nm]
    medium_kind: str = "icecube"    # "icecube" | "water" | "separable_table"

    # the uniform wavelength grid of the tabulated kinds
    water_wlen_first: float = 290.0  # [nm]
    water_wlen_step: float = 10.0    # [nm]
    # "water": scattering and absorption tables (nw,) [1/m]; the per-layer
    # coefficients are b400 = a_dust400 = 1, delta_tau = 0
    water_scat_inv: Optional[torch.Tensor] = None
    water_abs_inv: Optional[torch.Tensor] = None
    # "separable_table": the factors gs/pa/qa/ra as (nw,) tables; the
    # per-layer arrays hold the layer modes of the rank decomposition
    fac_gs: Optional[torch.Tensor] = None
    fac_pa: Optional[torch.Tensor] = None
    fac_qa: Optional[torch.Tensor] = None
    fac_ra: Optional[torch.Tensor] = None
    # optional tabulated phase / group index on the same grid
    ref_n_table: Optional[torch.Tensor] = None
    ref_g_table: Optional[torch.Tensor] = None

    @property
    def device(self):
        return self.b400.device

    # ------------------------------------------------------------------
    # property evaluation
    # ------------------------------------------------------------------
    def _water_table(self, table, wlen_nm):
        """Uniform-grid table lerp: clamp the index, take the fraction,
        gather, lerp (values outside the grid extrapolate flat)."""
        x = F._t(wlen_nm)
        nw = table.shape[0]
        xi = (x - self.water_wlen_first) / self.water_wlen_step
        i0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, nw - 2)
        frac = torch.clamp(xi - i0.to(xi.dtype), 0.0, 1.0)
        v0, v1 = table[i0], table[i0 + 1]
        return v0 + frac * (v1 - v0)

    def layer_for_z(self, z_eff):
        idx = torch.floor((z_eff - self.layers_z_start) / self.layer_height)
        return torch.clamp(idx.to(torch.int64), 0, self.n_layers - 1)

    def layer_bottom_z(self, layer):
        return self.layers_z_start + layer.to(torch.float32) * self.layer_height

    def abs_coeffs(self, wlen_nm):
        """Separable wavelength factors (pa, qa, ra) of the inverse absorption
        length: 1/l_abs[layer] = pa*a_dust400[layer] + qa + ra*delta_tau[layer].
        Water: (0, table(lambda), 0); separable tables: the tabulated rank
        factors."""
        if self.medium_kind == "water":
            qa = self._water_table(self.water_abs_inv, wlen_nm)
            zero = torch.zeros_like(qa)
            return zero, qa, zero
        if self.medium_kind == "separable_table":
            return (self._water_table(self.fac_pa, wlen_nm),
                    self._water_table(self.fac_qa, wlen_nm),
                    self._water_table(self.fac_ra, wlen_nm))
        return F.abs_separable_coeffs(self.kappa, self.abs_A, self.abs_B,
                                      self.abs_D, self.abs_E, wlen_nm)

    def scat_coeff(self, wlen_nm):
        """Wavelength factor gs of 1/l_sca[layer] = gs*b400[layer]
        (water: the particulate + water table, b400 == 1)."""
        if self.medium_kind == "water":
            return self._water_table(self.water_scat_inv, wlen_nm)
        if self.medium_kind == "separable_table":
            return self._water_table(self.fac_gs, wlen_nm)
        return F.scat_separable_coeff(self.alpha, wlen_nm)

    def inv_scattering_length(self, layer, wlen_nm):
        return self.scat_coeff(wlen_nm) * self.b400[layer]

    def inv_absorption_length(self, layer, wlen_nm):
        pa, qa, ra = self.abs_coeffs(wlen_nm)
        return pa * self.a_dust400[layer] + qa + ra * self.delta_tau[layer]

    def phase_ref_index(self, wlen_nm):
        if self.ref_n_table is not None:
            return self._water_table(self.ref_n_table, wlen_nm)
        return F.phase_ref_index(self.ref_index, wlen_nm)

    def group_ref_index(self, wlen_nm):
        if self.ref_g_table is not None:
            return self._water_table(self.ref_g_table, wlen_nm)
        return F.group_ref_index(self.ref_index, wlen_nm)

    def missing_tables(self) -> Optional[str]:
        """Why a tabulated medium cannot be propagated (its tables are
        missing), else None (the JAX package's fused_supported checks,
        clsim_tpu/propagate/kernel.py:1816-1824)."""
        if self.medium_kind not in ("icecube", "water", "separable_table"):
            return f"unknown medium kind {self.medium_kind!r}"
        if self.medium_kind == "water" and (self.water_abs_inv is None
                                            or self.water_scat_inv is None):
            return "water medium without wavelength tables"
        if self.medium_kind == "separable_table" and self.fac_qa is None:
            return "separable-table medium without factor tables"
        if self.scattering.kind not in ("icecube", "water"):
            return f"unknown scattering kind {self.scattering.kind!r}"
        if (self.scattering.kind != "icecube"
                and self.scattering.table_cos is None):
            return "tabulated scattering distribution without tables"
        return None

    def group_velocity(self, wlen_nm):
        return C_LIGHT / self.group_ref_index(wlen_nm)


def make_homogeneous_ice(n_layers: int = 2,
                         z_start: float = -1000.0,
                         layer_height: float = 1000.0,
                         b400: float = 0.04,
                         a_dust400: float = 0.006,
                         delta_tau: float = 1.0,
                         mean_cos: float = 0.9,
                         liu_fraction: float = 0.45,
                         alpha: float = 0.90,
                         kappa: float = 1.08,
                         abs_A: float = 6954.0,
                         abs_B: float = 6618.0,
                         device="cuda") -> MediumProperties:
    """A simple uniform ice model.  Defaults are representative mid-depth
    SPICE values (the same as the JAX package's)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    full = lambda v: torch.full((n_layers,), v, dtype=torch.float32,
                                device=device)
    wv0 = 400.0
    return MediumProperties(
        layers_z_start=f32(z_start),
        layer_height=f32(layer_height),
        n_layers=n_layers,
        alpha=f32(alpha), kappa=f32(kappa),
        abs_A=f32(abs_A), abs_B=f32(abs_B),
        abs_D=f32(wv0 ** kappa), abs_E=f32(0.0),
        b400=full(b400), a_dust400=full(a_dust400), delta_tau=full(delta_tau),
        ref_index=F.RefIndexParams(
            n=torch.as_tensor(F.DEFAULT_ICE_REF_INDEX.n, device=device),
            g=torch.as_tensor(F.DEFAULT_ICE_REF_INDEX.g, device=device)),
        scattering=ScatteringAngleDist(mean_cos=f32(mean_cos),
                                       liu_fraction=f32(liu_fraction)),
        anisotropy=AnisotropyParams(azimuth=f32(0.0), mag_along=f32(0.0),
                                    mag_perp=f32(0.0), enabled=False),
        tilt=disabled_tilt(device),
        density=f32(0.9216),
        efficiency=f32(1.0),
    )
