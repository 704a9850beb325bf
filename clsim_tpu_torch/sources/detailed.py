"""Reduced detailed-physics cascade propagator: the first *physics-carrying*
implementation of the LightSourcePropagator plugin seam (PyTorch port's
copy of clsim_tpu.sources.detailed: host numpy, the same rng consumption).

The reference's Geant4 path (private/geant4/TrkCerenkov.cxx:120-619) tracks
every shower particle and, per tracking step, emits Cherenkov step bunches
with the step's true beta and a <= maxNumPhotonsPerStep cap (PostStepDoIt
semantics: MeanNumberOfPhotons from the Frank-Tamm integral at that beta,
positions spread along the step).  Geant4 itself cannot ship here; this
module implements the same *contract* with a reduced shower model:

  * total charged track length L = 5.21 m/GeV * (0.924/rho) * E (the same
    normalization the PPC parameterization integrates against,
    I3CLSimLightSourceToStepConverterPPC.cxx nph; sources/ppc.py:217), with
    the hadronic EM-scale fluctuation F +- dF applied for hadron types;
  * track segments placed along the shower axis at depths drawn from the
    Gamma(a, b) longitudinal profile (shower.py:65-81) and directions drawn
    from the PPC angular emission profile (PPC.cxx:749-760) -- the
    multiple-scattering spread of shower electrons;
  * each segment carries a TRUE beta drawn from a near-relativistic
    track-length spectrum (1 - beta ~ Exp(beta_spread), clamped at the
    Cherenkov threshold 1/n): its step emits photons at the Frank-Tamm rate
    *for that beta* and spawns photons on the beta-dependent cone --
    detailed physics the beta=1 parameterization cannot represent, which is
    exactly what the seam exists to carry;
  * per-step photon cap (<= photons_per_step, TrkCerenkov.cxx:555-583).

Validation contract (tests/test_detailed.py): for beta_spread -> 0 the
total emitted-photon yield converges to the PPC parameterization's mean
yield for the same cascade; with beta spread it falls below by exactly the
<Frank-Tamm(beta)>/Frank-Tamm(1) ratio.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..constants import C_LIGHT, PPC_NPH_CONST, PPC_NPH_REF_DENSITY
from ..geometry import to_numpy
from ..medium import functions as F
from ..medium.properties import MediumProperties
from ..ops.spectrum import WavelengthSpectrum, photons_per_meter
from ..types import StepBatch
from .particles import EM_TYPES, HADRON_TYPES, Particle
from .ppc import _rotate_by_angle, sample_cascade_angles
from .shower import shower_parameters


class DetailedCascadePropagator:
    """LightSourcePropagator emitting per-segment variable-beta Cherenkov
    steps for EM/hadronic cascades (the reduced TrkCerenkov)."""

    def __init__(self, medium: MediumProperties,
                 spectrum: WavelengthSpectrum,
                 segment_length_m: float = 1.0,
                 photons_per_step: int = 200,
                 beta_spread: float = 0.01,
                 max_energy_gev: float = float("inf"),
                 n_beta_table: int = 32):
        self.medium = medium
        self.segment_length = float(segment_length_m)
        self.photons_per_step = int(photons_per_step)
        self.beta_spread = float(beta_spread)
        self.max_energy = float(max_energy_gev)
        self.density = float(medium.density)

        bx = np.asarray(spectrum.bias_x)
        by = np.asarray(spectrum.bias_y)
        # Cherenkov threshold at the peak phase index; segments below emit
        # nothing (TrkCerenkov MeanNumberOfPhotons <= 0 branch)
        wl = np.linspace(float(medium.min_wlen), float(medium.max_wlen), 64)
        n_phase = to_numpy(F.phase_ref_index(medium.ref_index, wl))
        self.beta_threshold = float(1.0 / n_phase.max())
        # beta -> bias-weighted photons/m lookup (monotone; linear interp)
        self._beta_grid = np.linspace(self.beta_threshold, 1.0, n_beta_table)
        self._ppm_grid = np.array([
            float(photons_per_meter(medium.ref_index, bx, by,
                                    medium.min_wlen, medium.max_wlen,
                                    beta=b))
            for b in self._beta_grid])

    def ppm(self, beta):
        """Bias-weighted Frank-Tamm photons/m at the given beta(s)."""
        return np.interp(beta, self._beta_grid, self._ppm_grid,
                         left=0.0, right=self._ppm_grid[-1])

    # -- LightSourcePropagator protocol --------------------------------
    def is_valid_for(self, source) -> bool:
        return (isinstance(source, Particle)
                and source.ptype in (EM_TYPES | HADRON_TYPES)
                and not getattr(source, "is_cascade_segment", False)
                and source.energy <= self.max_energy)

    def convert(self, source: Particle, identifier: int,
                emit_secondary, emit_steps,
                rng: np.random.Generator) -> None:
        E = source.energy
        sp = shower_parameters(source.ptype, E, self.density)
        f = 1.0
        if sp.em_scale_sigma != 0.0:
            while True:
                f = sp.em_scale + sp.em_scale_sigma * rng.normal()
                if 0.0 <= f <= 1.0:
                    break
        L_total = f * PPC_NPH_CONST * (PPC_NPH_REF_DENSITY
                                       / self.density) * E
        if L_total <= 0.0:
            return
        n_seg = max(1, int(math.ceil(L_total / self.segment_length)))
        seg_len = L_total / n_seg

        # segment depths from the Gamma(a, b) longitudinal profile; the
        # segment runs along a direction scattered off the shower axis
        depth = sp.b * rng.standard_gamma(sp.a, n_seg) if sp.b > 0.0 \
            else np.zeros(n_seg)
        cos_a, sin_a = sample_cascade_angles(rng, n_seg)
        dx, dy, dz = _rotate_by_angle(
            cos_a, sin_a, np.full(n_seg, source.dir_x),
            np.full(n_seg, source.dir_y), np.full(n_seg, source.dir_z),
            rng.random(n_seg))

        # per-segment beta: near-relativistic with an exponential tail,
        # clamped at the Cherenkov threshold (sub-threshold track length
        # emits nothing, like TrkCerenkov's MeanNumberOfPhotons <= 0)
        if self.beta_spread > 0.0:
            beta = 1.0 - rng.exponential(self.beta_spread, n_seg)
        else:
            beta = np.ones(n_seg)
        emitting = beta > self.beta_threshold
        mean_photons = np.where(emitting,
                                self.ppm(np.clip(beta, self.beta_threshold,
                                                 1.0)) * seg_len, 0.0)
        num = rng.poisson(mean_photons)

        keep = num > 0
        if not keep.any():
            return
        idx = np.nonzero(keep)[0]

        # split any segment over the per-step photon cap (TrkCerenkov
        # maxNumPhotonsPerStep:555-583)
        rows: List[int] = []
        counts: List[int] = []
        pps = self.photons_per_step
        for i in idx:
            n_i = int(num[i])
            while n_i > 0:
                c = min(n_i, pps)
                rows.append(i)
                counts.append(c)
                n_i -= c
        rows = np.asarray(rows, np.int64)
        counts = np.asarray(counts, np.int64)
        n = rows.shape[0]

        x0 = source.x + depth[rows] * source.dir_x
        y0 = source.y + depth[rows] * source.dir_y
        z0 = source.z + depth[rows] * source.dir_z
        t0 = source.time + depth[rows] / C_LIGHT
        emit_steps(StepBatch(
            x=x0.astype(np.float32), y=y0.astype(np.float32),
            z=z0.astype(np.float32), t=t0.astype(np.float32),
            dir_x=dx[rows].astype(np.float32),
            dir_y=dy[rows].astype(np.float32),
            dir_z=dz[rows].astype(np.float32),
            length=np.full(n, seg_len, np.float32),
            beta=beta[rows].astype(np.float32),
            num_photons=counts.astype(np.int32),
            weight=np.ones(n, np.float32),
            identifier=np.full(n, identifier, np.int32),
            source_type=np.zeros(n, np.int32)))


class DetailedMuonPropagator:
    """Muon-capable detailed propagator: segmented bare-muon Cherenkov
    steps PLUS discrete stochastic losses emitted as SECONDARY cascades
    through ``emit_secondary`` -- each re-enters the converter chain and is
    served by whatever cascade handler is registered (PPC parameterization
    or DetailedCascadePropagator).  This exercises the propagator seam the
    way the reference's tracking does: TrkCerenkov serves any charged
    particle the tracker produces (private/geant4/TrkCerenkov.cxx:120-619),
    and a muon's light is bare-track Cherenkov plus its stochastic-loss
    showers.

    Yield contract (tests/test_detailed.py): the PPC muon parameterization
    emits mean_ppm * length * extr photons with
    extr = 1 + max(0, 0.1880 + 0.0206 ln E) (PPC.cxx:821-843; sources/
    ppc.py:240-259), the bare-muon share being 1/extr.  Here the bare track
    emits mean_ppm * length directly, and the stochastic losses carry a
    cascade-equivalent energy E_sec = (extr - 1) * length / nph_per_gev so
    that E[bare + secondary yield] equals the PPC total -- but as DISCRETE
    cascades at sampled track positions with a 1/E^2 loss spectrum
    (brems/pair/delta-like) instead of PPC's uniform continuous smear.
    """

    def __init__(self, medium: MediumProperties,
                 spectrum: WavelengthSpectrum,
                 segment_length_m: float = 10.0,
                 photons_per_step: int = 200,
                 loss_e_min_gev: float = 0.5,
                 loss_e_max_gev: Optional[float] = None,
                 secondary_type=None,
                 max_energy_gev: float = float("inf")):
        from .particles import ParticleType
        self.medium = medium
        self.segment_length = float(segment_length_m)
        self.photons_per_step = int(photons_per_step)
        self.loss_e_min = float(loss_e_min_gev)
        self.loss_e_max = loss_e_max_gev
        self.secondary_type = secondary_type or ParticleType.EMinus
        self.max_energy = float(max_energy_gev)
        self.density = float(medium.density)
        self.mean_ppm = float(photons_per_meter(
            medium.ref_index, np.asarray(spectrum.bias_x),
            np.asarray(spectrum.bias_y), medium.min_wlen, medium.max_wlen))
        # cascade track length per GeV (the PPC nph normalization)
        self.nph_per_gev = PPC_NPH_CONST * (PPC_NPH_REF_DENSITY
                                            / self.density)

    # -- LightSourcePropagator protocol --------------------------------
    def is_valid_for(self, source) -> bool:
        from .particles import MUON_TYPES
        return (isinstance(source, Particle)
                and source.ptype in MUON_TYPES
                and not getattr(source, "daughters", ())
                and source.energy <= self.max_energy)

    def convert(self, source: Particle, identifier: int,
                emit_secondary, emit_steps,
                rng: np.random.Generator) -> None:
        E = source.energy
        length = source.length
        if math.isnan(length):
            length = 2000.0
        if length <= 0.0 or E <= 0.0:
            return

        # ---- bare-muon Cherenkov: per-segment Poisson steps, beta = 1 ----
        n_seg = max(1, int(math.ceil(length / self.segment_length)))
        seg_len = length / n_seg
        num = rng.poisson(self.mean_ppm * seg_len, n_seg)
        keep = np.nonzero(num > 0)[0]
        if keep.size:
            rows: List[int] = []
            counts: List[int] = []
            for i in keep:
                n_i = int(num[i])
                while n_i > 0:
                    c = min(n_i, self.photons_per_step)
                    rows.append(int(i))
                    counts.append(c)
                    n_i -= c
            rowsa = np.asarray(rows, np.int64)
            counts_a = np.asarray(counts, np.int32)
            d0 = rowsa * seg_len
            n = rowsa.shape[0]
            emit_steps(StepBatch(
                x=(source.x + d0 * source.dir_x).astype(np.float32),
                y=(source.y + d0 * source.dir_y).astype(np.float32),
                z=(source.z + d0 * source.dir_z).astype(np.float32),
                t=(source.time + d0 / C_LIGHT).astype(np.float32),
                dir_x=np.full(n, source.dir_x, np.float32),
                dir_y=np.full(n, source.dir_y, np.float32),
                dir_z=np.full(n, source.dir_z, np.float32),
                length=np.full(n, seg_len, np.float32),
                beta=np.ones(n, np.float32),
                num_photons=counts_a,
                weight=np.ones(n, np.float32),
                identifier=np.full(n, identifier, np.int32),
                source_type=np.zeros(n, np.int32)))

        # ---- stochastic losses as secondary cascades ---------------------
        log_e = math.log(max(E, 1.0))
        extr = 1.0 + max(0.0, 0.1880 + 0.0206 * log_e)
        e_sec_total = (extr - 1.0) * length / self.nph_per_gev
        if e_sec_total <= 0.0:
            return
        a = self.loss_e_min
        b = self.loss_e_max if self.loss_e_max is not None else max(
            2.0 * a, 0.5 * E)
        if b <= a:
            a, b = 0.5 * b, b
        # 1/E^2 spectrum on [a, b]: norm = 1/a - 1/b, mean = ln(b/a)/norm
        norm = 1.0 / a - 1.0 / b
        mean_loss = math.log(b / a) / norm
        n_loss = rng.poisson(e_sec_total / mean_loss)
        if n_loss == 0:
            return
        u = rng.random(n_loss)
        e_loss = 1.0 / (1.0 / a - u * norm)
        d = rng.random(n_loss) * length
        for k in range(n_loss):
            emit_secondary(Particle(
                ptype=self.secondary_type,
                x=source.x + d[k] * source.dir_x,
                y=source.y + d[k] * source.dir_y,
                z=source.z + d[k] * source.dir_z,
                time=source.time + d[k] / C_LIGHT,
                energy=float(e_loss[k]),
                dir_x=source.dir_x, dir_y=source.dir_y,
                dir_z=source.dir_z))
