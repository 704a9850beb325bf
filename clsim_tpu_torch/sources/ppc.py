"""PPC-parameterized step generation: particles -> Cherenkov steps.

Vectorized-numpy equivalent of the reference's workhorse converter
I3CLSimLightSourceToStepConverterPPC (private/clsim/
I3CLSimLightSourceToStepConverterPPC.cxx).  Physics contract:

  * cascades: nph = 5.21*(0.924/rho) photons per GeV yield scale; EM-scale
    fluctuation f ~ N(emScale, emScaleSigma) truncated to [0,1];
    meanNumPhotons = f * meanPhotonsPerMeter * nph * E  (:285-297);
    photon count ~ Poisson (Gaussian above 1e7); split into steps of
    photons_per_step (default 200, switching to high_photons_per_step above
    1e9 photons); longitudinal position ~ b * Gamma(a) [m]; direction sampled
    from the PPC angular distribution
        cos(theta) = 1 - (-ln(1 - U*I)/b_ang)^(1/a_ang),
        I = 1 - exp(-b_ang * 2^a_ang),  a_ang = 0.39, b_ang = 2.61  (:680-775)
    rotated about the particle axis by a uniform azimuth; step length 1mm,
    beta = 1.
  * muons: extra-photon factor extr = 1 + max(0, 0.1880 + 0.0206*ln(E));
    muon-like fraction 1/extr emitted uniformly along the track as steps of
    full track length; the cascade-like remainder at uniform longitudinal
    positions with the cascade angular distribution (:356-470, :821-843).
  * the per-meter yield is the bias-weighted Frank-Tamm integral evaluated at
    the source layer (:113-122).

Step generation runs on the host (numpy, float64; the cascade-like steps
through the native C++ sampler of native/ when it loads).  It is not a tiny
fraction of the work.  For the main path's 100 TeV cascade (91,723 steps
into 262,144 slots; `chip_smoke.py --host-split`, on the host of an H100
machine) a slot assignment that loops over the steps, as the JAX
package's does, took 0.306 s of `simulate`'s 0.318 s, the conversion
0.015 s and propagation 0.017 s.  Here assign_steps_to_slots builds its
split counts from whole-array operations (0.026 s); the JAX package keeps
its per-step loop.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..constants import C_LIGHT, PPC_NPH_CONST, PPC_NPH_REF_DENSITY
from ..medium.properties import MediumProperties
from ..ops.spectrum import WavelengthSpectrum, photons_per_meter
from ..types import StepBatch
from ..util import profiling as P
from .particles import (EM_TYPES, HADRON_TYPES, MUON_TYPES, TAU_TYPES,
                        Particle)
from .shower import shower_parameters

ANGULAR_A = 0.39
ANGULAR_B = 2.61


def _sample_count(rng: np.random.Generator, mean: float) -> int:
    """Poisson, switching to a (non-negative) Gaussian above 1e7
    (PPC.cxx:299-315)."""
    if mean <= 0:
        return 0
    if mean > 1e7:
        while True:
            v = rng.normal(mean, math.sqrt(mean))
            if v >= 0:
                return int(v)
    return int(rng.poisson(mean))


def sample_cascade_angles(rng: np.random.Generator, n: int):
    """(cos, sin) of the PPC cascade angular emission profile (PPC.cxx:749-760)."""
    a, b = ANGULAR_A, ANGULAR_B
    I = 1.0 - math.exp(-b * 2.0 ** a)
    u = rng.random(n)
    cos = np.maximum(1.0 - (-np.log(1.0 - u * I) / b) ** (1.0 / a), -1.0)
    sin = np.sqrt(1.0 - cos * cos)
    return cos, sin


def _rotate_by_angle(cos, sin, dx, dy, dz, u):
    """numpy version of ops.rotations.scatter_direction_by_angle."""
    beta = 2.0 * np.pi * u
    cosb, sinb = np.cos(beta), np.sin(beta)
    sinth = np.sqrt(np.maximum(0.0, 1.0 - dz * dz))
    safe = np.maximum(sinth, 1e-20)
    gx = dx * cos - (dy * cosb + dz * dx * sinb) * sin / safe
    gy = dy * cos + (dx * cosb - dz * dy * sinb) * sin / safe
    gz = dz * cos + sin * sinb * sinth
    vx = sin * cosb
    vy = sin * sinb
    vz = cos * np.sign(dz)
    vert = sinth <= 0.0
    nx = np.where(vert, vx, gx)
    ny = np.where(vert, vy, gy)
    nz = np.where(vert, vz, gz)
    inv = 1.0 / np.sqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


class PPCStepGenerator:
    """Particle -> StepBatch converter with the PPC parameterization."""

    def __init__(self, medium: MediumProperties,
                 spectrum: WavelengthSpectrum,
                 photons_per_step: int = 200,
                 high_photons_per_step: int = 0,
                 high_threshold: float = 1e9,
                 use_cascade_extension: bool = True,
                 use_native: bool = True):
        # the native C++ sampler (native/): it warns once when it cannot be
        # built or loaded, and the numpy sampler serves instead
        from .. import native as _native
        self._native = _native if (use_native and _native.available()) \
            else None
        self.medium = medium
        self.photons_per_step = photons_per_step
        self.high_photons_per_step = high_photons_per_step or photons_per_step
        self.high_threshold = high_threshold
        self.use_cascade_extension = use_cascade_extension
        # per-layer bias-weighted Frank-Tamm yield (PPC.cxx:113-122)
        n_layers = medium.n_layers
        with P.wait("generator_init", 2):
            self.density = float(medium.density)
            ppm = photons_per_meter(medium.ref_index, spectrum.bias_x,
                                    spectrum.bias_y, medium.min_wlen,
                                    medium.max_wlen)
        # the refractive index is layer-independent in every shipped model,
        # so the per-layer yields coincide; keep the per-layer array for
        # API parity with the reference
        self.mean_photons_per_meter = np.full(n_layers, float(ppm))

    # ------------------------------------------------------------------
    def _layer_for(self, z: float) -> int:
        m = self.medium
        with P.wait("layer_for", 2):
            z0, h = float(m.layers_z_start), float(m.layer_height)
        i = int(max(0.0, (z - z0) / h))
        return min(i, m.n_layers - 1)

    def _steps_for_counts(self, num_photons: int, pps: int):
        """Split a photon count into per-step counts (steps of pps photons
        plus one remainder step)."""
        n_full = num_photons // pps
        rest = num_photons % pps
        counts = np.full(n_full + (1 if rest else 0), pps, np.int64)
        if rest:
            counts[-1] = rest
        return counts

    def _cascade_steps(self, p: Particle, identifier: int, num_photons: int,
                       pps: int, a: float, b: float,
                       rng: np.random.Generator,
                       uniform_along_length: Optional[float] = None):
        counts = self._steps_for_counts(num_photons, pps)
        n = len(counts)
        if n == 0:
            return None
        if self._native is not None:
            seed = int(rng.integers(0, 2 ** 63 - 1))
            x, y, z, t, dx, dy, dz = self._native.cascade_step_arrays(
                seed, n, (p.x, p.y, p.z), p.time,
                (p.dir_x, p.dir_y, p.dir_z),
                gamma_a=a if b > 0.0 else 1.0,
                gamma_b=b if uniform_along_length is None else 0.0,
                uniform_length=uniform_along_length or 0.0)
        else:
            if uniform_along_length is not None:
                longi = rng.random(n) * uniform_along_length
            elif b > 0.0:
                longi = b * rng.standard_gamma(a, n)
            else:
                longi = np.zeros(n)
            cos, sin = sample_cascade_angles(rng, n)
            dx, dy, dz = _rotate_by_angle(
                cos, sin, np.full(n, p.dir_x), np.full(n, p.dir_y),
                np.full(n, p.dir_z), rng.random(n))
            x = (p.x + longi * p.dir_x).astype(np.float32)
            y = (p.y + longi * p.dir_y).astype(np.float32)
            z = (p.z + longi * p.dir_z).astype(np.float32)
            t = (p.time + longi / C_LIGHT).astype(np.float32)
        return StepBatch(
            x=np.asarray(x, np.float32), y=np.asarray(y, np.float32),
            z=np.asarray(z, np.float32), t=np.asarray(t, np.float32),
            dir_x=np.asarray(dx, np.float32), dir_y=np.asarray(dy, np.float32),
            dir_z=np.asarray(dz, np.float32),
            length=np.full(n, 1e-3, np.float32),
            beta=np.ones(n, np.float32),
            num_photons=counts.astype(np.int32),
            weight=np.ones(n, np.float32),
            identifier=np.full(n, identifier, np.int32),
            source_type=np.zeros(n, np.int32))

    def _muon_steps(self, p: Particle, identifier: int, num_photons: int,
                    pps: int, length: float):
        counts = self._steps_for_counts(num_photons, pps)
        n = len(counts)
        if n == 0:
            return None
        return StepBatch(
            x=np.full(n, p.x, np.float32), y=np.full(n, p.y, np.float32),
            z=np.full(n, p.z, np.float32),
            t=np.full(n, p.time, np.float32),
            dir_x=np.full(n, p.dir_x, np.float32),
            dir_y=np.full(n, p.dir_y, np.float32),
            dir_z=np.full(n, p.dir_z, np.float32),
            length=np.full(n, length, np.float32),
            beta=np.ones(n, np.float32),
            num_photons=counts.astype(np.int32),
            weight=np.ones(n, np.float32),
            identifier=np.full(n, identifier, np.int32),
            source_type=np.zeros(n, np.int32))

    # ------------------------------------------------------------------
    def convert(self, p: Particle, identifier: int,
                rng: np.random.Generator) -> List[StepBatch]:
        """Generate all step batches for one particle."""
        E = p.energy
        log_e = max(0.0, math.log(max(E, 1e-30)))
        layer = self._layer_for(p.z)
        mean_ppm = self.mean_photons_per_meter[layer]
        out: List[StepBatch] = []

        is_em = p.ptype in EM_TYPES
        is_hadron = p.ptype in HADRON_TYPES
        is_muon = p.ptype in MUON_TYPES
        is_tau = p.ptype in TAU_TYPES

        if is_em or is_hadron:
            nph = PPC_NPH_CONST * PPC_NPH_REF_DENSITY / self.density
            sp = shower_parameters(p.ptype, E, self.density)
            f = 1.0
            if sp.em_scale_sigma != 0.0:
                while True:
                    f = sp.em_scale + sp.em_scale_sigma * rng.normal()
                    if 0.0 <= f <= 1.0:
                        break
            mean_num = f * mean_ppm * nph * E
            num = _sample_count(rng, mean_num)
            pps = (self.high_photons_per_step
                   if num > self.high_threshold else self.photons_per_step)
            if p.is_cascade_segment:
                if not (p.length > 0):
                    raise ValueError("cascade segment must have a length")
                b = self._cascade_steps(p, identifier, num, pps, 0.0, 0.0, rng,
                                        uniform_along_length=p.length)
            else:
                b = self._cascade_steps(
                    p, identifier, num, pps, sp.a,
                    sp.b if self.use_cascade_extension else 0.0, rng)
            if b is not None:
                out.append(b)
        elif is_muon or is_tau:
            length = p.length if not math.isnan(p.length) else 2000.0
            extr = 1.0 + max(0.0, 0.1880 + 0.0206 * log_e)
            muon_fraction = 1.0 / extr
            mean_total = mean_ppm * length * extr
            n_muon = _sample_count(rng, mean_total * muon_fraction)
            n_casc = _sample_count(rng, mean_total * (1.0 - muon_fraction))

            pps = (self.high_photons_per_step
                   if n_muon > self.high_threshold else self.photons_per_step)
            b = self._muon_steps(p, identifier, n_muon, pps, length)
            if b is not None:
                out.append(b)

            pps = (self.high_photons_per_step
                   if n_casc > self.high_threshold else self.photons_per_step)
            b = self._cascade_steps(p, identifier, n_casc, pps, 0.0, 0.0, rng,
                                    uniform_along_length=length)
            if b is not None:
                out.append(b)
        else:
            raise ValueError(f"PPC parameterization cannot handle {p.ptype}")
        return out


def assign_steps_to_slots(batch: StepBatch, n_slots: int) -> List[StepBatch]:
    """Distribute steps over engine slots, splitting high-yield steps so the
    per-slot photon counts are balanced.  Returns one or more slot-assigned
    batches of exactly n_slots steps (padded with dummies).

    This replaces the reference's photon-count-bucketed I3CLSimStepStore
    (public/clsim/I3CLSimStepStore.h:163-220): where the reference sorts
    steps into similar-yield bunches to control SIMT divergence, we split
    and balance outright."""
    num = np.asarray(batch.num_photons, np.int64)
    total = int(num.sum())
    if total == 0:
        return [batch.pad_to(n_slots)] if batch.n_steps <= n_slots else []
    # pick the per-slot target so that sum(ceil(num/target)) <= n_slots is
    # guaranteed whenever the non-empty step count fits at all
    n_nonzero = int((num > 0).sum())
    avail = max(1, n_slots - min(n_nonzero, n_slots - 1))
    target = max(1, -(-total // avail))  # ceil
    reps = np.where(num > 0, np.maximum(1, -(-num // target)), 1)

    idx = np.repeat(np.arange(len(num)), reps)
    # split each step's photons evenly across its reps: repetition k of a
    # step of n photons in r reps carries n // r, plus one while k < n % r
    rank = np.arange(len(idx)) - np.repeat(np.cumsum(reps) - reps, reps)
    split_counts = num[idx] // reps[idx] + (rank < num[idx] % reps[idx])

    def take(a):
        return np.asarray(a)[idx]

    full = StepBatch(
        x=take(batch.x), y=take(batch.y), z=take(batch.z), t=take(batch.t),
        dir_x=take(batch.dir_x), dir_y=take(batch.dir_y), dir_z=take(batch.dir_z),
        length=take(batch.length), beta=take(batch.beta),
        num_photons=split_counts.astype(np.int32),
        weight=take(batch.weight), identifier=take(batch.identifier),
        source_type=take(batch.source_type))

    out = []
    for s in range(0, full.n_steps, n_slots):
        sub = StepBatch(*[np.asarray(f)[s:s + n_slots] for f in full])
        out.append(sub.pad_to(n_slots))
    return out
