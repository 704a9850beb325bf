"""High-level user API (PyTorch counterpart of clsim_tpu.api): the
equivalent of the reference's I3CLSimMakePhotons tray segment.

    sim = Simulation(medium=..., geometry=..., config=..., device="cuda")
    result = sim.simulate(particles, seed=1234)   # per-DOM hit histograms

Wiring contract (I3CLSimMakePhotons.py:370-430, common.py setupDetector):
  * wavelength generation bias = DOM acceptance evaluated at radius
    R*oversize with efficiency = icemodel_eff * unshadowed * holeice peak
    * 1.35 * 1.01
  * PPC parameterization converts particles to steps (photons_per_step=200)
  * pancake factor = oversize

The medium and geometry tensors must live on `device`.  Records and hits
(simulate_hits, simulate_photons, simulate_hits_from_photons) and the
multi-device mesh are queued in ROADMAP.md queue A (items 12 and 14).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .convert import steps_from_numpy
from .geometry import DetectorGeometry, advise_strings_per_photon, to_numpy
from .hits.acceptance import HOLE_ICE_H2_50CM, icecube_dom_acceptance
from .medium.properties import MediumProperties
from .ops.spectrum import (WavelengthSpectrum, make_cherenkov_spectrum,
                           stack_spectra)
from .propagate.dispatch import check_diagnostics, propagate_auto
from .propagate.engine import PropagationResult
from .sources.convert import (MuonSlicerPropagator, SourceConverter,
                              default_parameterizations)
from .sources.flasher import FlasherStepGenerator
from .sources.particles import Particle
from .sources.ppc import PPCStepGenerator, assign_steps_to_slots
from .types import PropagationConfig, StepBatch

RECORDS_ITEM = ("photon records and MCPE hits are queued (ROADMAP.md queue "
                "A item 12)")
MESH_ITEM = "multi-device propagation is queued (ROADMAP.md queue A item 14)"


class Simulation:
    """End-to-end photon simulation for one detector + medium configuration."""

    def __init__(self,
                 medium: MediumProperties,
                 geometry: DetectorGeometry,
                 config: Optional[PropagationConfig] = None,
                 unweighted_photons: bool = False,
                 unshadowed_fraction: float = 1.0,
                 hole_ice_peak: float = HOLE_ICE_H2_50CM["peak"],
                 photons_per_step: int = 200,
                 use_cascade_extension: bool = True,
                 flasher_spectra: Sequence[WavelengthSpectrum] = (),
                 mesh=None,
                 backend: str = "auto",
                 fused_opts: Optional[dict] = None,
                 propagators: Sequence = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(MESH_ITEM)
        self.medium = medium
        self.geometry = geometry
        self.backend = backend
        self.device = medium.device if device is None else device
        self.fused_opts = dict(fused_opts or {})
        cfg = config or PropagationConfig()
        if cfg.pancake_factor == 1.0 and geometry.oversize != 1.0:
            cfg = dataclasses.replace(cfg, pancake_factor=geometry.oversize)
        self.config = cfg

        # static collision-approximation check: warn when the top-K
        # closest-string test can provably shadow hits on this geometry
        _, k_reason = advise_strings_per_photon(
            geometry, cfg.max_segment_m, cfg.strings_per_photon)
        if k_reason:
            import warnings
            warnings.warn(k_reason, UserWarning, stacklevel=2)

        # --- wavelength bias (common.py:191-229, I3CLSimMakePhotons.py:389-397)
        if unweighted_photons:
            bias_x = bias_y = None
        else:
            eff = (float(medium.efficiency) * unshadowed_fraction *
                   hole_ice_peak * 1.35 * 1.01)
            acc = icecube_dom_acceptance(
                dom_radius=geometry.om_radius * geometry.oversize,
                efficiency=eff)
            nb = acc.values.shape[0]
            bias_x = float(acc.first_x) + float(acc.dx) * np.arange(nb)
            bias_y = to_numpy(acc.values)
        self._bias_x, self._bias_y = bias_x, bias_y

        cherenkov = make_cherenkov_spectrum(
            medium.ref_index, medium.min_wlen, medium.max_wlen,
            bias_wlen_nm=bias_x, bias_values=bias_y)
        self.spectra = stack_spectra([cherenkov, *flasher_spectra],
                                     device=self.device)

        self.step_generator = PPCStepGenerator(
            medium, cherenkov, photons_per_step=photons_per_step,
            use_cascade_extension=use_cascade_extension)
        self.flasher_generator = FlasherStepGenerator(cherenkov)
        if propagators is None:
            propagators = [MuonSlicerPropagator()]
        self.source_converter = SourceConverter(
            default_parameterizations(self.step_generator,
                                      self.flasher_generator),
            propagators=propagators)

    # ------------------------------------------------------------------
    def steps_from_particles(self, particles: Sequence[Particle],
                             rng: np.random.Generator) -> List[StepBatch]:
        """Light sources -> slot-assigned host step batches through the
        conversion queue (sources/convert.py)."""
        batches = self.source_converter.convert(
            [(p, ident) for ident, p in enumerate(particles)], rng)
        if not batches:
            return []
        return assign_steps_to_slots(StepBatch.concatenate(batches),
                                     self.config.n_slots)

    def run_steps(self, slot_batches: List[StepBatch], seed: int
                  ) -> Optional[PropagationResult]:
        """Propagate pre-assigned slot batches; accumulates over batches.
        Batch i's random stream is seeded from (seed, i) with numpy's
        SeedSequence."""
        total = None
        for i, batch in enumerate(slot_batches):
            bseed = int(np.random.SeedSequence([int(seed), i]).generate_state(
                1, np.uint64)[0] & np.uint64(2 ** 63 - 1))
            steps = steps_from_numpy(batch._asdict(), self.device)
            res = propagate_auto(steps, self.medium, self.geometry,
                                 self.spectra, bseed, self.config,
                                 backend=self.backend, **self.fused_opts)
            if total is None:
                total = res
                continue
            dt = (total.diag_totals + res.diag_totals
                  if total.diag_totals is not None
                  and res.diag_totals is not None else res.diag_totals)
            total = PropagationResult(
                hist=total.hist + res.hist,
                n_generated=total.n_generated + res.n_generated,
                n_hits=total.n_hits + res.n_hits,
                weight_hits=total.weight_hits + res.weight_hits,
                n_iterations=total.n_iterations + res.n_iterations,
                diag_totals=dt)
        if total is not None:
            # surface dropped/abandoned counts (warns on loss)
            check_diagnostics(total)
        return total

    def simulate(self, particles: Sequence[Particle], seed: int
                 ) -> Optional[PropagationResult]:
        """Particles -> propagation result (per-DOM hit-time histograms).
        The I3CLSimMakePhotons equivalent."""
        rng = np.random.default_rng(seed)
        slot_batches = self.steps_from_particles(particles, rng)
        if not slot_batches:
            return None
        return self.run_steps(slot_batches, seed)

    def simulate_hits(self, *args, **kwargs):
        raise NotImplementedError(RECORDS_ITEM)

    def simulate_photons(self, *args, **kwargs):
        raise NotImplementedError(RECORDS_ITEM)

    def simulate_hits_from_photons(self, *args, **kwargs):
        raise NotImplementedError(RECORDS_ITEM)
