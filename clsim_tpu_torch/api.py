"""High-level user API (PyTorch counterpart of clsim_tpu.api): the
equivalent of the reference's tray segments I3CLSimMakePhotons /
I3CLSimMakeHits.

    sim = Simulation(medium=..., geometry=..., config=..., device="cuda")
    result = sim.simulate(particles, seed=1234)   # per-DOM hit histograms
    doms, times, ids = sim.simulate_hits(particles, 42)   # MCPEs
                                    # (needs config.save_photons=True)

Wiring contract (I3CLSimMakePhotons.py:370-430, common.py setupDetector):
  * wavelength generation bias = DOM acceptance evaluated at radius
    R*oversize with efficiency = icemodel_eff * unshadowed * holeice peak
    * 1.35 * 1.01
  * PPC parameterization converts particles to steps (photons_per_step=200)
  * pancake factor = oversize
  * MCPE conversion divides the bias back out via the saved weights

The medium and geometry tensors must live on `device`.

Over several ranks (one process per GPU, parallel/bootstrap.py) every rank
builds the same Simulation with mesh=global_photon_mesh() and calls
simulate with the same particles and seed: each converts them alike,
propagates its slot slice and returns the all-reduced result:

    initialize_distributed()          # torchrun's environment
    sim = Simulation(medium, geometry, config, mesh=global_photon_mesh())
    result = sim.simulate(particles, seed=1234)   # the same on every rank
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .convert import steps_from_numpy
from .geometry import DetectorGeometry, advise_strings_per_photon, to_numpy
from .hits.acceptance import (HOLE_ICE_H2_50CM, dom_angular_sensitivity,
                              icecube_dom_acceptance)
from .hits.mcpe import (check_photon_positions, mcpes_to_numpy, merge_mcpes,
                        sample_mcpes, sample_mcpes_from_batch)
from .hits.photons import (compact_records, load_photons_npz,
                           photon_batch_dom_index, records_to_photon_batch,
                           save_photons_npz)
from .medium.properties import MediumProperties
from .ops import rng as RNG
from .ops.spectrum import (WavelengthSpectrum, check_source_types,
                           make_cherenkov_spectrum, source_type_range,
                           stack_spectra)
from .parallel.mesh import make_sharded_propagate, shard_steps
from .parallel.pipeline import batch_seed, propagate_batch
from .propagate.dispatch import check_diagnostics
from .propagate.engine import PropagationResult
from .sources.convert import (MuonSlicerPropagator, SourceConverter,
                              default_parameterizations)
from .sources.flasher import FlasherStepGenerator, bias_flasher_spectrum
from .sources.particles import Particle
from .sources.ppc import PPCStepGenerator, assign_steps_to_slots
from .types import PropagationConfig, StepBatch

# salt of the MCPE sampler's seed: (seed, "MCPE") as in the JAX package
MCPE_SALT = 0x4d435045


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
                 use_native: bool = True,
                 device=None):
        self.medium = medium
        self.geometry = geometry
        self.backend = backend
        self.mesh = mesh
        if device is None:
            device = medium.device if mesh is None else mesh.device
        self.device = device
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
                efficiency=eff, device=self.device)
            nb = acc.values.shape[0]
            bias_x = float(acc.first_x) + float(acc.dx) * np.arange(nb)
            bias_y = to_numpy(acc.values)
        self._bias_x, self._bias_y = bias_x, bias_y

        cherenkov = make_cherenkov_spectrum(
            medium.ref_index, medium.min_wlen, medium.max_wlen,
            bias_wlen_nm=bias_x, bias_values=bias_y)
        self.cherenkov = cherenkov
        # every hit weight is divided by the bias, so the LED spectra are
        # sampled with it too and a pulse's photon count is scaled by its
        # spectrum's correction factor (stacked index i + 1); unweighted,
        # the spectra stay as given and every factor is 1
        biased = [bias_flasher_spectrum(s, bias_x, bias_y)
                  for s in flasher_spectra]
        self.spectra = stack_spectra([cherenkov, *(s for s, _ in biased)],
                                     device=self.device)

        self.step_generator = PPCStepGenerator(
            medium, cherenkov, photons_per_step=photons_per_step,
            use_cascade_extension=use_cascade_extension,
            use_native=use_native)
        self.flasher_generator = FlasherStepGenerator(
            cherenkov, correction_factors={i + 1: f for i, (_, f)
                                           in enumerate(biased)})
        if propagators is None:
            propagators = [MuonSlicerPropagator()]
        self.source_converter = SourceConverter(
            default_parameterizations(self.step_generator,
                                      self.flasher_generator),
            propagators=propagators)

        # MCPE acceptance: evaluated at the *true* DOM radius; dividing the
        # bias (oversized-radius acceptance) back out of the weights leaves
        # the residual ratio <= 1 (I3CLSimMakeHitsFromPhotons.py wiring)
        self.wlen_acceptance = icecube_dom_acceptance(
            dom_radius=geometry.om_radius * geometry.oversize, efficiency=1.0,
            device=self.device)
        self.angular_coeffs = dom_angular_sensitivity(device=self.device)

        self._propagate = None
        if mesh is not None:
            # the sharded path serves the kernel whenever the configuration
            # supports it; make_sharded_propagate records backend and
            # backend_reason, and refuses save_photons (ROADMAP C2)
            fopts = dict(self.fused_opts)
            max_calls = fopts.pop("max_calls", 256)
            self._propagate = make_sharded_propagate(
                mesh, cfg, backend=backend, medium=medium, geo=geometry,
                spectra=self.spectra, max_calls=max_calls, **fopts)

    # ------------------------------------------------------------------
    def steps_from_particles(self, particles: Sequence[Particle],
                             rng: np.random.Generator) -> List[StepBatch]:
        """Light sources -> slot-assigned host step batches through the
        conversion queue (sources/convert.py); on a mesh, batches of
        n_slots slots for each rank."""
        batches = self.source_converter.convert(
            [(p, ident) for ident, p in enumerate(particles)], rng)
        if not batches:
            return []
        n_slots = self.config.n_slots
        if self.mesh is not None:
            n_slots *= self.mesh.size
        return assign_steps_to_slots(StepBatch.concatenate(batches), n_slots)

    def run_steps(self, slot_batches: List[StepBatch], seed: int
                  ) -> Optional[PropagationResult]:
        """Propagate pre-assigned slot batches; accumulates over batches.
        Batch i goes through pipeline.propagate_batch, its random stream
        seeded from (seed, i) with numpy's SeedSequence (batch_seed); on a
        mesh, by the threefry key fold_in(PRNGKey(seed), i), as the JAX
        package keys it, and each rank propagates its slot slice of every
        batch (parallel/mesh.shard_steps).

        With config.save_photons the records of every batch are kept,
        compacted to the flat (1, R) contract and concatenated.  (The JAX
        package's run_steps keeps only the last batch's records,
        clsim_tpu/api.py:184-186, so a multi-batch simulate_hits there
        undercounts; the port does not.)"""
        total, records = None, []
        for i, batch in enumerate(slot_batches):
            # a source_type without a stacked spectrum, on the host steps
            check_source_types(*source_type_range(batch.source_type),
                               int(self.spectra.x.shape[0]))
            if self._propagate is not None:
                res = self._propagate(
                    shard_steps(batch, self.mesh), self.medium,
                    self.geometry, self.spectra,
                    RNG.fold_in(RNG.base_key(seed), i))
            else:
                res = propagate_batch(
                    self, steps_from_numpy(batch._asdict(), self.device),
                    seed, i)
            if res.rec is not None:
                records.append(compact_records(res.rec, res.rec_count))
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
            if records:
                total = total._replace(
                    rec={k: torch.cat([r[k] for r, _ in records], 1)
                         for k in records[0][0]},
                    rec_count=sum(c for _, c in records))
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

    def _mcpe_generator(self, seed: int) -> torch.Generator:
        """The MCPE sampler's generator, seeded from (seed, MCPE_SALT) by
        the batch-seed rule."""
        g = torch.Generator(device=self.device)
        g.manual_seed(batch_seed(seed, MCPE_SALT))
        return g

    def simulate_hits(self, particles: Sequence[Particle], seed: int,
                      dom_efficiency: float = 1.0,
                      per_dom_efficiency=None,
                      merge_window_ns: Optional[float] = None):
        """Particles -> (dom_indices, times, identifiers) MCPE arrays or,
        with a merge window, (dom, time, npe, identifier).  The
        I3CLSimMakeHits equivalent (requires save_photons=True config).

        `per_dom_efficiency` is an optional (n_doms,) calibration vector
        (RDE x SPE compensation, I3PhotonToMCPEConverter.cxx:340-387);
        `merge_window_ns` enables the reference's optional hit
        time-merging (…cxx:520+)."""
        if not self.config.save_photons:
            raise ValueError("simulate_hits requires config.save_photons=True")
        res = self.simulate(particles, seed)
        if res is None:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros(0, np.int32))
        if (self.config.pancake_factor == 1.0
                and not self.config.save_all_photons):
            # spherical-DOM sanity check (I3PhotonToMCPEConverter.cxx:415-455)
            check_photon_positions(res.rec, res.rec_count,
                                   self.geometry.collision_radius,
                                   self.config.pancake_factor)
        mcpes = sample_mcpes(res.rec, res.rec_count,
                             self._mcpe_generator(seed),
                             self.wlen_acceptance, self.angular_coeffs,
                             efficiency=dom_efficiency,
                             dom_efficiency=per_dom_efficiency)
        dom, t, ident = mcpes_to_numpy(mcpes)
        if merge_window_ns is not None:
            return merge_mcpes(dom, t, ident, merge_window_ns)
        return dom, t, ident

    # -- two-phase flow (MakePhotons -> file -> MakeHitsFromPhotons,
    #    python/traysegments/I3CLSimMakeHitsFromPhotons.py:55) -----------
    def simulate_photons(self, particles: Sequence[Particle], seed: int,
                         save_path=None):
        """Particles -> PhotonBatch (host numpy arrays) with detector
        (string_id, om_id) pairs remapped from flat device indices on
        download (I3CLSimStepToPhotonConverterOpenCL.cxx:1563-1614).
        Optionally persists to `save_path` (npz): the I3CLSimMakePhotons
        half."""
        if not self.config.save_photons:
            raise ValueError(
                "simulate_photons requires config.save_photons=True")
        res = self.simulate(particles, seed)
        if res is None:
            raise ValueError("no light sources produced steps")
        batch = records_to_photon_batch(res.rec, res.rec_count, self.geometry)
        if save_path is not None:
            save_photons_npz(save_path, batch)
        return batch

    def simulate_hits_from_photons(self, photons, seed: int,
                                   dom_efficiency: float = 1.0,
                                   per_dom_efficiency=None,
                                   merge_window_ns: Optional[float] = None):
        """PhotonBatch (or npz path) -> MCPE arrays: the
        I3CLSimMakeHitsFromPhotons half, runnable later / elsewhere against
        saved photon records."""
        if isinstance(photons, (str, bytes)) or hasattr(photons, "__fspath__"):
            photons = load_photons_npz(photons)
        dom_index = photon_batch_dom_index(photons, self.geometry)
        mcpes = sample_mcpes_from_batch(
            photons, dom_index, self._mcpe_generator(seed),
            self.wlen_acceptance, self.angular_coeffs,
            efficiency=dom_efficiency, dom_efficiency=per_dom_efficiency)
        dom, t, ident = mcpes_to_numpy(mcpes)
        if merge_window_ns is not None:
            return merge_mcpes(dom, t, ident, merge_window_ns)
        return dom, t, ident
