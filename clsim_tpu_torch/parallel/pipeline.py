"""Event-level orchestration: a stream of events (particle and flasher
lists) through the propagation with bounded in-flight device work
(PyTorch counterpart of clsim_tpu.parallel.pipeline).

The reference runs feeder and harvester threads around a bounded queue
(I3CLSimModule / I3CLSimClientModule, I3CLSimQueue).  Here one host loop
prepares each event's slot batches (numpy), hands them to propagate_auto
and harvests the results in submission order, holding at most
`max_in_flight` results on the device before it reads the oldest back.
Events stay attributed through the step identifier, event k's source i
carrying k * IDENT_STRIDE + i (the reference's particleCache,
I3CLSimModule.cxx:1039-1296).

Two choices differ from the JAX pipeline:
  * dispatch goes through propagate_auto with the Simulation's `backend`
    and `fused_opts`, as Simulation.run_steps does (the JAX pipeline drops
    both, clsim_tpu/parallel/pipeline.py:151-152), and batch k draws from
    the seed SeedSequence([seed, k]), as run_steps' batches do;
  * the device time of a batch is the span between two CUDA events
    recorded on the current stream before and after its propagate_auto
    (on CPU tensors, the host time of that call).  The fused call loop
    reads each launch's alive count, so a batch's kernels have ended when
    propagate_auto returns; the span includes the host's table building
    between the events, so it bounds the device's busy time from above.
    The JAX pipeline estimates it from the gaps between completions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..convert import steps_from_numpy
from ..ops.spectrum import check_source_types, source_type_range
from ..propagate.dispatch import check_diagnostics, propagate_auto
from ..sources.particles import FlasherPulse
from ..sources.ppc import assign_steps_to_slots
from ..types import StepBatch
from ..util.stats import RunStatistics

IDENT_STRIDE = 65536   # identifier = event * IDENT_STRIDE + source index


@dataclasses.dataclass
class EventResult:
    event_id: int
    hist: np.ndarray
    n_generated: float
    n_hits: float
    weight_hits: float
    per_particle: Dict[int, float]   # identifier -> generated photons


def batch_seed(seed: int, k: int) -> int:
    """The seed of the pipeline's k-th slot batch (Simulation.run_steps'
    rule)."""
    return int(np.random.SeedSequence([int(seed), int(k)]).generate_state(
        1, np.uint64)[0] & np.uint64(2 ** 63 - 1))


class EventPipeline:
    """Processes a stream of events with bounded in-flight device work.

    `max_in_flight` plays the role of the reference's bounded queue depth
    (queueToOpenCL_ size 5, I3CLSimStepToPhotonConverterOpenCL.cxx:77): at
    most that many batches' results wait on the device for harvest."""

    def __init__(self, simulation, max_in_flight: int = 4):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be at least 1")
        self.sim = simulation
        self.max_in_flight = max_in_flight
        self.stats = RunStatistics()

    def prepare(self, events: Sequence[Sequence], rng: np.random.Generator):
        """[(event_id, slot_batches, per_particle)] on the host: flasher
        pulses through sim.flasher_generator, particles through
        sim.step_generator, event k's source i with identifier
        k * IDENT_STRIDE + i; per_particle counts each identifier's
        photons."""
        sim = self.sim
        n_tables = int(sim.spectra.x.shape[0])
        prepared = []
        for ev_id, sources in enumerate(events):
            batches, per_particle = [], {}
            for i, src in enumerate(sources):
                ident = ev_id * IDENT_STRIDE + i
                gen = (sim.flasher_generator if isinstance(src, FlasherPulse)
                       else sim.step_generator)
                for b in gen.convert(src, ident, rng):
                    per_particle[ident] = per_particle.get(ident, 0) + int(
                        np.asarray(b.num_photons).sum())
                    batches.append(b)
            slot_batches = []
            if batches:
                merged = StepBatch.concatenate(batches)
                check_source_types(*source_type_range(merged.source_type),
                                   n_tables)
                slot_batches = assign_steps_to_slots(merged,
                                                     sim.config.n_slots)
            prepared.append((ev_id, slot_batches, per_particle))
        return prepared

    def process(self, events: Sequence[Sequence], seed: int
                ) -> List[EventResult]:
        """Run all events; returns one result per event in submission order
        (the FlushFrameCache contract: results reassembled per event
        through the identifiers)."""
        sim = self.sim
        prepared = self.prepare(events, np.random.default_rng(seed))
        results = {ev_id: EventResult(
            event_id=ev_id,
            hist=np.zeros((sim.geometry.n_doms, sim.config.hist_n_bins),
                          np.float32),
            n_generated=0.0, n_hits=0.0, weight_hits=0.0,
            per_particle=per_particle)
            for ev_id, _, per_particle in prepared}
        in_flight = []   # (event_id, result, host t0, device-time thunk)

        def harvest(entry):
            ev_id, res, t0, device_time = entry
            hist = res.hist.cpu().numpy()     # sync point
            diag = check_diagnostics(res) or {}
            host_t = time.perf_counter() - t0
            r = results[ev_id]
            r.hist = r.hist + hist
            r.n_generated += float(res.n_generated)
            r.n_hits += float(res.n_hits)
            r.weight_hits += float(res.weight_hits)
            self.stats.record(float(res.n_generated), float(res.n_hits),
                              float(res.weight_hits), device_time(), host_t,
                              n_dropped=diag.get("dropped", 0.0),
                              n_abandoned=diag.get("abandoned", 0.0))

        k = 0
        for ev_id, slot_batches, _ in prepared:
            for batch in slot_batches:
                steps = steps_from_numpy(batch._asdict(), sim.device)
                t0 = time.perf_counter()
                cuda = steps.x.device.type == "cuda"
                if cuda:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                res = propagate_auto(steps, sim.medium, sim.geometry,
                                     sim.spectra, batch_seed(seed, k),
                                     sim.config, backend=sim.backend,
                                     **sim.fused_opts)
                k += 1
                if cuda:
                    ev[1].record()
                    device_time = (lambda e=ev: e[0].elapsed_time(e[1])
                                   * 1e-3)
                else:
                    dt = time.perf_counter() - t0
                    device_time = lambda dt=dt: dt
                in_flight.append((ev_id, res, t0, device_time))
                if len(in_flight) >= self.max_in_flight:
                    harvest(in_flight.pop(0))
        while in_flight:
            harvest(in_flight.pop(0))
        return [results[k] for k in sorted(results)]
