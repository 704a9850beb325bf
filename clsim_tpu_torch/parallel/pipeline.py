"""Event-level orchestration: a stream of events (particle and flasher
lists) through the propagation with bounded in-flight device work
(PyTorch counterpart of clsim_tpu.parallel.pipeline).

The reference runs feeder and harvester threads around a bounded queue
(I3CLSimModule / I3CLSimClientModule, I3CLSimQueue; SURVEY §2.9), and the
JAX pipeline gets its overlap from asynchronous dispatch: its call loop is
a device-side while loop, so the device works on batch k while the host
prepares batch k+1.  The port's call loop reads each launch's alive count
on the host, so propagate_auto returns only when its kernels have ended;
the overlap therefore comes from a thread.  `process` gives each slot
batch's propagation and harvest to one worker thread, the harvester, while
the calling thread, the feeder, converts the next events (the step and
flasher generators), assigns their slots and copies their batches to the
device, at most `max_in_flight` batches ahead in a bounded queue.  The
feeder alone draws from the one np.random.Generator, event by event in
submission order, so every event's steps are the ones a synchronous run
makes, bit for bit; results come back in submission order.  On CUDA the
feeder copies on a side stream and the propagating stream waits on a CUDA
event recorded after the copy (no host sync orders them).  With
`max_in_flight=1` there is no thread: the feeder propagates and harvests
each batch itself as soon as it has copied it (the synchronous loop).
An exception on the harvester is raised again from `process` with its
traceback, and the thread is joined before `process` returns or raises.
Events stay attributed through the step identifier, event k's source i
carrying k * IDENT_STRIDE + i (the reference's particleCache,
I3CLSimModule.cxx:1039-1296).

Two choices differ from the JAX pipeline:
  * dispatch goes through propagate_batch, as Simulation.run_steps' does:
    propagate_auto with the Simulation's `backend` and `fused_opts` (the
    JAX pipeline drops both, clsim_tpu/parallel/pipeline.py:151-152),
    batch k drawing from the seed SeedSequence([seed, k]);
  * device time: a batch's span runs from a CUDA event recorded before its
    propagate_auto to one recorded after it, on the harvester's stream (on
    CPU tensors, the host clock around that call), and every span is read
    against one reference event recorded when `process` starts.
    RunStatistics gets, for batch k, the part of its span that no earlier
    span covers as device time and the wall from the previous harvest (the
    start of `process` for k = 0) to its harvest as host time, so that its
    DeviceUtilization is the union of the spans on the card over the wall
    of `process` from its start to the last harvest (the host's
    preparation included, in either mode), at most 1.
    A span includes the host's table building between its events, so it
    bounds the device's busy time from above.  The JAX pipeline estimates
    device time from the gaps between completions.

While a torch.profiler runs on the calling thread, or inside
util/profiling.recording(), `process` records the program's spans
(util/profiling.span): on the feeder an "event" span per event (its
conversion, "convert", and slot assignment, "assign", then its batches'
copies and hand-over) and the "photons" counter; on the harvester
"queue_wait" (waiting for the feeder) and a "batch" span per slot batch,
with the call loop's "plan" and "repack" under it (with max_in_flight=1
the "batch" spans are the feeder's, inside their event's span); on both a
"wait" span at each host read of a device value, by site.  Spans carry the event's
identifier and, on the harvester, the batch index k; a "merge" span covers
the feeder's sum of the batches into the events' results at the end.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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
from ..util import profiling as P
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
    """The seed of a call's k-th slot batch (Simulation.run_steps' and
    EventPipeline's rule)."""
    return int(np.random.SeedSequence([int(seed), int(k)]).generate_state(
        1, np.uint64)[0] & np.uint64(2 ** 63 - 1))


def propagate_batch(sim, steps: StepBatch, seed: int, k: int):
    """A call's k-th slot batch (its steps on the device) through
    propagate_auto with the Simulation's `backend` and `fused_opts`, seeded
    batch_seed(seed, k): Simulation.run_steps off a mesh and EventPipeline
    both propagate here."""
    return propagate_auto(steps, sim.medium, sim.geometry, sim.spectra,
                          batch_seed(seed, k), sim.config,
                          backend=sim.backend, **sim.fused_opts)


class _Harvester:
    """One worker thread that runs `work` on each submitted item in
    submission order, at most `depth` items waiting in its queue; outputs
    keeps the results in that order.  An exception of `work` is kept in
    `error` (the items after it are skipped) for the caller to raise."""

    def __init__(self, work, depth: int):
        self._work, self._cancel = work, False
        self._queue = queue.Queue(maxsize=depth)
        self.outputs, self.error = [], None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="EventPipeline-harvester")
        self._thread.start()

    def _run(self):
        while True:
            with P.span("queue_wait") as sp:
                item = self._queue.get()
                if item is not None:
                    sp.set(event=item[0], batch=item[1])
            if item is None:
                return
            if self.error is not None or self._cancel:
                continue
            try:
                self.outputs.append(self._work(item))
            except BaseException as err:   # raised again by the caller
                self.error = err

    def submit(self, item):
        """Queue an item (blocks while `depth` wait); raises the worker's
        exception if it has failed."""
        if self.error is not None:
            raise self.error
        self._queue.put(item)

    def close(self, cancel: bool):
        """Let the worker finish the queue (or skip it, `cancel`) and join
        it."""
        self._cancel = cancel
        self._queue.put(None)
        self._thread.join()


class _Inline:
    """_Harvester's interface on the calling thread (max_in_flight=1): each
    item's work runs, or raises, when it is submitted."""

    def __init__(self, work):
        self._work, self.outputs, self.error = work, [], None

    def submit(self, item):
        self.outputs.append(self._work(item))

    def close(self, cancel: bool):
        pass


class EventPipeline:
    """Processes a stream of events with bounded in-flight device work.

    `max_in_flight` plays the role of the reference's bounded queue depth
    (queueToOpenCL_ size 5, I3CLSimStepToPhotonConverterOpenCL.cxx:77): the
    host prepares and copies up to that many batches ahead of the one the
    harvester propagates; 1 runs the synchronous loop, with no thread."""

    def __init__(self, simulation, max_in_flight: int = 4):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be at least 1")
        self.sim = simulation
        self.max_in_flight = max_in_flight
        self.stats = RunStatistics()

    def _prepare_event(self, ev_id: int, sources, rng: np.random.Generator):
        """(event_id, slot_batches, per_particle) of one event (see
        prepare)."""
        sim = self.sim
        batches, per_particle = [], {}
        with P.span("convert"):
            for i, src in enumerate(sources):
                ident = ev_id * IDENT_STRIDE + i
                gen = (sim.flasher_generator if isinstance(src, FlasherPulse)
                       else sim.step_generator)
                for b in gen.convert(src, ident, rng):
                    per_particle[ident] = per_particle.get(ident, 0) + int(
                        np.asarray(b.num_photons).sum())
                    batches.append(b)
        P.count("photons", sum(per_particle.values()), event=ev_id)
        slot_batches = []
        if batches:
            with P.span("assign"):
                merged = StepBatch.concatenate(batches)
                check_source_types(*source_type_range(merged.source_type),
                                   int(sim.spectra.x.shape[0]))
                slot_batches = assign_steps_to_slots(merged,
                                                     sim.config.n_slots)
        return ev_id, slot_batches, per_particle

    def prepare(self, events: Sequence[Sequence], rng: np.random.Generator):
        """[(event_id, slot_batches, per_particle)] on the host: flasher
        pulses through sim.flasher_generator, particles through
        sim.step_generator, event k's source i with identifier
        k * IDENT_STRIDE + i; per_particle counts each identifier's
        photons; each event in an "event" span."""
        out = []
        for ev_id, sources in enumerate(events):
            with P.span("event", event=ev_id):
                out.append(self._prepare_event(ev_id, sources, rng))
        return out

    def process(self, events: Sequence[Sequence], seed: int
                ) -> List[EventResult]:
        """Run all events; returns one result per event in submission order
        (the FlushFrameCache contract: results reassembled per event
        through the identifiers).  Spans and counters are recorded while
        a torch.profiler runs on the calling thread (profiling's
        follow_profiler), on the harvester's thread too."""
        with P.follow_profiler():
            return self._process(events, seed)

    def _process(self, events, seed):
        sim = self.sim
        n_tables = int(sim.spectra.x.shape[0])
        # a pulse without its stacked spectrum is refused before any batch
        # is dispatched
        for sources in events:
            for src in sources:
                if isinstance(src, FlasherPulse):
                    check_source_types(int(src.spectrum_index),
                                       int(src.spectrum_index), n_tables)
        rng = np.random.default_rng(seed)
        results: Dict[int, EventResult] = {}
        cuda = torch.device(sim.device).type == "cuda"
        # the start: host time and the spans' reference event
        clock = dict(t0=time.perf_counter())
        if cuda:
            clock["ref"] = torch.cuda.Event(enable_timing=True)
            clock["ref"].record()

        def work(item):
            """Propagate one batch and read it back (a sync): the
            harvester's job, or the feeder's own with max_in_flight=1."""
            ev_id, k, steps, ready = item
            with P.span("batch", event=ev_id, batch=k):
                if cuda:
                    stream = torch.cuda.current_stream(steps.x.device)
                    stream.wait_event(ready)
                    for t in steps:
                        t.record_stream(stream)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record(stream)
                t_start = time.perf_counter()
                res = propagate_batch(sim, steps, seed, k)
                t_end = time.perf_counter()
                if cuda:
                    ev[1].record(stream)
                with P.wait("hist"):
                    hist = res.hist.cpu().numpy()     # sync point
                diag = check_diagnostics(res) or {}
                if cuda:
                    span = (clock["ref"].elapsed_time(ev[0]) * 1e-3,
                            clock["ref"].elapsed_time(ev[1]) * 1e-3)
                else:
                    span = (t_start - clock["t0"], t_end - clock["t0"])
                with P.wait("counts", 3):
                    counts = (float(res.n_generated), float(res.n_hits),
                              float(res.weight_hits))
                return dict(ev_id=ev_id, hist=hist, counts=counts,
                            lost=(diag.get("dropped", 0.0),
                                  diag.get("abandoned", 0.0)),
                            span=span, harvested=time.perf_counter())

        outputs = self._feed(events, rng, results, work, cuda)
        with P.span("merge"):
            self._merge(outputs, results, clock)
        return [results[k] for k in sorted(results)]

    def _feed(self, events, rng, results, work, cuda):
        """The feeder loop: each event prepared in turn on this thread, its
        result opened, its batches copied (_to_device) and handed over, to
        the harvester or, with max_in_flight=1, run here at once; returns
        the outputs of `work` in submission order."""
        sim = self.sim
        copy_stream = torch.cuda.Stream(sim.device) if cuda else None

        def harvest(item):
            if cuda:   # the kernels launch on the thread's current device
                torch.cuda.set_device(item[2].x.device)
            return work(item)

        sink = (_Inline(work) if self.max_in_flight == 1
                else _Harvester(harvest, self.max_in_flight))
        failed = True
        try:
            k = 0
            for ev_id, sources in enumerate(events):
                with P.span("event", event=ev_id):
                    _, slot_batches, per_particle = self._prepare_event(
                        ev_id, sources, rng)
                    results[ev_id] = EventResult(
                        event_id=ev_id, hist=np.zeros(
                            (sim.geometry.n_doms, sim.config.hist_n_bins),
                            np.float32),
                        n_generated=0.0, n_hits=0.0, weight_hits=0.0,
                        per_particle=per_particle)
                    for batch in slot_batches:
                        sink.submit((ev_id, k,
                                     *self._to_device(batch, copy_stream)))
                        k += 1
            failed = False
        finally:
            sink.close(cancel=failed)
        if sink.error is not None:
            raise sink.error
        return sink.outputs

    def _to_device(self, batch: StepBatch, copy_stream):
        """(steps, ready): a host slot batch's steps on the Simulation's
        device, copied under a "steps_h2d" wait, on CUDA on `copy_stream`
        with `ready` the CUDA event recorded after the copy (else None)."""
        with torch.cuda.stream(copy_stream):
            with P.wait("steps_h2d", len(batch)):
                steps = steps_from_numpy(batch._asdict(), self.sim.device)
            if copy_stream is None:
                return steps, None
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return steps, ready

    def _merge(self, outputs, results, clock):
        """Add each batch's output to its event's result and to
        RunStatistics, in submission order (device time: the part of its
        span no earlier span covers; host time: the wall since the last
        harvest; see the module docstring)."""
        covered, last = 0.0, clock["t0"]
        for out in outputs:
            r = results[out["ev_id"]]
            r.hist = r.hist + out["hist"]
            gen, hits, weight = out["counts"]
            r.n_generated += gen
            r.n_hits += hits
            r.weight_hits += weight
            start, end = out["span"]
            device_t = max(end - max(start, covered), 0.0)
            covered = max(covered, end)
            host_t = out["harvested"] - last
            last = out["harvested"]
            self.stats.record(gen, hits, weight, device_t, host_t,
                              n_dropped=out["lost"][0],
                              n_abandoned=out["lost"][1])
