"""Closed-loop event streams through EventPipeline.process.

Each call hands the mix's fixed set of events (sources/<source>.py's
pool), in an order drawn from the run's seed, to one EventPipeline and
waits for every event's result; the next call starts when it returns.
photons_per_s is the photons generated by every event returned, over the
whole window.  One event of each call, drawn from the seed, is kept for
the correctness check (reference/stream_check.py).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark import roofline
from benchmark.reference import stream_check as SC
from benchmark.world import PROGRAM, program_world, reference_world


class Driver:
    kind = "stream"

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.src = ctx.source()
        self.pool = self.src.pool(self.tr, ctx.config)
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [ctx.seed, 1]))
        self.kept = []
        self.photons = 0.0
        self.events = 0
        self.failed = 0
        self.batches0 = 0

    # -- set-up and the timed calls -----------------------------------------

    def set_up(self):
        from clsim_tpu_torch.parallel.pipeline import EventPipeline
        ctx = self.ctx
        self.world = program_world(ctx.config, ctx.device)
        self.sources = [self.src.sources(PROGRAM, self.world, d)
                        for d in self.pool]
        self.pipe = EventPipeline(self.world.sim,
                                  max_in_flight=self.tr["max_in_flight"])
        # warm-up: the kernels, the native sampler, the pipeline's thread
        # and the host's buffers on the first `warmup_events` of the pool
        # (a whole call's: calls after a shorter warm-up ran up to 1.8x
        # slower than the later ones)
        warm = self.sources[:self.tr["warmup_events"]]
        self.pipe.process(warm, seed=int(self.rng.integers(2 ** 62)))
        self.batches0 = self.pipe.stats.as_dict()["NumKernelCalls"]

    def call(self, i: int):
        order = self.rng.permutation(len(self.pool))
        seed = int(self.rng.integers(2 ** 62))
        keep = int(self.rng.integers(len(order)))
        results = self.pipe.process([self.sources[j] for j in order],
                                    seed=seed)
        for r in results:
            self.photons += r.n_generated
            self.events += 1
            if (not np.isfinite(r.hist).all()
                    or sum(r.per_particle.values()) != r.n_generated):
                self.failed += 1
        r = results[keep]
        self.kept.append(dict(desc=self.pool[order[keep]], hist=r.hist,
                              gen=r.n_generated, hits=r.n_hits,
                              call=i, seed=seed))

    def counts(self):
        return self.events, self.failed

    def end_to_end(self, window: float, calls: int) -> dict:
        return {"photons_per_s": self.photons / window}

    # -- per-layer data ---------------------------------------------------

    def host_split(self):
        """Seconds per photon of the conversion (the generators' convert)
        and of the slot assignment, on the first `host_sample_events`
        events of the pool, on the host clock (chip_smoke's host_split)."""
        from clsim_tpu_torch.sources.particles import FlasherPulse
        from clsim_tpu_torch.sources.ppc import assign_steps_to_slots
        from clsim_tpu_torch.types import StepBatch
        sim = self.world.sim
        rng = np.random.default_rng(np.random.SeedSequence([self.ctx.seed,
                                                            2]))
        conv = assign = photons = 0.0
        for srcs in self.sources[:self.tr["host_sample_events"]]:
            t0 = time.perf_counter()
            batches = []
            for i, s in enumerate(srcs):
                gen = (sim.flasher_generator if isinstance(s, FlasherPulse)
                       else sim.step_generator)
                batches.extend(gen.convert(s, i, rng))
            merged = StepBatch.concatenate(batches)
            t1 = time.perf_counter()
            assign_steps_to_slots(merged, sim.config.n_slots)
            t2 = time.perf_counter()
            conv += t1 - t0
            assign += t2 - t1
            photons += float(np.asarray(merged.num_photons).sum())
        return conv / photons, assign / photons

    def layer_data(self, summary: dict, window: float, calls: int) -> dict:
        cfg = self.world.config
        k1 = sum(s for n, s in summary["kernel_s"].items()
                 if "propagate_kernel" in n)
        batches = self.pipe.stats.as_dict()["NumKernelCalls"] - self.batches0
        conv, assign = self.host_split()
        ops, nbytes, bound = roofline.k1_work(
            self.ctx.config, self.world, self.photons, batches)
        return dict(driver=self.kind, busy_s=summary["busy_s"],
                    window_s=window, photons=self.photons, k1_s=k1,
                    k1_ops=ops, k1_bytes=nbytes, k1_bound=bound,
                    convert_s_per_photon=conv, assign_s_per_photon=assign,
                    launches=summary["launches"], n_slots=cfg.n_slots)

    # -- correctness --------------------------------------------------------

    def release(self):
        import torch
        self.lost = sum(self.pipe.stats.as_dict()[k] for k in (
            "TotalNumHitsDropped", "TotalNumPhotonsAbandoned"))
        del self.pipe, self.world, self.sources
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The kept events to check: `check_events` of them, drawn from the
        seed."""
        n = min(self.tr["check_events"], len(self.kept))
        pick = np.random.default_rng(np.random.SeedSequence(
            [self.ctx.seed, 3])).choice(len(self.kept), n, replace=False)
        return [self.kept[k] for k in sorted(pick)]

    def check(self) -> list:
        ctx = self.ctx
        world = reference_world(ctx.config, ctx.device)
        zs = []
        for ev in self.sample():
            ref = SC.reference_event(world, self.src, ev["desc"],
                                     ev["seed"] % (2 ** 62),
                                     self.tr["check_photons"], ctx.device)
            zs.append(SC.event_z(ev["hist"], ev["gen"], ev["hits"], ref))
            print(f"event {ev['call']}: {SC.summary(zs[-1])}",
                  file=sys.stderr)
        return judge(zs, self.tr["limits"], self.lost)


def judge(zs: list, limits: dict, lost: float) -> list:
    """[(name, value, limit)] of the checked events' z (event_z)."""
    shift, lowest = SC.placement(zs)
    return [("pooled_z", SC.pooled_z(zs), limits["pooled_z"]),
            ("weight_shift", shift, limits["weight_shift"]),
            ("lowest_z", lowest, limits["lowest_z"]),
            ("lost_photons", float(lost), 0.0)]
