"""The port's event pipeline (parallel/pipeline.EventPipeline): the JAX
package's multi-event checks (tests/test_pipeline.py) on the port, events
that mix particles and flasher pulses, each event equal to the port's
engine over that event's slot batches with the batch seeds the pipeline
used, and the dispatch through the Simulation's backend."""

import functools

import numpy as np
import pytest
import torch

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.api import Simulation
from clsim_tpu_torch.geometry import single_string_geometry
from clsim_tpu_torch.medium.properties import make_homogeneous_ice
from clsim_tpu_torch.parallel import EventPipeline
from clsim_tpu_torch.parallel.pipeline import IDENT_STRIDE, batch_seed
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.sources import Particle, ParticleType
from clsim_tpu_torch.sources.flasher import led_spectrum
from clsim_tpu_torch.sources.particles import FlasherPulse
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)


def make_sim(n_slots=1024, **kw):
    """tests/test_pipeline.py's detector with the 405 nm LED stacked."""
    return Simulation(
        medium=make_homogeneous_ice(b400=0.04, a_dust400=0.006, device="cpu"),
        geometry=single_string_geometry(n_doms=24, spacing=17.0, x=20.0,
                                        z_top=200.0, oversize=5.0,
                                        device="cpu"),
        config=PropagationConfig(n_slots=n_slots),
        flasher_spectra=[led_spectrum(405)], **kw)


def cascade(energy, z):
    return Particle.cascade(ParticleType.EMinus, (0.0, 0.0, z), 0.0, energy,
                            np.pi / 2, np.pi)


@functools.lru_cache(maxsize=None)
def led_factor():
    """The 405 nm LED's photon-number correction factor in make_sim's
    weighted Simulation (~1.85e-3, the acceptance bias near 405 nm)."""
    return make_sim(n_slots=64).flasher_generator.correction_factors[1]


def pulse(photons, z=0.0, spectrum_index=1):
    """A 405 nm flash that makes about `photons` photons: its
    num_photons_no_bias is scaled by 1 / led_factor(), since the weighted
    Simulation multiplies it by the factor."""
    return FlasherPulse(x=0.0, y=0.0, z=z, time=0.0, dir_x=1.0, dir_y=0.0,
                        dir_z=0.0, num_photons_no_bias=photons / led_factor(),
                        angular_smear_polar=0.1, angular_smear_azimuthal=0.1,
                        pulse_width=5.0, spectrum_index=spectrum_index)


def test_port_pipeline_multi_event():
    """tests/test_pipeline.py::test_pipeline_multi_event on the port."""
    sim = make_sim()
    events = [[cascade(50.0, 0.0)], [cascade(25.0, 50.0)], [],
              [cascade(75.0, -50.0)]]
    pipe = EventPipeline(sim, max_in_flight=2)
    results = pipe.process(events, seed=21)
    assert [r.event_id for r in results] == [0, 1, 2, 3]
    # photon budgets scale with energy
    assert results[0].n_generated == pytest.approx(
        2 * results[1].n_generated, rel=0.1)
    assert results[2].n_generated == 0
    # per-particle bookkeeping matches totals
    for r in results:
        assert sum(r.per_particle.values()) == pytest.approx(r.n_generated)
    d = pipe.stats.as_dict()
    assert d["NumKernelCalls"] >= 3
    assert d["TotalNumPhotonsGenerated"] == pytest.approx(
        sum(r.n_generated for r in results))


def test_mixed_events_equal_engine_runs_of_their_batches():
    """Events mixing particles and flasher pulses, several slot batches an
    event: each event's histogram and counts equal the port's engine run
    over that event's slot batches with the pipeline's batch seeds
    (SeedSequence([seed, k]) for the k-th batch of the run); identifiers
    are event * IDENT_STRIDE + source index."""
    sim = make_sim(n_slots=64)
    sim.flasher_generator.photons_per_step = 5
    events = [[cascade(3.0, 0.0), pulse(600.0)], [pulse(300.0, z=-20.0)],
              [], [cascade(4.0, 30.0)]]
    pipe = EventPipeline(sim, max_in_flight=3)
    results = pipe.process(events, seed=5)
    prepared = pipe.prepare(events, np.random.default_rng(5))
    assert len(prepared[0][1]) >= 2    # an event of several slot batches
    k = 0
    for (ev_id, batches, per_particle), r in zip(prepared, results):
        assert r.event_id == ev_id and r.per_particle == per_particle
        assert set(per_particle) == {ev_id * IDENT_STRIDE + i
                                     for i in range(len(events[ev_id]))}
        hist = np.zeros((sim.geometry.n_doms, sim.config.hist_n_bins),
                        np.float32)
        gen = hits = weight = 0.0
        for batch in batches:
            steps = C.steps_from_numpy(batch._asdict(), device="cpu")
            res = ET.propagate(steps, sim.medium, sim.geometry, sim.spectra,
                               batch_seed(5, k), sim.config)
            k += 1
            hist = hist + res.hist.numpy()
            gen += float(res.n_generated)
            hits += float(res.n_hits)
            weight += float(res.weight_hits)
        np.testing.assert_array_equal(r.hist, hist)
        assert (r.n_generated, r.n_hits, r.weight_hits) == (gen, hits,
                                                            weight)
        assert gen == sum(per_particle.values())
    assert results[0].n_hits > 0 and results[2].n_generated == 0
    assert pipe.stats.num_kernel_calls == k


def test_pipeline_dispatches_through_the_simulation_backend():
    """backend='fused' (the kernel's call loop; its plain version on CPU
    tensors) with the Simulation's fused_opts: the counters reach
    RunStatistics (nothing dropped or abandoned)."""
    sim = make_sim(n_slots=256, backend="fused",
                   fused_opts=dict(iters_per_call=64))
    pipe = EventPipeline(sim, max_in_flight=1)
    results = pipe.process([[pulse(3000.0)], [cascade(10.0, 0.0)]], seed=3)
    d = pipe.stats.as_dict()
    assert d["TotalNumPhotonsGenerated"] == sum(r.n_generated
                                                for r in results) > 0
    assert d["TotalNumHitsDropped"] == d["TotalNumPhotonsAbandoned"] == 0
    assert d["TotalDeviceTime"] > 0 and d["TotalHostTime"] > 0


def test_pipeline_refuses_a_pulse_without_its_spectrum():
    """A pulse whose spectrum_index has no stacked spectrum is refused on
    the host before any batch is dispatched; max_in_flight must be >= 1."""
    sim = make_sim()
    with pytest.raises(ValueError, match="stack the LED spectrum"):
        EventPipeline(sim).process([[pulse(500.0, spectrum_index=2)]],
                                   seed=1)
    with pytest.raises(ValueError, match="max_in_flight"):
        EventPipeline(sim, max_in_flight=0)


def test_run_statistics_match_jax():
    """util/stats.RunStatistics is a copy of the JAX package's: the same
    records give the same statistic keys and values."""
    from clsim_tpu.util.stats import RunStatistics as StatsJ
    from clsim_tpu_torch.util.stats import RunStatistics as StatsT
    sj, st = StatsJ(), StatsT()
    for s in (sj, st):
        s.record(1.5e6, 300, 250.5, 0.02, 0.05)
        s.record(2.5e6, 700, 640.0, 0.03, 0.04, n_dropped=2.0,
                 n_abandoned=1.0)
    assert st.as_dict() == sj.as_dict()
    assert st.as_dict()["DeviceUtilization"] == pytest.approx(0.05 / 0.09)


def test_overlapped_pipeline_equals_the_synchronous_one():
    """max_in_flight 1 (the synchronous loop, no thread) and 3 (the feeder
    prepares and copies ahead of the harvester thread) give equal
    EventResults, bit for bit, in submission order, from one seed: the
    feeder alone draws from the generator, event by event.  Both report a
    DeviceUtilization of at most 1 (the union of the batches' spans over
    the dispatch phase's wall)."""
    events = [[cascade(2.0, 0.0), pulse(600.0)], [pulse(300.0, z=-20.0)],
              [], [cascade(2.0, 30.0)]]
    runs = {}
    for depth in (1, 3):
        sim = make_sim(n_slots=64)
        sim.flasher_generator.photons_per_step = 5
        pipe = EventPipeline(sim, max_in_flight=depth)
        runs[depth] = (pipe.process(events, seed=5), pipe.stats.as_dict())
    (res_1, d_1), (res_3, d_3) = runs[1], runs[3]
    assert [r.event_id for r in res_3] == list(range(len(events)))
    for a, b in zip(res_1, res_3):
        np.testing.assert_array_equal(a.hist, b.hist)
        assert (a.event_id, a.n_generated, a.n_hits, a.weight_hits,
                a.per_particle) == (b.event_id, b.n_generated, b.n_hits,
                                    b.weight_hits, b.per_particle)
    assert res_1[0].n_hits > 0 and res_1[2].n_generated == 0
    for d in (d_1, d_3):
        assert d["NumKernelCalls"] == d_1["NumKernelCalls"] >= len(events)
        assert 0.0 < d["DeviceUtilization"] <= 1.0
        assert d["TotalNumPhotonsGenerated"] == sum(r.n_generated
                                                    for r in res_1)


def test_harvester_exception_is_raised_from_process(monkeypatch):
    """An exception in the harvester thread (here propagate_auto failing on
    the second batch) is raised again from process with the harvester's
    frames in its traceback, and no harvester thread is left alive; the
    synchronous loop raises the same."""
    import threading
    from clsim_tpu_torch.parallel import pipeline as P
    inner, calls = P.propagate_auto, []

    def failing_propagate(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("propagation failed on the harvester")
        return inner(*a, **kw)

    monkeypatch.setattr(P, "propagate_auto", failing_propagate)
    sim = make_sim(n_slots=64)
    events = [[cascade(2.0, 0.0)] for _ in range(6)]
    for depth in (3, 1):
        calls.clear()
        with pytest.raises(RuntimeError, match="on the harvester") as info:
            EventPipeline(sim, max_in_flight=depth).process(events, seed=2)
        assert any(e.name == "failing_propagate" for e in info.traceback)
        assert not [t for t in threading.enumerate()
                    if t.name == "EventPipeline-harvester"]
