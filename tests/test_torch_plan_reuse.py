"""The call loop's plan kept between calls (propagate/kernel.plan_call): a
second call with the same inputs reuses the collision plan and the device
tables and gives bit for bit what a fresh plan gives; an in-place edit of a
medium tensor, a new medium, another config, slot count, launch length or
draw rebuilds the part it changes; the cache stays within its bound; an
event stream plans once and reads no planning value back after its first
batch; a SubPlan fallback is counted once per plan built; the benchmark's
reader of the reuse counters."""

import dataclasses
import gc
import sys
import threading
import warnings
import weakref

import numpy as np
import pytest
import torch

from clsim_tpu_torch.convert import steps_from_numpy
from clsim_tpu_torch.geometry import build_geometry
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.parallel import EventPipeline
from clsim_tpu_torch.propagate import kernel as K
from clsim_tpu_torch.propagate.diff import replace_leaves
from clsim_tpu_torch.types import StepBatch
from clsim_tpu_torch.util import profiling as P

from test_torch_pipeline import cascade, make_sim

torch.set_num_threads(1)

T = 64
# the wait sites of a plan's build: the geometry's and the medium's host
# copies, the medium's scalars and the tables' upload
PLANNING = ("to_numpy", "medium_scalars", "tables_h2d")


@pytest.fixture
def world():
    """A fused Simulation of make_sim's detector and one slot batch of a
    cascade beside its string, with no plan kept."""
    sim = make_sim(n_slots=256, backend="fused",
                   fused_opts=dict(iters_per_call=T))
    batches = sim.steps_from_particles([cascade(5.0, 0.0)],
                                       np.random.default_rng(1))
    K.clear_plans()
    yield sim, steps_from_numpy(batches[0]._asdict(), "cpu")
    K.clear_plans()


def run(sim, steps, medium=None, cfg=None, **kw):
    kw.setdefault("iters_per_call", T)
    return K.propagate_fused(steps, medium or sim.medium, sim.geometry,
                             sim.spectra, 7, cfg or sim.config, **kw)


def counted(fn, *a, **kw):
    """fn's result and the plan_build and plan_reuse it counted."""
    with P.recording() as rec:
        out = fn(*a, **kw)
    return out, rec.total("plan_build"), rec.total("plan_reuse")


def same(a, b):
    (ra, ta), (rb, tb) = a, b
    assert torch.equal(ra.hist, rb.hist)
    assert torch.equal(ta, tb)


def test_a_second_call_reuses_the_plan_bit_identically(world):
    sim, steps = world
    first, built, _ = counted(run, sim, steps)
    second, rebuilt, reused = counted(run, sim, steps)
    assert (built, rebuilt, reused) == (1, 0, 1)
    K.clear_plans()
    fresh, built, _ = counted(run, sim, steps)
    assert built == 1
    same(second, fresh)
    same(first, fresh)
    assert float(fresh[1][K.CNT_HITS]) > 0


def test_an_in_place_edit_of_the_medium_rebuilds_its_part(world):
    sim, steps = world
    before = run(sim, steps)
    _, t0 = K.plan_call(sim.medium, sim.geometry, sim.spectra, sim.config,
                        256, T)
    sim.medium.b400.mul_(1.5)
    (_, t1), built, _ = counted(K.plan_call, sim.medium, sim.geometry,
                                sim.spectra, sim.config, 256, T)
    assert built == 1
    assert torch.equal(t1.layers[0], sim.medium.b400.to(torch.float32))
    assert not torch.equal(t1.layers[0], t0.layers[0])
    assert t1.cells is t0.cells            # the geometry part is kept
    edited = run(sim, steps)
    K.clear_plans()
    same(edited, run(sim, steps))
    assert not torch.equal(edited[0].hist, before[0].hist)


def test_a_new_medium_every_step_keeps_the_cache_within_its_bound(
        world, monkeypatch):
    """A fit's steps (diff.replace_leaves): the medium part misses every
    time and the oldest media are let go; the geometry part is planned
    once."""
    sim, steps = world
    plans = []
    geometry_fields = K.geometry_fields
    monkeypatch.setattr(K, "geometry_fields",
                        lambda *a: plans.append(1) or geometry_fields(*a))
    n = K.PLAN_CACHE_SIZE + 3
    held = []
    with P.recording() as rec:
        for k in range(n):
            b400 = sim.medium.b400 * (1.0 + 0.01 * k)
            held.append(weakref.ref(b400))
            run(sim, steps, medium=replace_leaves(sim.medium,
                                                  {("b400",): b400}))
            del b400
            assert len(K.MEDIUM_PLANS.entries) <= K.PLAN_CACHE_SIZE
    assert rec.total("plan_build") == n and rec.total("plan_reuse") == 0
    assert len(plans) == 1 and len(K.GEOMETRY_PLANS.entries) == 1
    gc.collect()
    assert [r() is None for r in held] == (
        [True] * (n - K.PLAN_CACHE_SIZE) + [False] * K.PLAN_CACHE_SIZE)


VARIANTS = {
    "config": (dict(cfg=dict(max_segment_m=60.0)), 1),
    "equal_config": (dict(cfg=dict()), 0),
    "n_slots": (dict(slots=128), 1),
    "iters_per_call": (dict(iters_per_call=T // 2), 1),
    "threefry": (dict(threefry_key=rng.base_key(5), max_calls=1), 1),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_another_key_rebuilds_the_plan(world, name):
    """Another config, slot count, launch length or draw plans anew, and
    its result equals a fresh plan's; an equal config (another object) is
    the same key."""
    sim, steps = world
    change, builds = VARIANTS[name]
    kw = dict(change)
    if "cfg" in kw:
        kw["cfg"] = dataclasses.replace(sim.config, **kw["cfg"])
    if "slots" in kw:
        n = kw.pop("slots")
        steps = StepBatch(*[a[:n] for a in steps])
    run(sim, world[1])
    out, built, reused = counted(run, sim, steps, **kw)
    assert (built, reused) == (builds, 1 - builds)
    _, built, reused = counted(run, sim, steps, **kw)
    assert (built, reused) == (0, 1)
    K.clear_plans()
    same(out, run(sim, steps, **kw))


def test_an_event_stream_plans_once():
    """EventPipeline.process of K batches builds the plan in its first
    batch and reuses it in the K - 1 others, whose waits hold no planning
    site: the waits a batch fall by the sites of a build."""
    sim = make_sim(n_slots=256, backend="fused",
                   fused_opts=dict(iters_per_call=T))
    events = [[cascade(5.0, 0.0)], [cascade(3.0, 50.0)],
              [cascade(4.0, -50.0)], [cascade(2.0, 20.0)]]
    K.clear_plans()
    with P.recording() as rec:
        EventPipeline(sim, max_in_flight=2).process(events, seed=3)
    batches = rec.spans("batch")
    k = len(batches)
    assert k >= 4
    assert (rec.total("plan_build"), rec.total("plan_reuse")) == (1, k - 1)
    by_id = {s["id"]: s for s in rec.spans()}

    def root(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
        return s
    sites = {b["batch"]: set() for b in batches}
    for s in rec.spans("wait"):
        if root(s)["name"] == "batch":
            sites[root(s)["batch"]].add(s["site"])
    assert [b for b, ss in sites.items() if set(PLANNING) & ss] == [0]
    assert all("check" in ss for ss in sites.values())
    # the build's planning waits are those of one plan from scratch
    steps = sim.steps_from_particles(events[0], np.random.default_rng(0))
    steps = steps_from_numpy(steps[0]._asdict(), "cpu")
    K.clear_plans()
    with P.recording() as cold:
        run(sim, steps)
    for site in PLANNING:
        assert rec.total("waits", site=site) == cold.total("waits",
                                                           site=site)
    assert sum(cold.total("waits", site=s) for s in PLANNING) > 0
    K.clear_plans()
    # the benchmark's reader of the two counters (the recorder keeps the
    # last recording)
    with P.recording():
        EventPipeline(sim, max_in_flight=2).process(events, seed=3)
    assert share_reader().read({"driver": "stream"}) == pytest.approx(
        100.0 * (k - 1) / k)
    K.clear_plans()


def test_threads_share_the_kept_plans_without_a_lost_update(world):
    """More threads than cores plan at once over more media than the cache
    keeps, with a short switch interval: every call gets the tables of its
    own medium, and the cache never holds more than its bound."""
    sim, _ = world
    media = [replace_leaves(sim.medium, {("b400",): sim.medium.b400 * f})
             for f in np.linspace(1.0, 2.0, K.PLAN_CACHE_SIZE + 2)]
    wrong, sizes = [], []

    def work(k):
        for i in range(40):
            m = media[(k + i) % len(media)]
            _, t = K.plan_call(m, sim.geometry, sim.spectra, sim.config,
                               256, T)
            if t.medium is not m or not torch.equal(
                    t.layers[0], m.b400.to(torch.float32)):
                wrong.append(k)
            sizes.append(len(K.MEDIUM_PLANS.entries))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not wrong and len(sizes) == 16 * 40
    assert max(sizes) <= K.PLAN_CACHE_SIZE
    assert len(K.GEOMETRY_PLANS.entries) == 1


def share_reader():
    from benchmark import harness
    return harness.load_module("metrics", "plan_reuse_share.stream",
                               [harness.HERE])


@pytest.mark.parametrize("recorded,share", [
    (([], [dict(name="plan_build", n=1), dict(name="plan_reuse", n=3)]),
     75.0),
    (([], [dict(name="plan_reuse", n=5), dict(name="launches", n=9)]),
     100.0),
    (([], [dict(name="launches", n=2)]), None),
    (None, None)])
def test_the_plan_reuse_share_reader(recorded, share, monkeypatch):
    """benchmark/metrics/plan_reuse_share.stream.py on planted counters:
    plan_reuse over both counters in %; None where the program counts
    neither (a program older than the counters) or keeps no recorder."""
    from benchmark import spans
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    reader = share_reader()
    assert reader.read({"driver": "stream"}) == share
    assert reader.read({"driver": "other"}) is None


def twenty_strings():
    """20 vertical strings on a 60 m grid in five (z0, dz, n) groups: an
    affine geometry whose split the 4-SubPlan budget refuses, large enough
    for plan_collision's warning."""
    sids, oids, xs, ys, zs = [], [], [], [], []
    for s in range(20):
        g = s % 5
        for d in range(6 + g):
            sids.append(s), oids.append(d)
            xs.append(60.0 * (s % 5)), ys.append(60.0 * (s // 5))
            zs.append(50.0 + 5.0 * g - d * (10.0 + g))
    return build_geometry(sids, oids, xs, ys, zs, oversize=5.0,
                          device="cpu")


def test_a_subplan_fallback_counts_once_per_plan_built(world):
    sim, steps = world
    geo = twenty_strings()
    before = K.SUBPLAN_FALLBACKS["count"]
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        for iters in (T, T, T, T // 2, T // 2):
            K.propagate_fused(steps, sim.medium, geo, sim.spectra, 7,
                              sim.config, iters_per_call=iters)
    assert K.SUBPLAN_FALLBACKS["count"] == before + 2
    assert "4-SubPlan budget" in K.SUBPLAN_FALLBACKS["reason"]
    assert sum("global collision plan" in str(w.message)
               for w in said) == 2
