"""The stream cells' correctness: each sampled event of the window against
the frozen reference's propagation of the same event.

The reference converts the event's sources with the frozen generators on
its own random stream, draws whole steps of the event uniformly until it
holds `photons` photons, propagates every photon of them (each as a
one-photon slot) through the frozen engine with the same configuration
and keeps every hit as a record (DOM, time, wavelength, weight, step).
The program's event (its histogram, generated photons, hits) and the
reference's sample estimate the same per-photon quantities:

  gen     generated photons against the parameterization's mean (Poisson);
  hits    detected photons per generated photon;
  t<b>    weight per photon in time bin b, summed over the DOMs, for each
          bin that holds MIN_HITS reference hits at or below the weight
          cap;
  dom<d>  weight per photon in DOM d, likewise: where the hits land.

Each is a z-score, the gap over its standard error, and two things make
that error wider than a photon count's:
  * photons come in steps (200 a cascade step, 400 a flash step) that
    share a point and a direction, so the program's cells vary with the
    steps drawn: the reference samples whole steps and takes the variance
    of its per-step totals;
  * hits weigh 1/bias(wavelength), ~1e6 near the DOM acceptance's floor
    against ~600 for most, so a few hits can carry much of an event's
    weight.  The reference draws its photons' wavelengths from each biased
    spectrum mixed half and half with its unbiased twin, and weighs each
    hit by r = p_biased / p_mixed <= 2: its means stay as steady as a
    biased sample's and the unbiased half samples the floor.
A weighted cell's mean and error would be ruled by the floor's rare hits,
so the cells take the reference's hits at or below a cap (weight_cap) and
are judged by statistics (placement) that the program's hits above the
cap, which only raise a cell, move little.  Numbers compared: pooled_z
(gen and hits pooled), weight_shift and lowest_z.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from benchmark.world import REFERENCE, pkg

MIN_HITS = 25      # a cell with fewer reference hits is not judged
CHUNK = 1048576    # one-photon slots a reference engine call
COMPACT_EVERY = 16  # iterations between the drops of ended slots
CAP_QUANTILE = 0.999  # placement cells leave out the heaviest hits


@dataclasses.dataclass
class RefEvent:
    dom: np.ndarray       # each reference hit's DOM
    tbin: np.ndarray      # its time bin (the program's binning)
    weight: np.ndarray    # its weight 1/bias (float64)
    ratio: np.ndarray     # its likelihood ratio to the biased law
    step: np.ndarray      # the sampled step it came from
    counts: np.ndarray    # each sampled step's photons
    mean_gen: float       # the event's mean photon count


def event_steps(world, src_mod, desc, rng):
    """The event's steps, converted by the world's generators (frozen
    side), as one numpy StepBatch, and its sources."""
    T = pkg(REFERENCE, "types")
    pulse_cls = pkg(REFERENCE, "sources.particles").FlasherPulse
    srcs = src_mod.sources(REFERENCE, world, desc)
    batches = []
    for i, s in enumerate(srcs):
        gen = (world.flasher_generator if isinstance(s, pulse_cls)
               else world.step_generator)
        batches.extend(gen.convert(s, i, rng))
    return T.StepBatch.concatenate(batches), srcs


def step_sample(steps, photons: int, rng):
    """Whole steps drawn uniformly (with replacement) until they hold
    `photons` photons, each photon as a one-photon step whose identifier
    is its step's index in the draw; and each drawn step's photons."""
    T = pkg(REFERENCE, "types")
    m = np.asarray(steps.num_photons, np.int64)
    n = int(np.ceil(photons / m.mean()))
    idx = rng.integers(0, len(m), n)
    counts = m[idx]
    rows = np.repeat(idx, counts)
    fields = {f: np.asarray(a)[rows] for f, a in steps._asdict().items()}
    fields["num_photons"] = np.ones(len(rows), np.int32)
    fields["identifier"] = np.repeat(np.arange(n), counts).astype(np.int32)
    return T.StepBatch(**fields), counts


def one_photon_sample(steps, n: int, rng):
    """n photons drawn uniformly (with replacement) from the steps' photons,
    each as a one-photon step (the control's event)."""
    T = pkg(REFERENCE, "types")
    cum = np.cumsum(np.asarray(steps.num_photons, np.int64))
    pick = rng.integers(0, int(cum[-1]), n)
    idx = np.searchsorted(cum, pick, side="right")
    fields = {f: np.asarray(a)[idx] for f, a in steps._asdict().items()}
    fields["num_photons"] = np.ones(n, np.int32)
    return T.StepBatch(**fields)


def _take(nt, idx):
    """The rows `idx` of every tensor field of a NamedTuple (None and
    tuples of tensors kept alike)."""
    def one(f):
        if f is None:
            return None
        if isinstance(f, tuple):
            return tuple(g[idx] for g in f)
        return f[idx]
    return type(nt)(*(one(f) for f in nt))


def _harvest(acc) -> dict:
    got = acc.rec_count.reshape(-1) > 0
    return {f: acc.rec[f].reshape(-1)[got] for f in (
        "dom", "time", "weight", "wavelength", "identifier")}


def run_engine(steps, world, cfg, spectra, seed: int, cap: int = 0):
    """engine.propagate's loop over one-photon slots, with the slots whose
    photon has ended dropped every COMPACT_EVERY iterations (a slot holds
    one photon, so an ended slot never spawns again; a step's photons are
    independent, so which slots share an iteration changes no law).  `cap`
    > 0 stops after that many iterations: the control's, whose bfloat16
    budgets may never run out.  Returns (hist, generated, hits, weight,
    records): with cfg.save_photons every hit's record fields, else
    None."""
    import torch
    E = pkg(REFERENCE, "propagate.engine")
    dev = steps.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = steps.x.shape[0]
    state = E._init_state(steps)
    acc = E._init_acc(world.geometry.n_doms, cfg, dev, n_rings=n)
    rstate = dom_xyz = None
    if cfg.save_photons:
        rstate = E._init_rec_state(n, dev, cfg.photon_history_entries)
        dom_xyz = E.dom_centres(world.geometry)
    recs = []
    i = 0
    while not cap or i < cap:
        if i % COMPACT_EVERY == 0:
            live = (state.in_flight > 0.5) | (state.photons_left > 0.5)
            n_live = int(live.sum())
            if n_live == 0:
                break
            if n_live < state.x.shape[0]:
                idx = torch.nonzero(live)[:, 0]
                state, steps = _take(state, idx), _take(steps, idx)
                if cfg.save_photons:
                    recs.append(_harvest(acc))
                    rstate = _take(rstate, idx)
                    fresh = E._init_acc(1, cfg, dev, n_rings=n_live)
                    acc = acc._replace(rec_count=fresh.rec_count,
                                       rec=fresh.rec)
        state, acc, rstate, _ = E._iteration(
            i, state, acc, steps, world.medium, world.geometry, spectra,
            cfg, generator=gen, rstate=rstate, dom_xyz=dom_xyz)
        i += 1
    if cfg.save_photons:
        recs.append(_harvest(acc))
        recs = {f: torch.cat([r[f] for r in recs]) for f in recs[0]}
    hist = acc.hist.reshape(world.geometry.n_doms, cfg.hist_n_bins)
    return (hist, float(acc.n_generated), float(acc.n_hits),
            float(acc.weight_hits), recs if cfg.save_photons else None)


def propagate_sample(world, sample, seed: int, device, records: bool = True,
                     cap: int = 0, spectra=None):
    """The frozen engine over the one-photon sample in chunks of CHUNK
    slots (run_engine): with `records`, (dom, time bin, weight,
    wavelength, identifier) of every hit; else the summed histogram and
    (generated, hits, weight).  `spectra` replaces the world's."""
    import torch
    conv = pkg(REFERENCE, "convert")
    n = len(sample.x)
    parts = []
    hist, totals = None, np.zeros(3)
    for k, lo in enumerate(range(0, n, CHUNK)):
        part = {f: np.asarray(a)[lo:lo + CHUNK]
                for f, a in sample._asdict().items()}
        cfg = dataclasses.replace(world.config, n_slots=len(part["x"]),
                                  save_photons=records,
                                  photon_capacity_per_slot=1)
        st = conv.steps_from_numpy(part, device)
        with torch.no_grad():
            h, g, nh, wh, rec = run_engine(st, world, cfg,
                                           spectra or world.spectra,
                                           seed + k, cap)
        if records:
            parts.append({f: v.cpu().numpy() for f, v in rec.items()})
        else:
            h = h.double().cpu().numpy()
            hist = h if hist is None else hist + h
            totals += [g, nh, wh]
    if not records:
        return hist, totals
    cfg = world.config
    cat = lambda f: np.concatenate([d[f] for d in parts]).astype(np.float64)
    tbin = np.clip((cat("time") - cfg.hist_t_min) / cfg.hist_dt, 0.0,
                   cfg.hist_n_bins - 1).astype(np.int64)
    return (cat("dom").astype(np.int64), tbin, cat("weight"),
            cat("wavelength"), cat("identifier").astype(np.int64))


def mixed_ratio(world, lam, types):
    """p_biased / p_mixed at each hit's wavelength for its source type (the
    samplers' piecewise-linear densities)."""
    r = np.empty(len(lam))
    for t in np.unique(types):
        m = types == t
        x, pb, pq = world.densities[t]
        r[m] = np.interp(lam[m], x, pb) / np.interp(lam[m], x, pq)
    return r


def reference_event(world, src_mod, desc, seed: int, photons: int,
                    device) -> RefEvent:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    steps, srcs = event_steps(world, src_mod, desc, rng)
    sample, counts = step_sample(steps, photons, rng)
    types = np.asarray(sample.source_type)
    dom, tbin, w, lam, step = propagate_sample(
        world, sample, seed, device, spectra=world.spectra_mix)
    return RefEvent(dom=dom, tbin=tbin, weight=w,
                    ratio=mixed_ratio(world, lam, types[
                        np.searchsorted(np.asarray(sample.identifier),
                                        step)]),
                    step=step, counts=counts,
                    mean_gen=src_mod.mean_photons(world, desc, srcs))


def cell_z(value, gen, a, q, ref: RefEvent) -> float:
    """z of a program cell `value` (a sum over its `gen` photons) against
    the reference's hits of the cell: `a` each hit's contribution to the
    cell's mean (r-weighted) and `q` to its second moment under the
    biased law.  Per drawn step j, T_j = sum a, Q_j = sum q, R_j = sum a^2:
    the program's variance a step is the steps' spread Var(T - y m) less
    the reference's own sampling noise mean(R), plus the photons' own
    mean(Q)."""
    S, m = len(ref.counts), ref.counts.astype(np.float64)
    T = np.bincount(ref.step, weights=a, minlength=S)
    Q = np.bincount(ref.step, weights=q, minlength=S).mean()
    R = np.bincount(ref.step, weights=a * a, minlength=S).mean()
    y = T.sum() / m.sum()
    spread = ((T - y * m) ** 2).mean()
    var_step = max(spread - R, 0.0) + Q
    m_bar = m.mean()
    var = var_step / (m_bar * gen) + spread / (S * m_bar * m_bar)
    return (value / gen - y) / math.sqrt(max(var, 1e-300))


def pooled(zs) -> float:
    """Many cells' z pooled into one: (sum z^2 - k) / sqrt(2 k), ~N(0, 1)
    when each z is; a distortion spread thinly over many cells (a
    quantized time, a smeared DOM pattern) adds up in it."""
    zs = np.asarray(list(zs), np.float64)
    k = len(zs)
    return float(((zs * zs).sum() - k) / math.sqrt(2.0 * k)) if k else 0.0


def weight_cap(ref: RefEvent) -> float:
    """The weight above which a hit is left out of the placement cells:
    the CAP_QUANTILE quantile of the reference's hit weights under the
    biased law (each hit counted by its ratio r)."""
    if len(ref.weight) == 0:
        return math.inf
    o = np.argsort(ref.weight)
    c = np.cumsum(ref.ratio[o])
    return float(ref.weight[o][min(np.searchsorted(c, CAP_QUANTILE * c[-1]),
                                   len(o) - 1)])


def event_z(hist, gen, n_hits, ref: RefEvent) -> dict:
    """{name: z} of one program event (hist (n_doms, n_bins), generated
    photons, detected photons) against its reference sample: gen, hits,
    and under "cells" {t<b> / dom<d>: z} of each time bin (summed over the
    DOMs) and each DOM that holds MIN_HITS reference hits at or below the
    weight cap, each cell's weight against the reference's hits at or
    below the cap."""
    hist = np.asarray(hist, np.float64)
    out = {"gen": (gen - ref.mean_gen) / math.sqrt(ref.mean_gen)}
    if not np.isfinite(hist).all() or gen <= 0:
        out["finite"] = math.inf
        return out
    r, w = ref.ratio, ref.weight
    out["hits"] = cell_z(n_hits, gen, r, r, ref)
    keep = w <= weight_cap(ref)
    a, q = r * w * keep, r * w * w * keep
    per_bin = hist.sum(axis=0)
    per_dom = hist.sum(axis=1)
    cells = {}
    for b in np.nonzero(np.bincount(ref.tbin[keep], minlength=hist.shape[1])
                        >= MIN_HITS)[0]:
        m = ref.tbin == b
        cells[f"t{b}"] = cell_z(per_bin[b], gen, a * m, q * m, ref)
    for d in np.nonzero(np.bincount(ref.dom[keep], minlength=hist.shape[0])
                        >= MIN_HITS)[0]:
        m = ref.dom == d
        cells[f"dom{d}"] = cell_z(per_dom[d], gen, a * m, q * m, ref)
    out["cells"] = cells
    return out


def pooled_z(zs: list) -> float:
    """The count statistic: gen's and hits' z of every checked event,
    pooled as (sum z^2 - k) / sqrt(2 k); a non-finite histogram reads
    infinite."""
    if any("finite" in z for z in zs):
        return math.inf
    return pooled([z[k] for z in zs for k in ("gen", "hits")])


def placement(zs: list):
    """(weight_shift, lowest_z) of the cells of every checked event.
    weight_shift is |the median cell z|: a weight wrong everywhere moves
    every cell.  lowest_z is minus the lowest cell z: hits credited to the
    wrong DOM or bin leave some cell short of what the reference puts
    there (the DOM or bin they left).  The program's hits above the cap
    only raise their cells: they cannot lower one, and only where many
    cells hold one (a cascade's cells of many hits) do they lift the
    median (to ~1.5 in sound runs, PERF.md).  With no cell to judge, or a
    non-finite histogram, both read infinite."""
    if any("finite" in z for z in zs):
        return math.inf, math.inf
    v = np.array([x for z in zs for x in z["cells"].values()], np.float64)
    if not len(v):
        return math.inf, math.inf
    return abs(float(np.median(v))), -float(v.min())


def summary(z: dict) -> str:
    """One checked event's numbers, for standard error."""
    if "finite" in z:
        return "non-finite histogram"
    c = np.array(list(z["cells"].values()))
    return (f"z gen {z['gen']:.3f} hits {z['hits']:.3f}; {len(c)} cells, "
            + (f"median {np.median(c):.3f}, lowest {c.min():.3f}, highest "
               f"{c.max():.3f}" if len(c) else "none"))
