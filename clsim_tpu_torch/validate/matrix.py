"""The BASELINE correctness matrix: the propagator against the float64
oracle (validate/oracle.py) in four configurations, the port's counterpart
of scripts/validate_oracle.py and of the workloads of tests/test_oracle.py.

  cascade         isotropic 3 m steps at one point in a 14-layer ice with
                  tilt and anisotropy, on a 7-string hexagon at oversize 9,
                  pancake 4 (tests/test_oracle.py::_workload);
  muon            4,096 slices of one 250 m track crossing the array, at
                  80 m segments (_workload_muon; its medium is the
                  cascade's layered ice: the parsed spice_lea variant waits
                  until those ice files are in the repository, the
                  fallback tests/test_oracle.py takes without them);
  flasher         LED pulses (source_type 1 on a stacked 405 nm spectrum,
                  length 0), a horizontal beam smeared by 10 degrees next
                  to a string (_workload_flasher): the photons keep the
                  step's direction, the oracle dispatches on its list of
                  spectra;
  cascade-biased  the cascade with the DOM acceptance as the wavelength
                  bias: the production weighted path (weight = step weight
                  / bias), held on per-hit records.

`workload` builds a configuration on a device with the JAX workloads' numpy
seeds (5, 77, 99) and values, `propagate` runs it through
dispatch.propagate_auto (the kernel on CUDA tensors, or the engine) with
validate_oracle.py's seed 3, `oracle` through oracle_propagate with
np.random.default_rng(123), and `check_case` applies
scripts/validate_oracle.py's decision rule (`compare`), every statistic at
|z| < 5:
  * the total-hit z;
  * the ten coarse time bins and the ten hottest DOMs, with the mean
    weight as the variance factor (w2bar = sum w^2 / sum w when biased);
  * biased only, on per-hit (DOM x time bin, weight) records: the weight
    law's quartiles and 90th percentile within max(10%, 5 bootstrap
    sigma), eight equal-count time bins (edges from the oracle's hit-time
    quantiles) of weights clamped at the oracle's q99 with their own sum
    w^2 variances, at least four of them resolving 25% at 5 sigma, and the
    total weight's z with w2bar.
The per-hit statistics are there because the weights are heavy-tailed
(~1/bias at the spectrum's edges): a constant-weight variance has little
power against a broken weight path.  `check_case` adds what a run must meet
besides the statistics: generated = the steps' photons, every hit recorded
with weight 1/bias in the biased run (unit weights otherwise), and the
kernel launched by "auto" on the card and never by "engine".

The seeds are the protocol's and fixed.  `propagate(..., draw=1)` is one
second propagator draw (seed 4), against the same oracle sample: the
biased cascade's weighted bins take their variance from the oracle's
sample alone, which a handful of hits at the acceptance's floor (weight
~1.1e6 against ~1e3 for most) dominates, so one draw passing says little.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import DetectorGeometry, hexagonal_geometry
from ..hits.acceptance import icecube_dom_acceptance
from ..hits.photons import (compact_records, photon_batch_dom_index,
                           records_to_photon_batch)
from ..medium.anisotropy import AnisotropyParams
from ..medium.functions import DEFAULT_ICE_REF_INDEX
from ..medium.properties import MediumProperties, make_homogeneous_ice
from ..medium.tilt import TiltParams
from ..ops.spectrum import (SpectrumTable, make_cherenkov_spectrum,
                            stack_spectra)
from ..propagate import kernel as K
from ..propagate.dispatch import propagate_auto
from ..sources.flasher import led_spectrum
from ..types import PropagationConfig, StepBatch
from .oracle import oracle_propagate

CONFIGS = ("cascade", "muon", "flasher", "cascade-biased")
N_STEPS = 4096
PHOTONS_PER_STEP = 24      # the workloads' own (tests/test_oracle.py)
SEEDS = (3, 4)             # the propagator's: validate_oracle.py's, a 2nd draw
ORACLE_SEED = 123
BOOT_SEED = 7              # the weight law's bootstrap
Z_LIMIT = 5.0
QUANTILES = (0.25, 0.5, 0.75, 0.9)
QUANTILE_REL = 0.10        # the weight law's systematic bar
BOOT_REPS = 100
EQUAL_COUNT_BINS = 8
SENSITIVITY = 0.25         # a usable equal-count bin resolves 25% at 5 sigma
MIN_USABLE = 4
RING_SLACK = 8             # the engine's record ring: photons a slot + 8
UNFOLD_TOL = 1e-4          # |weight x bias(wavelength) - 1| of a record
TAIL_FACTOR = 100.0        # the weight tail logged: 100 x the oracle's median


class Workload(NamedTuple):
    medium: MediumProperties
    geo: DetectorGeometry
    spectra: SpectrumTable
    cfg: PropagationConfig
    steps: StepBatch
    # the oracle's (wavelengths, density) spectrum, or for the flasher its
    # list indexed by source_type
    oracle_spectra: object
    photons_per_step: int


class Stat(NamedTuple):
    """One statistic: `value` is a z-score (`kind` "z"), a weight quantile's
    relative difference ("quantile", passes at value <= limit) or the count
    of usable equal-count bins ("usable", passes at value >= limit)."""
    name: str
    kind: str
    value: float
    limit: float
    ok: bool


class Comparison(NamedTuple):
    stats: List[Stat]
    lines: List[str]       # the report, as validate_oracle.py prints it

    def passed(self, power: bool = True) -> bool:
        """Every statistic passes; power=False leaves out the usable
        equal-count bins, a demand on the run's size (it is met from ~1e6
        photons on) rather than a test of agreement."""
        return all(s.ok for s in self.stats if power or s.kind != "usable")

    @property
    def max_z(self) -> float:
        return max(abs(s.value) for s in self.stats if s.kind == "z")

    @property
    def failed(self) -> List[str]:
        return [s.name for s in self.stats if not s.ok]


def _ice(device) -> MediumProperties:
    """The 14-layer ice with tilt and anisotropy (numpy seed 5)."""
    r = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    medium = make_homogeneous_ice(n_layers=14, z_start=-350.0,
                                  layer_height=50.0, device=device)
    return medium._replace(
        b400=t(0.015 + 0.03 * r.random(14)),
        a_dust400=t(0.003 + 0.006 * r.random(14)),
        delta_tau=t(0.5 + r.random(14)),
        anisotropy=AnisotropyParams(azimuth=t(3.9), mag_along=t(0.04),
                                    mag_perp=t(-0.08), enabled=True),
        tilt=TiltParams(distances=t([-900.0, -250.0, 350.0, 1000.0]),
                        first_z=t(-450.0), z_spacing=t(110.0),
                        z_corrections=t(15.0 * r.standard_normal((4, 9))),
                        azimuth_cos=t(np.cos(3.93)),
                        azimuth_sin=t(np.sin(3.93)), enabled=True))


def _steps(device, pps, x, y, z, dx, dy, dz, length, source_type):
    full = lambda v, dt=np.float32: np.full(N_STEPS, v, dt)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return StepBatch(
        x=f32(full(x)), y=f32(full(y)), z=f32(full(z)), t=f32(full(0.0)),
        dir_x=f32(dx), dir_y=f32(dy), dir_z=f32(dz), length=f32(full(length)),
        beta=f32(full(1.0)), num_photons=i32(full(pps, np.int32)),
        weight=f32(full(1.0)), identifier=i32(full(0, np.int32)),
        source_type=i32(full(source_type, np.int32)))


def workload(config: str, device="cuda",
             photons_per_step: Optional[int] = None) -> Workload:
    """One configuration of the matrix on `device`, N_STEPS steps of
    `photons_per_step` photons (default PHOTONS_PER_STEP).  cascade-biased
    records every hit: save_photons, and a ring of photons_per_step +
    RING_SLACK records a slot for the engine (the kernel's buffer is sized
    by `propagate`)."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}: one of {CONFIGS}")
    pps = PHOTONS_PER_STEP if photons_per_step is None else \
        int(photons_per_step)
    medium = _ice(device)
    geo = hexagonal_geometry(n_rings=1, string_spacing=70.0,
                             doms_per_string=12, dom_spacing=16.0,
                             z_top=90.0, oversize=9.0, device=device)
    cfg = PropagationConfig(
        n_slots=N_STEPS, pancake_factor=4.0, hist_t_min=0.0,
        hist_t_max=2000.0, hist_n_bins=50, max_layer_steps=8,
        max_segment_m=80.0 if config == "muon" else 120.0,
        stop_on_detection=True)
    if config == "cascade-biased":
        acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                     efficiency=1.0, device="cpu")
        nb = acc.values.shape[0]
        cher = make_cherenkov_spectrum(
            DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
            bias_wlen_nm=float(acc.first_x) + float(acc.dx) * np.arange(nb),
            bias_values=acc.values.numpy())
        cfg = dataclasses.replace(cfg, save_photons=True,
                                  photon_capacity_per_slot=pps + RING_SLACK)
    else:
        lo, hi = ((medium.min_wlen, medium.max_wlen) if config == "muon"
                  else (265.0, 675.0))
        cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, float(lo),
                                       float(hi))
    if config == "flasher":
        led = led_spectrum(405)
        spectra = stack_spectra([cher, led], device=device)
        oracle_spectra = [(cher.x, cher.beta), (led.x, led.beta)]
    else:
        spectra = stack_spectra([cher], device=device)
        oracle_spectra = (spectra.x[0].cpu().numpy(),
                          spectra.beta[0].cpu().numpy())

    if config in ("cascade", "cascade-biased"):
        rr = np.random.default_rng(77)
        costh = rr.uniform(-1, 1, N_STEPS)
        sinth = np.sqrt(1 - costh ** 2)
        phi = rr.uniform(0, 2 * np.pi, N_STEPS)
        steps = _steps(device, pps, 9.0, -4.0, 13.0, sinth * np.cos(phi),
                       sinth * np.sin(phi), costh, 3.0, 0)
    elif config == "muon":
        # one track crossing the array: every step is a slice of it
        d = np.array([0.25, 0.10, 0.96])
        d = d / np.linalg.norm(d)
        full = lambda v: np.full(N_STEPS, v)
        steps = _steps(device, pps, -30.0, -12.0, -120.0, full(d[0]),
                       full(d[1]), full(d[2]), 250.0, 0)
    else:
        rr = np.random.default_rng(99)
        phi = 0.3 + 0.17 * rr.standard_normal(N_STEPS)
        theta = np.pi / 2 + 0.17 * rr.standard_normal(N_STEPS)
        steps = _steps(device, pps, 2.0, 35.2, 20.0,
                       np.sin(theta) * np.cos(phi),
                       np.sin(theta) * np.sin(phi), np.cos(theta), 0.0, 1)
    return Workload(medium, geo, spectra, cfg, steps, oracle_spectra, pps)


def propagate(w: Workload, backend: str = "auto", draw: int = 0):
    """The workload through dispatch.propagate_auto with SEEDS[draw]; a
    record run gives the kernel a buffer for every photon, so no record
    waits for a later launch.  Returns the PropagationResult and the
    kernel's launches during the run."""
    opts = {}
    if w.cfg.save_photons:
        opts["rec_capacity"] = N_STEPS * w.photons_per_step + 1
    before = sum(K.MODE_LAUNCHES.values())
    res = propagate_auto(w.steps, w.medium, w.geo, w.spectra, SEEDS[draw],
                         w.cfg, backend=backend, **opts)
    return res, sum(K.MODE_LAUNCHES.values()) - before


def oracle(w: Workload):
    """oracle_propagate on the workload's steps with ORACLE_SEED: (hist,
    hits, weight sum) and, for a record run, the per-hit weights and flat
    DOM x time bins."""
    return oracle_propagate(
        w.steps, w.medium, w.geo, w.oracle_spectra,
        (w.spectra.bias_x, w.spectra.bias_y), w.cfg,
        np.random.default_rng(ORACLE_SEED),
        photons_per_step=w.photons_per_step,
        collect_weights=w.cfg.save_photons)


def oracle_of(config: str, photons_per_step: int):
    """`oracle` of a configuration built on the CPU, with its seconds: the
    oracle runs on the host, so a worker process can take it while the
    card propagates."""
    t0 = time.perf_counter()
    out = oracle(workload(config, "cpu", photons_per_step))
    return out, time.perf_counter() - t0


def hit_records(res, w: Workload):
    """Per-hit (flat DOM x time bin, weight) of a record run, through
    hits/photons.py as validate_oracle.py reads them; raises when an engine
    ring overflowed (its oldest records would be lost)."""
    cfg = w.cfg
    rec_count = res.rec_count.cpu().numpy()
    if res.rec["time"].shape[0] > 1:
        cap = cfg.photon_capacity_per_slot
        if int(rec_count.max()) >= cap:
            raise ValueError(f"record ring overflow ({int(rec_count.max())}"
                             f" >= {cap}): raise the capacity")
    batch = records_to_photon_batch(res.rec, res.rec_count, w.geo)
    dom = photon_batch_dom_index(batch, w.geo).astype(np.int64)
    tb = np.clip((np.asarray(batch.time, np.float64) - cfg.hist_t_min)
                 / cfg.hist_dt, 0, cfg.hist_n_bins - 1)
    flat = dom * cfg.hist_n_bins + np.floor(tb).astype(np.int64)
    return flat, np.asarray(batch.weight, np.float64)


def unfolding_residual(res, w: Workload) -> float:
    """The largest |weight x bias(wavelength) - 1| over a record run's
    records: each hit's weight is its step's weight (1 in every workload)
    over the bias at its own wavelength (propagation_kernel.c.cl:370), a
    check of the weight path that does not depend on how well a run
    samples the 1/bias tail."""
    rec, _ = compact_records(res.rec, res.rec_count)
    wlen = rec["wavelength"].reshape(-1).double().cpu().numpy()
    weight = rec["weight"].reshape(-1).double().cpu().numpy()
    bias = np.interp(wlen, w.spectra.bias_x.double().cpu().numpy(),
                     w.spectra.bias_y.double().cpu().numpy())
    return float(np.abs(weight * bias - 1.0).max(initial=0.0))


def _z_stat(name, z) -> Stat:
    return Stat(name, "z", float(z), Z_LIMIT, bool(abs(z) < Z_LIMIT))


def _flag(ok: bool) -> str:
    return "" if ok else "  <-- FAIL"


def compare(config: str, result, records, oracle_out) -> Comparison:
    """scripts/validate_oracle.py's decision rule.  `result` carries n_hits
    and hist (n_doms, n_bins); `records` is hit_records' (flat bins,
    weights) for cascade-biased, else None; `oracle_out` is `oracle`'s
    tuple.  Every statistic is kept with its pass or fail; nothing
    raises."""
    biased = config == "cascade-biased"
    eng_hits = float(result.n_hits)
    eng_hist = np.asarray(torch.as_tensor(result.hist).double().cpu())
    o_hist, o_hits = oracle_out[0], float(oracle_out[1])
    n_bins = o_hist.shape[1]
    stats, lines = [], []
    z_tot = (eng_hits - o_hits) / math.sqrt(max(eng_hits + o_hits, 1.0))
    stats.append(_z_stat("total hits", z_tot))
    lines.append(f"total-hits z = {z_tot:+.2f}")
    wbar = max(eng_hist.sum() / max(eng_hits, 1.0), 1e-9)
    if biased:
        e_flat, e_w = records
        o_w, o_flat = oracle_out[3], oracle_out[4]
        lines.append("weight-law quantiles (engine / oracle / rel diff / "
                     "threshold):")
        boot = np.random.default_rng(BOOT_SEED)
        for q in QUANTILES:
            qe, qo = float(np.quantile(e_w, q)), float(np.quantile(o_w, q))
            rd = abs(qe - qo) / qo
            # 10% systematic, widened only where the bootstrap says the
            # samples cannot resolve 10%
            se2 = sum(np.var([np.quantile(boot.choice(a, len(a)), q)
                              for _ in range(BOOT_REPS)])
                      for a in (e_w, o_w))
            thr = max(QUANTILE_REL, Z_LIMIT * math.sqrt(se2) / qo)
            stats.append(Stat(f"weight q{int(q * 100):02d}", "quantile", rd,
                              thr, bool(rd <= thr)))
            lines.append(f"  q{int(q * 100):02d} {qe:12.4f} {qo:12.4f} "
                         f"{rd:8.4f} {thr:8.4f}{_flag(rd <= thr)}")
        # both sides clamped at the oracle's q99 weight: bounded per-entry
        # variance gives the bins the power the 1/bias tail takes away
        w_cap = float(np.quantile(o_w, 0.99))
        lines.append(f"clamped-weight comparison (cap = oracle q99 = "
                     f"{w_cap:.3f}):")
        # the tail the cap cuts: a few hits near the acceptance's floor
        # carry much of the raw weight, and set w2bar below
        w_tail = TAIL_FACTOR * float(np.median(o_w))
        for side, a in (("engine", e_w), ("oracle", o_w)):
            top = a[a > w_tail]
            lines.append(f"  {side}: {len(top)} hits above {w_tail:.4g} "
                         f"({TAIL_FACTOR:g} x the oracle's median), "
                         f"largest {a.max(initial=0.0):.6g}, "
                         f"{top.sum() / max(a.sum(), 1e-300):.3f} of the "
                         "weight")
        e_wc, o_wc = np.minimum(e_w, w_cap), np.minimum(o_w, w_cap)
        tf_e, tf_o = e_flat % n_bins, o_flat % n_bins
        edges = np.unique(np.quantile(
            tf_o, np.linspace(0, 1, EQUAL_COUNT_BINS + 1))[1:-1])
        be, bo = np.digitize(tf_e, edges), np.digitize(tf_o, edges)
        nqb = len(edges) + 1
        sums = [np.bincount(b, weights=v, minlength=nqb)
                for b, v in ((be, e_wc), (be, e_wc ** 2), (bo, o_wc),
                             (bo, o_wc ** 2))]
        te_c, ve_c, to_c, vo_c = sums
        usable = 0
        lines.append("  equal-count time bins (engine / oracle / z / 5sig "
                     "rel sensitivity):")
        for k in range(nqb):
            if te_c[k] + to_c[k] <= 0 or ve_c[k] + vo_c[k] <= 0:
                continue
            sig = math.sqrt(ve_c[k] + vo_c[k])
            z = (te_c[k] - to_c[k]) / sig
            sens = Z_LIMIT * sig / (0.5 * (te_c[k] + to_c[k]))
            usable += int(sens <= SENSITIVITY)
            stats.append(_z_stat(f"equal-count bin {k}", z))
            lines.append(f"  [{k}] {te_c[k]:12.1f} {to_c[k]:12.1f} "
                         f"{z:+6.2f} {sens:8.3f}{_flag(abs(z) < Z_LIMIT)}")
        stats.append(Stat("usable equal-count bins", "usable", usable,
                          MIN_USABLE, usable >= MIN_USABLE))
        lines.append(f"  usable clamped bins (5sig sensitivity <= 25%): "
                     f"{usable}{_flag(usable >= MIN_USABLE)}")
        # the raw weighted totals: a loose, tail-dominated check
        w2bar = float((o_w ** 2).sum() / max(o_w.sum(), 1e-9))
        w_e, w_o = eng_hist.sum(), o_hist.sum()
        z_w = (w_e - w_o) / math.sqrt(w2bar * (w_e + w_o))
        stats.append(_z_stat("total weight", z_w))
        lines.append(f"total-weight z = {z_w:+.2f}  (w2bar {w2bar:.2f}; "
                     "loose tail-dominated check)")
        wbar = max(w2bar, 1e-9)

    te = eng_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    to = o_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    lines.append("time bins (engine / oracle / z):")
    for k in range(10):
        if te[k] + to[k] < 25 * wbar:
            continue
        z = (te[k] - to[k]) / (wbar * math.sqrt((te[k] + to[k]) / wbar))
        stats.append(_z_stat(f"time bin {k}", z))
        lines.append(f"  [{k}] {te[k]:12.1f} {to[k]:12.1f} {z:+6.2f}"
                     f"{_flag(abs(z) < Z_LIMIT)}")
    occ_e, occ_o = eng_hist.sum(axis=1), o_hist.sum(axis=1)
    worst = 0.0
    for d in np.argsort(occ_e + occ_o)[-10:]:
        z = (occ_e[d] - occ_o[d]) / (
            wbar * math.sqrt(max((occ_e[d] + occ_o[d]) / wbar, 1e-300)))
        stats.append(_z_stat(f"DOM {int(d)} occupancy", z))
        worst = max(worst, abs(z))
    lines.append(f"hottest-10 DOM occupancy worst |z| = {worst:.2f}")
    cmp = Comparison(stats, lines)
    n_fail = len(cmp.failed)
    lines.append("PASS" if n_fail == 0
                 else f"FAIL ({n_fail} statistics failed: "
                      f"{', '.join(cmp.failed)})")
    return cmp


class Case(NamedTuple):
    cmp: Comparison
    records: Optional[tuple]   # hit_records' (flat bins, weights), or None
    unfold: Optional[float]    # unfolding_residual of a record run
    problems: List[str]        # empty when the case passes


def check_case(config: str, w: Workload, res, launches: int, oracle_out,
               backend: str = "auto", power: bool = True) -> Case:
    """One case of the matrix: `compare`'s statistics (the usable
    equal-count bins only with `power`) and what the run must meet
    besides: generated = the steps' photons; in a record run every hit
    recorded once (records = hits) with its step's weight over the bias at
    its wavelength (unfolding_residual <= UNFOLD_TOL), else unit weights
    on both sides; on CUDA steps "auto" launched the kernel and "engine"
    did not (`launches`, propagate's count).  Raises only where
    hit_records does (an engine ring that overflowed)."""
    records = hit_records(res, w) if w.cfg.save_photons else None
    cmp = compare(config, res, records, oracle_out)
    hits = float(res.n_hits)
    problems, unfold = [], None
    if float(res.n_generated) != N_STEPS * w.photons_per_step:
        problems.append("generated != the steps' photons")
    if records is not None:
        unfold = unfolding_residual(res, w)
        if len(records[1]) != hits:
            problems.append("records != hits")
        if not unfold <= UNFOLD_TOL:
            problems.append("weights are not 1 / bias")
    elif not (math.isclose(float(res.weight_hits), hits, rel_tol=1e-5)
              and math.isclose(float(oracle_out[2]), float(oracle_out[1]),
                               rel_tol=1e-9)):
        problems.append("weights are not unit")
    if backend == "engine" and launches:
        problems.append("the engine launched the kernel")
    if backend == "auto" and w.steps.x.is_cuda and not launches:
        problems.append("the kernel was not launched")
    if not cmp.passed(power):
        problems.append("statistics failed: " + ", ".join(cmp.failed))
    return Case(cmp, records, unfold, problems)
