#!/usr/bin/env python3
"""Smoke run of clsim_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py            # build, check and drive the main path
    python3 chip_smoke.py --sweep    # also time iters_per_call choices
    python3 chip_smoke.py --turns LABEL:ROOT ... [--json PATH]
        # the kernel bodies of several checkouts in turns, one process a
        # turn (ROOT: a checkout, e.g. a parent commit unpacked under build/
        # by git archive), each instantiation at phase 2's shape and the
        # fixed-horizon ones also at the steady shape, with each body's
        # account (k1_stats); PATH gets every turn's numbers as JSON
    python3 chip_smoke.py --host-split LABEL:ROOT ... [--json PATH]
        # phase 3's cascade and 8b's flash with the package of each
        # checkout in turns (e.g. parent, new, new, parent), one process a
        # turn: simulate's wall and its host split (conversion, slot
        # assignment, copy, propagation), medians of 3
    python3 chip_smoke.py --tab-turns LABEL:ROOT ... [--json PATH]
        # the tabulator's kernel (T1) of each checkout in turns, one
        # process a turn: its kernel row (11a's first 32 iterations), 11a's
        # runs with each launch between CUDA events, the 4x-slot run, the
        # account (tab_stats) and the ptxas figures of T1 and of K1
    python3 chip_smoke.py --loop-turns LABEL:ROOT ... [--json PATH]
        # phase 14b's cases (phase 3's cascade, 8b's flash) and 7b's ic86
        # cascade at iters_per_call 256, 1024, 4096 with repack off, on and
        # with balance, the package of each checkout in turns (parent,
        # new, new, parent), one process a turn: simulate's wall and the
        # kernel launches' summed ms, medians of 5, each body's spread; a
        # checkout without repack runs its own loop as "off"
    python3 chip_smoke.py --cell-turns LABEL:ROOT ... [--json PATH]
        # the benchmark's stream cells (ic86-production's cascades and
        # flashes, their first events) through Simulation.simulate with
        # the package of each checkout in turns, one process a turn: K1's
        # seconds a photon and its account (k1_stats: candidates and cull
        # passes a slot-iteration, the cull's share of the cycles); a body
        # with the card's cull table also runs the coarse lists, whose hits
        # must equal its own; and the global plans' ptxas figures
    python3 chip_smoke.py --mesh N   # build, then phase 12b with N ranks
        # (NCCL with a card each when there are N cards, else gloo)
    python3 chip_smoke.py --oracle-matrix
        # build, then phase 10b's four configurations at 4,096 x 245
        # photons (>= 1e6; the biased one x 489, >= 2e6) through the
        # kernel and the card's engine, every statistic of
        # scripts/validate_oracle.py held (the usable equal-count bins
        # too); one JSON line of the cases

Phases (any failure raises and exits non-zero):
  0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device is an error (there is no CPU path);
  1. build the CUDA kernels from csrc/ (nvcc) and print the build time;
  2. the propagation kernel against its plain PyTorch version on the same
     tensors and the same (T, 8, N) uniform stream, at the main path's
     262,144 slots: equal generated counts (within 1e-5 on the main-path
     configuration), hits and layer-walk steps within max(2, 1%),
     histogram L1 <= 2e-3 of the total; the two instantiations the
     program's paths run (mode 0 on the main-path configuration, mode 32 on
     ic86 at the default configuration) also timed in the Philox mode,
     with their account (k1_stats: walk steps, SIMT efficiency,
     spawn-path lanes, the barrier's share of each warp's cycles, cycles a
     warp-iteration);
  3. the main path: Simulation.simulate of a 100 TeV EMinus cascade at the
     centre of hex61 (61 strings, 3,660 DOMs) in a seeded 171-layer ice,
     262,144 slots, with the native step sampler (its failing to load
     fails the phase); the kernel must have been launched, the photon
     yield must match the PPC formula, nothing dropped or abandoned; the
     host split of the same call (host_split: conversion, slot
     assignment, host-to-device copy, propagation);
  4. the bench workload (262,144 slots x 200 photons on hex61) through the
     port, and a statistical comparison of the kernel with the plain version
     (hits per generated photon, |z| < 5) at 16,384 slots x 50 photons;
  5. photon records and MCPE hits (the kernel's record mode) at 262,144
     slots:
     a. the record mode against its plain version on phase 2's shared
        stream (test_kernel workload with aniso + tilt, and the main-path
        configuration, with save_photons): phase 2's checks, one record per
        hit, record counts within max(2, 1%), records matched on (slot,
        dom) within tests/test_kernel.py:523-529's tolerances (on the
        test_kernel workload every record of the smaller set, a hit moved
        by FMA contraction staying in the hit-count allowance; >= 99.9% of
        them on the main-path one);
     b. SAVE_ALL at prescale 0.5 with a record buffer smaller than the
        records, so that launches stall: no record lost (count within
        max(2, 1%) of the plain version's), nothing dropped, >= 1 stall;
     c. Simulation.simulate_hits of phase 3's cascade with save_photons:
        the record mode launched, records = hits, nothing dropped or
        abandoned, the histogram rebuilt from the records equal to the
        result's, accepted MCPEs against the sum of hit probabilities
        (|z| < 5); wall times of simulate and simulate_hits;
     d. simulate_photons -> npz -> simulate_hits_from_photons: MCPE count
        against 5c's (|z| < 5), (string, om) round trip to the DOM index;
  6. the differentiable ice fit on the fit workload (scripts/fit_demo.py's
     setup with the seeded 171-layer ice, aniso + tilt: 19 strings,
     131,072 one-photon emission points, expected estimator, 48
     iterations):
     a. the threefry stream: rng.make_uniform_stream's bits on the card
        equal the CPU's; the threefry kernel against the kernel fed the
        materialized stream (main-path configuration in expected mode, the
        fit's, and the fit workload; 13a holds the detect modes):
        equal generated and hit counts, histograms equal up to atomic
        order (L1 <= 1e-5 of the total); the threefry kernel against its
        plain version with phase 2's tolerances;
     b. the B6 deposit modes against their plain version on a shared
        stream, phase 2's tolerances: expected + soft + ang_poly
        (test_kernel workload, aniso + tilt), expected + soft (fit
        workload), non-stopping and fixed-horizon detect (main-path
        configuration);
     c. IceFit(forward='fused'): loss at truth on the common stream <= 1e-6
        of the loss at a +-20% lognormal perturbation of the band's
        a_dust400; the autograd gradient (kernel forward, engine backward)
        of three band layers' log scale against central differences of the
        kernel forward (rel GRAD_RTOL); ten Adam steps lower the loss and
        launch the kernel; the gradient at their end point through the
        stream-fed variant of propagate_expected_diff equals the threefry
        one (rel 1e-3); one score-function step on b400 is finite;
        scripts/bench_fit.py's three times (medians of 5), a profiler pass
        and the peak memory;
  7. the global collision plans (B3) and tabulated media (B7) at 262,144
     slots:
     a. each new instantiation against its plain version on one shared
        (32, 8, N) stream, phase 2's tolerances: ic86 (bench.py's IceCube
        layout with DeepCore, 5,080 DOMs) at the default configuration with
        the seeded 171-layer ice (global affine); jittered ic86 (every DOM
        moved by a seeded Gaussian of 0.1 m: general); Antares water on
        jittered ic86 (general x water); a photonics table of the seeded
        ice on hex61 (SubPlans x photonics); the record mode on the first
        three, records matched on (slot, dom) as in 5a;
     b. Simulation.simulate of phase 3's cascade at the centre of ic86 with
        PropagationConfig(n_slots=262144) and otherwise defaults: the
        global-affine instantiation launched, generated = the steps'
        photons, yield within 10% of the PPC formula, nothing dropped or
        abandoned; wall time, propagation time and photons/s;
     c. simulate_hits on jittered ic86 (surveyed positions): records =
        hits, the histogram rebuilt from the records equal to the result's,
        MCPEs against the sum of hit probabilities (|z| < 5);
     d. a KM3NeT/ARCA building block (115 detection units of 18 DOMs at
        ~90 m horizontal and 36 m vertical spacing, DOM radius 0.2159 m,
        each DOM at a surveyed position) in Antares water with
        save_photons: the water instantiations launched, generated = the
        steps' photons, nothing dropped or abandoned; MCPEs with the KM3NeT
        acceptance against the sum of hit probabilities, and the 31-PMT
        multi-PMT hit count;
     e. Simulation.simulate of the cascade on hex61 in the photonics-table
        ice: the photonics instantiation launched, generated = the steps'
        photons, nothing dropped or abandoned;
  8. LED flashers (K1·B4) and the deposit modes on the global plans and
     media (K1·B3/B7 x B6/B8b), on ic86 unless named:
     a. against the plain version on a shared (32, 8, N) stream at 262,144
        slots, phase 2's tolerances and the bound's counts within max(2,
        1%): half the slots on a narrow 405 nm LED table (hex61, aniso +
        tilt), six stacked spectra (source types 0-5), a 23-point
        geomspace bias grid (hex61, L1 <= 4e-3), the first two with
        records, and the expected estimator (global affine, general, water
        on jittered ic86, photonics on hex61), non-stopping and fixed-
        horizon detect, these six also at the steady shape (the state
        advanced STEADY_ADVANCE iterations first), each with its account
        (the barrier's share, rows a tested string);
     b./c. Simulation.simulate of a standard-DOM flash (DOM (0, 30), six
        405 nm LEDs, ~1.3e8 photons after the LED's correction factor) and a
        color-DOM flash (DOM (14, 8), 12 LEDs at 340-505 nm, ~1.9e8
        photons): generated = the steps'
        photons, nothing dropped or abandoned, histogram sum = hit weight;
        each flash's host split;
     d. simulate_hits of the standard-DOM flash (records = hits, MCPEs
        against the sum of hit probabilities);
     e. EventPipeline.process of a cascade, the flash, an empty event and a
        Standard Candle 1 pulse (submission order, per-event counts,
        RunStatistics), and config3_flasher from its pulse through the
        kernel (util.golden.run_config: exact n_generated, hits and
        histogram within 5 sigma of tests/golden/config3_flasher.npz);
     f. the flasher ice fit: one flash as 131,072 one-photon steps, the
        fit's forward (expected + threefry, global affine) against its
        plain version, then 6c's three gates and the peak memory;
     g. each new deposit mode through Simulation.simulate of the
        standard-DOM flash (launched, generated = the steps' photons), its
        wall time beside its launches' kernel time, its host split and its
        account;
  9. the probe kernels (csrc/probes.cu: the Pallas probes P1-P15 as four
     Hopper kernels, H1 table reads, H2 state, H3 op costs and Philox, H4
     atomics, appends, scans) at 262,144 lanes through
     clsim_tpu_torch.probes.run_probes, each variant against its plain
     version (bit for bit where the kernel rounds every product and sum as
     the plain version does, the Philox bits always; the stated tolerances
     for FMA chains, intrinsics, atomic sums and scans); ptxas's registers
     and spills of the state probes; and the main-path kernel's phase 2
     time set against the sum of its work at the probes' rates;
 10. particles to goldens, the oracle and the detailed propagator:
     a. config1_cascade and config2_muon_spice from their particles
        through the kernel (util.golden.run_config, mode 0): n_generated
        equal to the golden's; config1's hits, coarse time groups and
        hottest DOMs within 5 sigma (Philox is not the golden's
        threefry; the weighted counts' variance from E[w^2]/E[w] of the
        hits' weights, recorded by the record mode on the same steps and
        seed), and its slot batch kernel against plain version on a
        shared stream (phase 2's tolerances); config2's histogram
        printed, not held (its golden was frozen with spice_lea, which
        the repository does not hold);
     b. the BASELINE matrix (validate/matrix.py, the workloads of
        tests/test_oracle.py: the cascade with tilt + anisotropy at 4,096
        steps x ORACLE_PHOTONS, a 250 m muon track and a 405 nm flasher
        at 4,096 x MATRIX_PHOTONS, the biased cascade with per-hit
        records at 4,096 x FULL_MATRIX_PHOTONS, with both propagator
        seeds of matrix.SEEDS) through the
        kernel in the Philox mode (the record mode in the biased one) and
        through the port's float64 oracle (host worker processes): every
        statistic of scripts/validate_oracle.py within 5 sigma, generated
        = the steps' photons, unit weights where unbiased, records = hits
        and each record's weight 1 / bias(its wavelength) where biased
        (ROADMAP contract 2);
     c. a DetailedCascadePropagator cascade (beta spread 0.02) through
        Simulation(propagators=[...]).simulate on hex61: generated = the
        steps' photons, steps with beta < 1, histogram sum = hit weight,
        nothing dropped or abandoned, mode 0 launched;
 11. photon tables on the card (the tabulator's kernel, csrc/tabulate.cu:
     its iterations in one CUDA kernel that deals each warp's comb
     sub-steps over its lanes and adds every one into the float64 table on
     the card with atomicAdd, each launch on the slots still live) and
     scatter-history rings:
     a. tabulate of scripts/bench_tabulator.py's workload (65,536 slots x
        32 photons, isotropic 1 mm steps at the origin, 171 homogeneous
        layers, 35 m segments) on the default spherical axes (83,775,864
        float64 bins on the card): finite, positive, every comb weight in
        the table, the kernel launched once a host sync; photons/s and
        profile_device_time of one run, the device busy share and every
        launch an iteration (torch.profiler over one more run), peak
        memory, each kernel launch between CUDA events and the kernel's
        own rate, its account (tab_stats: lane efficiencies, each stage's
        share of the cycles) and the normalization (its wall, its
        division's and copies' device time, a bare first touch of a host
        array of the table's size), each beside the card's name
        and power limit; the kernel against its plain version on the run's
        first 32 iterations (same keys: equal photons made and alive slots,
        counts within max(2, 1%), table L1 <= 2e-3, one atomic a nonzero
        sub-step; the kernel row's times and bound) and on a compacted
        list of half the live slots for 8 more (the same checks, the slots
        off the list unchanged); the eager plain version's first two
        chunks on the card, timed and traced;
     b. the same workload at 8 photons a slot with scattering off, 8
        independent runs: each radial group's content against the float64
        expectation of validate/table_referee.py, |z| < 5 (standard error
        from the runs' spread);
     c. three reduced tables (spherical, cylindrical, spherical with an
        impact-angle axis; 1,024 slots x 1 photon) and the spherical one in
        a tilted anisotropic ice and in a photonics-table ice, the kernel
        on the card against the plain version on the card and on the CPU
        with the same seed: the deposited table's L1 <= 2e-3 of its total
        (the normalized values' printed), n_photons equal; the spherical
        one through save_table_fits / read_fits;
     d. Simulation.simulate of a 1 TeV cascade on the main-path
        configuration with save_photons and 4 ring entries: the engine on
        the card, no kernel launch, min(num_scatters, H) filled entries,
        depths rising in ring order up to the record's depth; on one
        (64, 8, 8192) stream the card's engine records, rings included,
        against the CPU engine's (REC_TOLS, 2e-2 for the ring fields).
 12. photons over ranks (parallel/mesh.py, parallel/bootstrap.py; one
     process a rank):
     a. initialize_distributed at world size 1 (NCCL), then
        Simulation(mesh=global_photon_mesh()).simulate of phase 3's
        cascade: the kernel body served, the main-path instantiation
        launched, nothing dropped or abandoned, histogram sum = hit weight,
        and against propagate_auto on the same slot batches with the seed
        the mesh derives for rank 0 (equal generated counts, hits within
        max(2, 1%), L1 <= 2e-3); the wall after a first call that sets up
        NCCL;
     b. two processes of this script (--mesh-worker) join a gloo group on
        cuda:0 (NCCL refuses two ranks on one device): each propagates its
        process_step_slice of phase 3's slot batches (2 x 262,144 slots)
        through make_sharded_propagate and takes one IceFit(mesh=,
        forward='fused') step on its half of the fit workload; both ranks
        return the same result, K1 launched in each, the all-reduced result
        against one process summing both slices with each rank's seed
        (phase 2's tolerances), the step equal to -lr (g_0 + g_1) with each
        rank's gradient computed in one process (rel 1e-3 in norm) and the
        loss equal to one process's (rel 1e-4); each rank's walls.
 13. every configuration the JAX kernel serves (K1·B4, B5):
     a. in-kernel threefry in stopping, non-stopping, fixed-horizon and
        non-stopping + fixed detect and with records, on the main-path
        configuration and on ic86 at 262,144 slots x 32 iterations: each
        against the same kernel fed rng.make_uniform_stream of the key
        (equal generated and hit counts and record counts, histograms
        equal up to atomic order, L1 <= 1e-5) and against its plain
        version with the key table (phase 2's tolerances and walk steps,
        records by 5a's matching), timed beside its Philox sibling with
        both bounds; then phase 3's cascade through propagate_fused(
        threefry_key=) in each mode on hex61 and on ic86 (one call of
        TF_PATH_T iterations a slot batch; generated = the steps' photons,
        nothing dropped or abandoned, records = hits);
     b. config1_cascade, config2_muon_spice and config3_flasher from their
        particles in their own threefry stream through the kernel (slot
        batch i with fold_in(PRNGKey(GOLDEN_SEED), i), the engine's keys
        in util.golden): n_generated equal to the golden's, hits within
        max(2, 1%), histogram L1 <= 2e-3 of the total, printed beside
        compare_to_golden's 1e-3; config2's histogram and hits against the
        port's engine on the card in the same stream when spice_lea, with
        which its golden was frozen, is not in the repository;
     c. the fit workload with the 11-coefficient hole-ice polynomial
        (HOLE_ICE_H2_50CM) in the expected estimator with threefry: the
        kernel against its plain version (phase 2's tolerances), then 6c's
        gates (loss at truth, the gradient against central differences)
        and one Adam step;
     d. the main-path ice with the Antares scattering angle on the
        closed-form medium (MED_CLOSED_SCAT), detect and expected: the
        kernel against its plain version on phase 2's shared stream (7a's
        checks), and Simulation.simulate of phase 3's cascade in that ice.
 14. the call loop and the event pipeline (no kernel added: K1 launches
     over the live prefix, Params.n_active):
     a. the uneven workload (phase 2's main-path configuration, (i * 7919)
        % 97 photons in slot i) through propagate_fused on a replayed
        (256, 8, N) stream with repack off, on and with balance: every
        launch of the loop also run by the plain version from the same
        state and n_active (phase 2's tolerances on the summed launches),
        generated = the steps' photons, nothing abandoned or dropped,
        histogram sum = hit weight; a launch over a prefix leaves the slots
        past it unchanged bit for bit;
     b. the tail: phase 3's cascade and 8b's flash at iters_per_call 256,
        1024 and 4096 with repack off, on and with balance: each launch's
        ms, n_active, alive after it and live share, each repack's ms, the
        kernel's summed ms and simulate's s (medians of 5);
     c. EventPipeline at max_in_flight 1 (the synchronous loop) and 4 (the
        harvester thread) on 8e's four events four times (ic86 flasher
        Simulation) and on 16 of phase 3's cascades: events/s, photons/s,
        DeviceUtilization <= 1, the wall split; every event equal at both
        depths (generated, hits, per-particle counts; histogram L1 <= 1e-6
        of its total).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SLOTS = 262144
CASCADE_GEV = 1.0e5     # the main path's EMinus cascade
L1_TOL = 2e-3
# tests/test_kernel.py:523-529: (field, absolute tolerance), rtol 1e-3
REC_TOLS = [("dom", 1e-6), ("time", 1e-2), ("wavelength", 1e-2),
            ("weight", 1e-3), ("pos_x", 2e-2), ("pos_y", 2e-2),
            ("pos_z", 2e-2), ("start_x", 2e-2), ("start_time", 1e-2),
            ("num_scatters", 1e-6), ("dir_theta", 1e-3), ("dir_phi", 1e-3),
            ("group_velocity", 2e-4), ("cherenkov_dist", 0.1),
            ("dist_in_abs_lens", 2e-2), ("start_theta", 1e-3)]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5):
    """Run fn `reps` times, each between CUDA events; returns (the last
    result, the median milliseconds)."""
    import torch
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return out, float(np.median(times))


def seeded_ice(n_layers, z_start, layer_height, device, seed=3):
    """Ice with per-layer variation, made like tests/test_kernel.py's."""
    import torch
    from clsim_tpu_torch.medium.properties import make_homogeneous_ice
    medium = make_homogeneous_ice(n_layers=n_layers, z_start=z_start,
                                  layer_height=layer_height, device=device)
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return medium._replace(b400=t(0.02 + 0.03 * r.random(n_layers)),
                           a_dust400=t(0.004 + 0.006 * r.random(n_layers)),
                           delta_tau=t(0.5 + r.random(n_layers))), r


def aniso_tilt(medium, r, aniso, tilt, device):
    """tests/test_kernel.py::_workload's anisotropy and tilt (the tilt's
    z-corrections drawn from `r`)."""
    import torch
    from clsim_tpu_torch.medium.anisotropy import AnisotropyParams
    from clsim_tpu_torch.medium.tilt import TiltParams
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    if aniso:
        medium = medium._replace(anisotropy=AnisotropyParams(
            azimuth=f32(3.9), mag_along=f32(0.04), mag_perp=f32(-0.08),
            enabled=True))
    if tilt:
        medium = medium._replace(tilt=TiltParams(
            distances=f32([-800.0, -200.0, 300.0, 900.0]),
            first_z=f32(-400.0), z_spacing=f32(100.0),
            z_corrections=f32((20.0 * r.standard_normal((4, 9))).tolist()),
            azimuth_cos=f32(math.cos(3.93)), azimuth_sin=f32(math.sin(3.93)),
            enabled=True))
    return medium


def small_workload(n, T, aniso, tilt, device):
    """tests/test_kernel.py::_workload, rebuilt on the port at n slots."""
    import torch
    from clsim_tpu_torch.geometry import hexagonal_geometry
    from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                              stack_spectra)
    from clsim_tpu_torch.types import PropagationConfig
    medium, r = seeded_ice(12, -300.0, 50.0, device)
    medium = aniso_tilt(medium, r, aniso, tilt, device)
    geo = hexagonal_geometry(n_rings=1, string_spacing=60.0,
                             doms_per_string=12, dom_spacing=15.0,
                             z_top=80.0, oversize=8.0, device=device)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)], device=device)
    cfg = PropagationConfig(
        n_slots=n, pancake_factor=4.0, hist_t_min=0.0, hist_t_max=1600.0,
        hist_n_bins=64, max_layer_steps=6, max_segment_m=120.0)
    rr = np.random.default_rng(7)
    costh = rr.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, n)
    steps = step_batch(n, device, x=7.0, y=-3.0, z=11.0, length=2.0,
                       dir_x=sinth * np.cos(phi), dir_y=sinth * np.sin(phi),
                       dir_z=costh, num_photons=3)
    uni = torch.as_tensor(rr.random((T, 8, n)).astype(np.float32),
                          device=device)
    return medium, geo, spectra, cfg, steps, uni


def step_batch(n, device, x, y, z, length, dir_x, dir_y, dir_z, num_photons):
    from clsim_tpu_torch.convert import steps_from_numpy
    full = lambda v: np.broadcast_to(np.asarray(v, np.float64), (n,))
    return steps_from_numpy(dict(
        x=full(x), y=full(y), z=full(z), t=full(0.0), dir_x=full(dir_x),
        dir_y=full(dir_y), dir_z=full(dir_z), length=full(length),
        beta=full(1.0), num_photons=full(num_photons), weight=full(1.0),
        identifier=full(0), source_type=full(0)), device)


def hex61(device):
    from clsim_tpu_torch.geometry import hexagonal_geometry
    return hexagonal_geometry(n_rings=4, string_spacing=125.0,
                              doms_per_string=60, dom_spacing=17.0,
                              z_top=500.0, oversize=5.0, device=device)


def biased_spectra(medium, geo, device):
    """The Cherenkov spectrum biased by the (oversized) DOM acceptance, as
    bench.py and scripts/fit_demo.py build it."""
    from clsim_tpu_torch.hits.acceptance import icecube_dom_acceptance
    from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                              stack_spectra)
    acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                 device="cpu")
    nb = acc.values.shape[0]
    bias_x = float(acc.first_x) + float(acc.dx) * np.arange(nb)
    return stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, medium.min_wlen, medium.max_wlen,
        bias_wlen_nm=bias_x, bias_values=acc.values.numpy())], device=device)


def bench_workload(n, photons_per_slot, device):
    """bench.py::build_workload (hex61) rebuilt on clsim_tpu_torch."""
    from clsim_tpu_torch.medium.properties import make_homogeneous_ice
    from clsim_tpu_torch.sources.ppc import (_rotate_by_angle,
                                             sample_cascade_angles)
    from clsim_tpu_torch.types import PropagationConfig
    medium = make_homogeneous_ice(n_layers=171, z_start=-855.0,
                                  layer_height=10.0, device=device)
    geo = hex61(device)
    spectra = biased_spectra(medium, geo, device)
    cfg = PropagationConfig(n_slots=n, pancake_factor=5.0, hist_n_bins=512,
                            max_layer_steps=4, max_segment_m=35.0,
                            hit_compact_capacity=4096)
    rng = np.random.default_rng(1234)
    c, s = sample_cascade_angles(rng, n)
    dx, dy, dz = _rotate_by_angle(c, s, np.full(n, 0.6), np.zeros(n),
                                  np.full(n, 0.8), rng.random(n))
    longi = 0.63 * rng.standard_gamma(4.5, n)
    steps = step_batch(n, device, x=longi * 0.6, y=0.0, z=longi * 0.8,
                       length=1e-3, dir_x=dx, dir_y=dy, dir_z=dz,
                       num_photons=photons_per_slot)
    return medium, geo, spectra, cfg, steps


def compare(name, c_k, h_k, c_p, h_p, gen_rtol=0.0, l1_tol=L1_TOL):
    from clsim_tpu_torch.propagate import kernel as K
    gen_k, gen_p = float(c_k[K.CNT_GEN]), float(c_p[K.CNT_GEN])
    nh_k, nh_p = float(c_k[K.CNT_HITS]), float(c_p[K.CNT_HITS])
    hp = h_p.double()
    l1 = float((h_k.double() - hp).abs().sum())
    tot = float(hp.sum())
    err = float((h_k.double() - hp).abs().max())
    log(f"  {name}: generated {gen_k:.0f} / {gen_p:.0f}, hits {nh_k:.0f} / "
        f"{nh_p:.0f}, hist L1 {l1:.6g} of total {tot:.6g} (kernel / plain), "
        f"max abs {err:.3g}")
    if abs(gen_k - gen_p) > gen_rtol * gen_p:
        raise AssertionError(f"{name}: generated counts differ")
    if nh_p <= 20:
        raise AssertionError(f"{name}: too few hits to compare")
    if abs(nh_k - nh_p) > max(2.0, 0.01 * nh_p):
        raise AssertionError(f"{name}: hit counts differ")
    if l1 > l1_tol * tot + 1e-6:
        raise AssertionError(f"{name}: histogram L1 {l1} > {l1_tol} x {tot}")
    return err


def match_records(name, rows_k, rows_p, n_bins):
    """Match kernel and plain records on (slot, dom, rank in time) and hold
    each matched pair to REC_TOLS.  Returns (records matched within every
    tolerance, kernel records, plain records)."""
    from clsim_tpu_torch.propagate import kernel as K

    def host(rows):
        rec = K.records_from_rows(rows, n_bins)
        f = {k: v[0].double().cpu().numpy() for k, v in rec.items()}
        slot = rows[:, K.REC_COLUMNS.index("slot")].cpu().numpy()
        order = np.lexsort((f["time"], f["dom"], slot))
        f = {k: v[order] for k, v in f.items()}
        key = slot[order].astype(np.int64) * (1 << 24) + \
            f["dom"].astype(np.int64) * 64
        first = np.r_[True, key[1:] != key[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(len(key)), 0))
        return f, key + np.minimum(np.arange(len(key)) - start, 63)

    fk, key_k = host(rows_k)
    fp, key_p = host(rows_p)
    _, ik, ip = np.intersect1d(key_k, key_p, assume_unique=True,
                               return_indices=True)
    ok = np.ones(len(ik), bool)
    worst = {}
    for field, tol in REC_TOLS:
        a, b = fk[field][ik], fp[field][ip]
        ok &= np.abs(a - b) <= tol + 1e-3 * np.abs(b)
        worst[field] = float(np.abs(a - b).max()) if len(a) else 0.0
    log(f"  {name}: records {len(key_k)} / {len(key_p)} (kernel / plain), "
        f"matched on (slot, dom) {len(ik)}, within tolerance {int(ok.sum())}"
        f"; worst |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return int(ok.sum()), len(key_k), len(key_p)


PHASE2_T = 32


def main_path_inputs(device):
    """Phase 2's main-path configuration: hex61, the seeded 171-layer ice,
    the defaults (90 m segments over 10 m layers, 16 walk steps), the bench
    workload's steps and one (PHASE2_T, 8, N) stream."""
    import torch
    from clsim_tpu_torch.types import PropagationConfig
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    _, geo, spectra, _, steps = bench_workload(N_SLOTS, 200, device)
    cfg = PropagationConfig(n_slots=N_SLOTS, pancake_factor=5.0)
    uni = torch.rand((PHASE2_T, 8, N_SLOTS), generator=torch.Generator(
        device=device).manual_seed(5), device=device)
    return medium, geo, spectra, cfg, steps, uni


def on_ic86(inputs, device):
    """The same inputs on ic86 at the default configuration: the global
    affine plan, mode 32 (every flash and 7b run it)."""
    medium, _, _, cfg, steps, uni = inputs
    g86 = ic86(device)
    return medium, g86, medium_spectra(medium, g86, device), cfg, steps, uni


# the two instantiations the program's paths run (ROADMAP's main path and
# ic86 / the flashes): phase 2 times them in the stream and the Philox mode
MAIN_NAME = "main-path config (hex61, 171 layers, 90 m segments)"
GLOBAL_NAME = "ic86, default config (global affine)"
PHILOX_SEED = 99


def phase2_cases(device):
    """Phase 2's workloads at N_SLOTS with a (PHASE2_T, 8, N) stream:
    [(name, (medium, geo, spectra, cfg, steps, uniforms), gen_rtol)]."""
    T = PHASE2_T
    cases = []
    for aniso, tilt in ((False, False), (True, True)):
        cases.append((f"test_kernel workload aniso={aniso} tilt={tilt}",
                      small_workload(N_SLOTS, T, aniso, tilt, device), 0.0))
    # generated counts within 1e-5: the kernel contracts a*b+c into FMAs
    # and tests the walk's exit by products where torch rounds op by op
    # and divides, and over 32 iterations of 10 m layers a few of ~2e6
    # photons end a step earlier or later in one than the other
    cases.append((MAIN_NAME, main_path_inputs(device), 1e-5))
    return cases


def k1_stats(c, n=None, T=None):
    """The kernel's account from its counters: walk steps, candidates and
    cull passes, and hits a live slot-iteration; DOM rows a tested string;
    SIMT efficiency (live lanes over 32 x warp-iterations with a live lane);
    spawn-path lanes a spawn (32 x warp-iterations that ran the spawn path
    over spawns); the share of each warp's clock cycles spent in the
    block's barriers and the cycles a warp-iteration (CNT_WAIT, CNT_PROP,
    CNT_SPAWN_CYC); with the launch's slots n and iterations T, spawns a
    block-iteration; on the global plans the collision test's share of the
    cycles and its cull's (CNT_COLL_CYC, CNT_CULL_CYC).  A count the body
    lacks (an older checkout under --turns) reads as None."""
    from clsim_tpu_torch.propagate import kernel as K
    c = [] if c is None else c    # a run with no kernel counters
    v = lambda k: (float(c[getattr(K, k)]) if hasattr(K, k)
                   and getattr(K, k) < len(c) else None)
    ratio = lambda a, b: (a / b if a is not None and b else None)
    work = v("CNT_WORK") or 1.0
    cyc = [v(k) for k in ("CNT_WAIT", "CNT_PROP", "CNT_SPAWN_CYC")]
    tot = sum(cyc) if None not in cyc else None
    return dict(walk=ratio(v("CNT_WALK"), work),
                coll_share=ratio(v("CNT_COLL_CYC"), tot),
                cull_share=ratio(v("CNT_CULL_CYC"), tot),
                cand=ratio(v("CNT_CAND"), work),
                cull=ratio(v("CNT_CULL"), work),
                hits=ratio(v("CNT_HITS"), work),
                rows=ratio(v("CNT_ROWS"), v("CNT_TESTED")),
                simt=ratio(v("CNT_WORK"), 32.0 * (v("CNT_WARPS") or 0.0)),
                spawn_lanes=ratio(32.0 * (v("CNT_SPAWN_WARPS") or 0.0),
                                  v("CNT_GEN")),
                spawns_block=(ratio(v("CNT_GEN"), -(-n // 256) * T)
                              if n else None),
                wait_share=ratio(cyc[0], tot),
                spawn_share=ratio(cyc[2], tot),
                cyc_warp=ratio(tot, v("CNT_WARPS")),
                warps=v("CNT_WARPS"), spawn_warps=v("CNT_SPAWN_WARPS"))


def fmt_stats(st):
    f = lambda k, d=4: "n/a" if st[k] is None else f"{st[k]:.{d}f}"
    return (f"walk steps {f('walk')} a slot-iteration, warp-iterations "
            f"{f('warps', 0)} (spawn path {f('spawn_warps', 0)}), SIMT "
            f"efficiency {f('simt')}, spawn-path lanes {f('spawn_lanes', 3)}"
            f" a spawn, spawns {f('spawns_block', 3)} a block-iteration; "
            f"candidates {f('cand', 3)} and cull passes {f('cull', 3)} a "
            f"slot-iteration, rows {f('rows', 3)} a tested string, hits "
            f"{f('hits', 5)} a slot-iteration; barrier share "
            f"{f('wait_share')}, spawn share {f('spawn_share')}, collision "
            f"share {f('coll_share')} (cull {f('cull_share')}), "
            f"{f('cyc_warp', 1)} cycles a warp-iteration")


def check_walk(name, c_k, c_p):
    """The layer-walk steps, kernel against plain, within max(2, 1%)."""
    from clsim_tpu_torch.propagate import kernel as K
    a, b = float(c_k[K.CNT_WALK]), float(c_p[K.CNT_WALK])
    log(f"  {name}: walk steps {a:.0f} / {b:.0f} (kernel / plain)")
    if abs(a - b) > max(2.0, 0.01 * b):
        raise AssertionError(f"{name}: kernel and plain walk steps differ")


def phase2(device):
    """Kernel against plain version, same tensors and uniform stream; the
    two main-path instantiations (mode 0, and mode 32 on ic86) also in the
    Philox mode, with their walk, warp and spawn counts."""
    from clsim_tpu_torch.propagate import kernel as K
    max_err, timings = 0.0, {}
    cases = phase2_cases(device)
    cases.append((GLOBAL_NAME, on_ic86(cases[-1][1], device), 1e-5))
    for name, (medium, geo, spectra, cfg, steps, uni), gen_rtol in cases:
        spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg,
                               N_SLOTS, PHASE2_T)
        tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
        state0, steps_p = K.init_state(steps), K.pack_steps(steps)
        run_k = lambda: K.run_fused_iterations(state0.clone(), steps_p,
                                               tables, spec, uniforms=uni)
        run_p = lambda: K.run_fused_iterations_plain(
            state0.clone(), steps_p, tables, spec, uniforms=uni)
        run_p()      # warm-up: plain, kernel; timed: kernel, plain
        run_k()
        (_, h_k, c_k), ms_k = cuda_ms(run_k)
        (_, h_p, c_p), ms_p = cuda_ms(run_p, reps=1)
        max_err = max(max_err, compare(name, c_k, h_k, c_p, h_p, gen_rtol))
        check_walk(name, c_k, c_p)
        bound = kernel_bound(spec, tables, c_k, "stream")
        st = k1_stats(c_k, N_SLOTS, PHASE2_T)
        log(f"  {name}: mode {K.kernel_mode(spec)}, kernel {ms_k:.3f} ms "
            f"(median of 5), plain {ms_p:.3f} ms ({N_SLOTS} slots x "
            f"{PHASE2_T} iterations); bound {bound[0]:.4f} ms by {bound[1]}; "
            + fmt_stats(st))
        timings[name] = dict(ms=ms_k, plain_ms=ms_p, bound=bound, spec=spec,
                             work=float(c_k[K.CNT_WORK]),
                             gen=float(c_k[K.CNT_GEN]),
                             hits=float(c_k[K.CNT_HITS]), stats=st)
        if name in (MAIN_NAME, GLOBAL_NAME):
            run_x = lambda: K.run_fused_iterations(
                state0.clone(), steps_p, tables, spec, seed=PHILOX_SEED)
            run_x()
            (_, _, c_x), ms_x = cuda_ms(run_x)
            bound_x = kernel_bound(spec, tables, c_x, "philox")
            log(f"  {name}: Philox mode {ms_x:.3f} ms (median of 5); bound "
                f"{bound_x[0]:.4f} ms by {bound_x[1]}; generated "
                f"{float(c_x[K.CNT_GEN]):.0f}, hits {float(c_x[K.CNT_HITS]):.0f}"
                "; " + fmt_stats(k1_stats(c_x, N_SLOTS, PHASE2_T)))
            timings[name].update(ms_philox=ms_x, bound_philox=bound_x)
    return dict(timings[MAIN_NAME], err=max_err, glob=timings[GLOBAL_NAME])


def phase3(device):
    """The main path at full width through Simulation.simulate."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    sim, cascade = main_path_sim(device)
    if sim.step_generator._native is None:
        from clsim_tpu_torch import native
        raise AssertionError("the native step sampler did not load: "
                             f"{native.error()}")
    energy = CASCADE_GEV
    torch.cuda.synchronize()
    K.MODE_LAUNCHES.clear()
    t0 = time.perf_counter()
    res = sim.simulate([cascade], seed=11)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.MODE_LAUNCHES[0]
    diag = res.diagnostics
    n_gen = float(res.n_generated)
    ppm = sim.step_generator.mean_photons_per_meter[0]
    expected = ppm * 5.21 * 0.924 / 0.9216 * energy
    hsum = float(res.hist.double().sum())
    log(f"  launches {launches}, generated {n_gen:.0f} (expected "
        f"{expected:.0f}), hits {float(res.n_hits):.0f}, weight "
        f"{float(res.weight_hits):.6g}, hist sum {hsum:.6g}, dropped "
        f"{diag['dropped']:.0f}, abandoned {diag['abandoned']:.0f}, "
        f"iterations {res.n_iterations}; live slot-iterations "
        f"{diag['work']:.0f}, " + fmt_stats(k1_stats(res.diag_totals)))
    if launches <= 0:
        raise AssertionError("the main path did not launch the kernel")
    if abs(n_gen / expected - 1.0) > 0.1:
        raise AssertionError("photon yield off the PPC formula by > 10%")
    if not float(res.n_hits) > 0:
        raise AssertionError("no hits")
    if not bool(torch.isfinite(res.hist).all()):
        raise AssertionError("non-finite histogram")
    if tuple(res.hist.shape) != (3660, 512):
        raise AssertionError(f"histogram shape {tuple(res.hist.shape)}")
    if abs(hsum / float(res.weight_hits) - 1.0) > 1e-4:
        raise AssertionError("histogram sum differs from the hit weight")
    if diag["dropped"] != 0 or diag["abandoned"] != 0:
        raise AssertionError("photons dropped or abandoned")
    split = host_split(sim, [cascade], 11)
    log(f"  simulate {wall:.3f} s = {n_gen / wall:.6g} photons/s end to end; "
        + fmt_split(split, n_gen))
    return launches


def host_split(sim, sources, seed):
    """Simulation.simulate(sources, seed)'s stages run one after the other
    and timed: the conversion (the step sampler and flasher conversion,
    sources -> steps), the slot assignment, the host-to-device copy of the
    slot batches (steps_from_numpy) and their propagation (propagate_auto,
    the card synchronized).  Uses only what every slice's package has."""
    import torch
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.propagate.dispatch import propagate_auto
    from clsim_tpu_torch.sources.ppc import assign_steps_to_slots
    from clsim_tpu_torch.types import StepBatch
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    merged = StepBatch.concatenate(sim.source_converter.convert(
        [(p, i) for i, p in enumerate(sources)], rng))
    t1 = time.perf_counter()
    batches = assign_steps_to_slots(merged, sim.config.n_slots)
    t2 = time.perf_counter()
    steps = [steps_from_numpy(b._asdict(), sim.device) for b in batches]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for i, st in enumerate(steps):
        quiet(propagate_auto, st, sim.medium, sim.geometry, sim.spectra,
              seed + i, sim.config, backend=sim.backend, **sim.fused_opts)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return dict(steps=int(merged.n_steps), batches=len(batches),
                conversion=t1 - t0, assignment=t2 - t1, copy=t3 - t2,
                propagation=t4 - t3)


def fmt_split(split, photons=None):
    rate = ("" if photons is None else
            f" = {photons / split['propagation']:.6g} photons/s")
    return (f"host split: conversion {split['conversion']:.4f} s "
            f"({split['steps']:.0f} steps), slot assignment "
            f"{split['assignment']:.4f} s ({split['batches']:.0f} batches), "
            f"copy {split['copy']:.4f} s, propagation "
            f"{split['propagation']:.4f} s{rate}")


def run_plain_to_drain(steps, medium, geo, spectra, cfg, seed, ipc=1024):
    """The fused call loop with the plain version on CUDA tensors.  Returns
    the summed counters and, with cfg.save_photons, the number of records."""
    from clsim_tpu_torch.propagate import kernel as K
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg,
                                  int(steps.x.shape[0]), ipc)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    state = K.init_state(steps, spec.records)
    steps_p = K.pack_steps(steps)
    hist, tot, n_rec = None, 0.0, 0
    for call_no in range(256):
        out = K.run_fused_iterations_plain(
            state, steps_p, tables, spec, seed=seed, call_no=call_no,
            hist=hist)
        state, hist, c = out[:3]
        if spec.records:
            n_rec += out[3].shape[0]
        tot = tot + c
        if float(c[K.CNT_ALIVE]) == 0.0:
            return tot, n_rec
    raise AssertionError("plain run did not drain")


def phase4(device, sweep):
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.propagate.dispatch import propagate_auto
    medium, geo, spectra, cfg, steps = bench_workload(N_SLOTS, 200, device)

    def run(**opts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = propagate_auto(steps, medium, geo, spectra, 0, cfg, **opts)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()   # warm-up (table build, first launches)
    secs = []
    for _ in range(3):
        res, sec = run()
        secs.append(sec)
    sec = float(np.median(secs))
    diag = res.diagnostics
    log(f"  generated {diag['generated']:.0f}, hits {diag['hits']:.0f}, "
        f"abandoned {diag['abandoned']:.0f}, iterations {res.n_iterations}: "
        f"{sec:.4f} s (median of " + ", ".join(f"{x:.4f}" for x in secs)
        + f") = {diag['generated'] / sec:.6g} photons/s")
    if diag["generated"] != N_SLOTS * 200:
        raise AssertionError("bench workload: generated != 52,428,800")
    if diag["abandoned"] != 0:
        raise AssertionError("bench workload: photons abandoned")
    if sweep:
        for ipc in (256, 1024, 4096, 16384):
            for _ in range(2):
                r, s = run(iters_per_call=ipc)
                log(f"  sweep iters_per_call={ipc}: {s:.4f} s = "
                    f"{float(r.n_generated) / s:.6g} photons/s, "
                    f"launches {r.n_iterations // ipc}")
    # statistics: kernel (Philox) against plain (torch.Generator)
    n, pps = 16384, 50
    m, g, sp, c, st = bench_workload(n, pps, device)
    res_k = propagate_auto(st, m, g, sp, 21, c)
    tot_p, _ = run_plain_to_drain(st, m, g, sp, c, seed=22)
    pk = float(res_k.n_hits) / float(res_k.n_generated)
    pp = float(tot_p[K.CNT_HITS]) / float(tot_p[K.CNT_GEN])
    var = (pk * (1 - pk) / float(res_k.n_generated)
           + pp * (1 - pp) / float(tot_p[K.CNT_GEN]))
    z = (pk - pp) / math.sqrt(var)
    log(f"  hits per photon: kernel {pk:.6g}, plain {pp:.6g}, z = {z:.3f}")
    if abs(z) >= 5:
        raise AssertionError("kernel and plain version disagree (|z| >= 5)")


def phase5a(device):
    """Record mode against its plain version on phase 2's shared stream."""
    from clsim_tpu_torch.propagate import kernel as K
    cases = phase2_cases(device)
    max_err, timing = 0.0, None
    # on the test_kernel workload every record of the smaller set must match
    # (the kernel's FMA contraction may add or drop a hit, within compare's
    # hit-count allowance); on the main-path configuration >= 99.9% of all
    for (name, (medium, geo, spectra, cfg, steps, uni), gen_rtol), share in (
            (cases[1], None), (cases[2], 0.999)):
        cfg = dataclasses.replace(cfg, save_photons=True)
        spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, N_SLOTS,
                                      PHASE2_T)
        tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
        state0, steps_p = K.init_state(steps, True), K.pack_steps(steps)
        run_k = lambda: K.run_fused_iterations(state0.clone(), steps_p,
                                               tables, spec, uniforms=uni)
        run_p = lambda: K.run_fused_iterations_plain(
            state0.clone(), steps_p, tables, spec, uniforms=uni)
        run_p()      # warm-up: plain, kernel; timed: kernel, plain
        run_k()
        (_, h_k, c_k, r_k), ms_k = cuda_ms(run_k)
        (_, h_p, c_p, r_p), ms_p = cuda_ms(run_p, reps=1)
        name = name + " + records"
        max_err = max(max_err, compare(name, c_k, h_k, c_p, h_p, gen_rtol))
        log(f"  {name}: kernel {ms_k:.3f} ms (median of 5), plain "
            f"{ms_p:.3f} ms ({N_SLOTS} slots x {PHASE2_T} iterations)")
        for who, c, r in (("kernel", c_k, r_k), ("plain", c_p, r_p)):
            if not (r.shape[0] == float(c[K.CNT_HITS])
                    == float(c[K.CNT_QUEUED])):
                raise AssertionError(f"{name}: {who} records != hits")
            if float(c[K.CNT_DROPPED]) != 0.0:
                raise AssertionError(f"{name}: {who} dropped records")
        n_k, n_p = r_k.shape[0], r_p.shape[0]
        if abs(n_k - n_p) > max(2.0, 0.01 * n_p):
            raise AssertionError(f"{name}: record counts differ")
        n_ok, n_k, n_p = match_records(name, r_k, r_p, cfg.hist_n_bins)
        if (n_ok < min(n_k, n_p) if share is None
                else n_ok < share * max(n_k, n_p)):
            raise AssertionError(f"{name}: {n_ok} of {n_k} / {n_p} records "
                                 "match")
        timing = dict(ms=ms_k, plain_ms=ms_p,
                      bound=kernel_bound(spec, tables, c_k, "stream",
                                         n_records=r_k.shape[0]))
    return dict(timing, err=max_err)


def phase5b(device):
    """SAVE_ALL, prescale 0.5, with a record buffer that fills: no record
    may be lost across the stalled launches."""
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, _ = small_workload(N_SLOTS, 1, False,
                                                         False, device)
    cfg = dataclasses.replace(cfg, save_photons=True, save_all_photons=True,
                              save_all_prescale=0.5)
    cap = N_SLOTS // 4   # below the ~1.5 records per slot SAVE_ALL makes
    res, tot = K.propagate_fused(steps, medium, geo, spectra, 31, cfg,
                                 rec_capacity=cap)
    n_k = int(res.rec_count[0])
    tot_p, n_p = run_plain_to_drain(steps, medium, geo, spectra, cfg, seed=32)
    d = res.diagnostics
    log(f"  records {n_k} (kernel, capacity {cap} per launch, "
        f"{d['stalled']:.0f} stalled launches of {res.n_iterations // 4096})"
        f" / {n_p} (plain); generated {d['generated']:.0f} / "
        f"{float(tot_p[K.CNT_GEN]):.0f}, dropped {d['dropped']:.0f}, "
        f"abandoned {d['abandoned']:.0f}")
    if n_k != d["queued"] or not bool((res.rec["weight"] == 0).all()) or \
            not bool((res.rec["dom"] == 0).all()):
        raise AssertionError("SAVE_ALL records malformed")
    if d["dropped"] != 0 or d["abandoned"] != 0:
        raise AssertionError("SAVE_ALL: records dropped or photons abandoned")
    if d["stalled"] < 1:
        raise AssertionError("SAVE_ALL: no launch stalled (capacity too big)")
    if d["generated"] != float(tot_p[K.CNT_GEN]):
        raise AssertionError("SAVE_ALL: generated counts differ")
    if abs(n_k - n_p) > max(2.0, 0.01 * n_p):
        raise AssertionError("SAVE_ALL: record counts differ (records lost)")


def main_path_sim(device, mesh=None, **cfg_kw):
    """Phase 3's Simulation and cascade, with extra config fields (and,
    with a mesh, N_SLOTS slots a rank)."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.sources import Particle, ParticleType
    from clsim_tpu_torch.types import PropagationConfig
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    sim = Simulation(medium=medium, geometry=hex61(device), mesh=mesh,
                     config=PropagationConfig(n_slots=N_SLOTS, **cfg_kw))
    cascade = Particle.cascade(ParticleType.EMinus, pos=(0.0, 0.0, 0.0),
                               time=0.0, energy=CASCADE_GEV, zenith=1.9,
                               azimuth=0.7)
    return sim, cascade


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hit_probabilities(sim, rec):
    """Per-record MCPE acceptance probability, clipped to [0, 1]."""
    import torch
    from clsim_tpu_torch.hits.mcpe import cos_impact, hit_probability
    p = hit_probability(rec["weight"][0], rec["wavelength"][0],
                        cos_impact(rec["dir_theta"][0], rec["dir_phi"][0]),
                        sim.wlen_acceptance, sim.angular_coeffs)
    return torch.clamp(p.double(), 0.0, 1.0)


def phase5c(device):
    """simulate_hits on the main path through the kernel's record mode."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    sim, cascade = main_path_sim(device, save_photons=True)
    sim0, _ = main_path_sim(device)
    cfg = sim.config
    # the propagation stage alone, without and with records, in turns
    # (without, with, with, without) after one warm-up of each
    batches = sim.steps_from_particles([cascade], np.random.default_rng(11))
    prop = {False: [], True: []}
    for rec in (False, True, False, True, True, False):
        s = sim if rec else sim0
        _, sec = timed(lambda: s.run_steps(batches, 11))
        prop[rec].append(sec)
    t_prop = {k: float(np.median(v[1:])) for k, v in prop.items()}
    log(f"  propagation stage {t_prop[False]:.4f} s without records, "
        f"{t_prop[True]:.4f} s with (medians of 2 after a warm-up each)")
    # end to end: simulate without and with records, then simulate_hits
    _, t_plain = timed(lambda: sim0.simulate([cascade], seed=11))
    res, t_rec = timed(lambda: sim.simulate([cascade], seed=11))
    K.MODE_LAUNCHES.clear()
    hits, t_hits = timed(lambda: sim.simulate_hits([cascade], seed=11))
    launches, main_launches = (K.MODE_LAUNCHES[K.MODE_RECORDS],
                               K.MODE_LAUNCHES[0])
    diag = res.diagnostics
    n_rec, n_hits = int(res.rec_count[0]), float(res.n_hits)
    log(f"  simulate {t_plain:.4f} s without records, {t_rec:.4f} s with "
        f"records ({n_rec / t_prop[True]:.6g} records/s in the propagation "
        f"stage), simulate_hits "
        f"{t_hits:.4f} s; record-mode launches {launches}, main-mode "
        f"launches {main_launches}; records {n_rec}, hits {n_hits:.0f}, "
        f"generated {diag['generated']:.0f}, dropped {diag['dropped']:.0f}, "
        f"abandoned {diag['abandoned']:.0f}, stalled {diag['stalled']:.0f}")
    if launches <= 0 or main_launches != 0:
        raise AssertionError("simulate_hits did not run the record mode")
    if n_rec != n_hits or n_rec <= 0:
        raise AssertionError("records != hits")
    if diag["dropped"] != 0 or diag["abandoned"] != 0:
        raise AssertionError("records dropped or photons abandoned")
    rec = res.rec
    nb = cfg.hist_n_bins
    tb = torch.clamp((rec["time"][0] - cfg.hist_t_min) / cfg.hist_dt, 0.0,
                     nb - 1).to(torch.int64)
    rebuilt = torch.zeros(res.hist.numel(), dtype=torch.float64,
                          device=device).index_add_(
        0, rec["dom"][0].to(torch.int64) * nb + tb, rec["weight"][0].double())
    h = res.hist.reshape(-1).double()
    err = float((rebuilt - h).abs().max())
    log(f"  histogram from records: max |diff| {err:.3g} of max bin "
        f"{float(h.max()):.6g}, sums {float(rebuilt.sum()):.8g} / "
        f"{float(h.sum()):.8g}")
    if not bool(((rebuilt - h).abs() <= 1e-4 * h.abs() + 1e-6).all()):
        raise AssertionError("histogram rebuilt from records differs")
    p = hit_probabilities(sim, rec)
    mean, var = float(p.sum()), float((p * (1 - p)).sum())
    n_mcpe = len(hits[0])
    z = (n_mcpe - mean) / math.sqrt(var)
    log(f"  MCPEs {n_mcpe}, expected {mean:.6g} (sum of hit probabilities),"
        f" z = {z:.3f}")
    if abs(z) >= 5 or not np.all(np.diff(hits[1]) >= 0):
        raise AssertionError("MCPE count off its expectation (|z| >= 5) or "
                             "MCPEs not time-ordered")
    return launches, sim, cascade, res, n_mcpe, var


def phase5d(sim, cascade, res, n_mcpe, var):
    """Two-phase flow: simulate_photons -> npz -> simulate_hits_from_photons."""
    from clsim_tpu_torch.hits.photons import (photon_batch_dom_index,
                                              records_to_photon_batch)
    geo = sim.geometry
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "photons.npz")
        (batch, t_ph) = timed(lambda: sim.simulate_photons(
            [cascade], seed=11, save_path=path))
        (hits, t_h) = timed(lambda: sim.simulate_hits_from_photons(
            path, seed=12))
    n2 = len(hits[0])
    z = (n2 - n_mcpe) / math.sqrt(2.0 * var)
    idx = photon_batch_dom_index(batch, geo)
    sid = geo.dom_string_id.cpu().numpy()
    oid = geo.dom_om_id.cpu().numpy()
    own = records_to_photon_batch(res.rec, res.rec_count, geo)
    own_idx = photon_batch_dom_index(own, geo)
    log(f"  simulate_photons {t_ph:.4f} s ({len(batch.time)} photons), "
        f"simulate_hits_from_photons {t_h:.4f} s: MCPEs {n2} against "
        f"{n_mcpe} in 5c, z = {z:.3f}")
    if len(batch.time) != int(res.rec_count[0]) or abs(z) >= 5:
        raise AssertionError("two-phase flow disagrees with simulate_hits")
    if not ((sid[idx] == batch.string_id).all()
            and (oid[idx] == batch.om_id).all()
            and (own_idx == res.rec["dom"][0].cpu().numpy()).all()):
        raise AssertionError("(string, om) does not round-trip to the DOM")


# ---------------------------------------------------------------------------
# phase 6: the differentiable ice fit (expected estimator, threefry)
# ---------------------------------------------------------------------------

FIT_SLOTS = 131072
FIT_T = 48
FIT_KEY = (0, 2024)
FIT_BAND = (-350.0, 350.0)     # fit the layers whose centres lie inside
GRAD_LAYERS = (10, 35, 60)     # band layers of the gradient check
GRAD_RTOL = 0.02               # tests/test_diff.py's tolerance
ANG_POLY = (0.3, 0.6)          # the expected estimator's angular polynomial


def fit_workload(device, n=None):
    """scripts/fit_demo.py::build on the port, with chip_smoke's seeded
    171-layer ice (10 m layers) in place of spice_lea, anisotropy and tilt
    on as small_workload builds them: a 19-string hex, 131,072 isotropic
    one-photon emission points (xy within 220 m, z in [-450, 450]), the
    acceptance-biased spectrum, the expected estimator with soft binning
    and an 8 absorption-length horizon, 128 bins over 3000 ns."""
    from clsim_tpu_torch.geometry import hexagonal_geometry
    from clsim_tpu_torch.types import PropagationConfig
    n = n or FIT_SLOTS
    medium, r = seeded_ice(171, -855.0, 10.0, device)
    medium = aniso_tilt(medium, r, True, True, device)
    geo = hexagonal_geometry(n_rings=2, string_spacing=125.0,
                             doms_per_string=60, dom_spacing=17.0,
                             z_top=500.0, oversize=5.0, device=device)
    spectra = biased_spectra(medium, geo, device)
    cfg = PropagationConfig(n_slots=n, estimator="expected",
                            soft_binning=True, fixed_abs_lens=8.0,
                            pancake_factor=5.0, hist_t_min=0.0,
                            hist_t_max=3000.0, hist_n_bins=128,
                            max_layer_steps=4, max_segment_m=35.0)
    rr = np.random.default_rng(4242)
    costh = rr.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, n)
    r_xy = 220.0 * np.sqrt(rr.random(n))
    a_xy = rr.uniform(0, 2 * np.pi, n)
    steps = step_batch(n, device, x=r_xy * np.cos(a_xy),
                       y=r_xy * np.sin(a_xy), z=rr.uniform(-450.0, 450.0, n),
                       length=1e-3, dir_x=sinth * np.cos(phi),
                       dir_y=sinth * np.sin(phi), dir_z=costh, num_photons=1)
    return medium, geo, spectra, cfg, steps


def kernel_run(medium, geo, spectra, cfg, steps, T, uniforms=None,
               key=None, plain=False):
    """One launch of T iterations (or its plain version) from fresh state;
    returns a thunk for cuda_ms and the spec and tables."""
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    n = int(steps.x.shape[0])
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T,
                                  threefry=key is not None)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    state0, steps_p = K.init_state(steps), K.pack_steps(steps)
    keys = None if key is None else rng.key_table(key, T).to(state0.device)
    fn = K.run_fused_iterations_plain if plain else K.run_fused_iterations
    return (lambda: fn(state0.clone(), steps_p, tables, spec,
                       uniforms=uniforms, keys=keys)), spec, tables


# Operations of one slot-iteration of csrc/propagate.cu, counted from its
# source (float and integer operations alike, transcendentals as one): the
# least every live slot does in an iteration (budgets, one layer-walk step,
# the cull of every candidate string of each SubPlan, advance, scatter,
# retire; no DOM test), plus a spawn's work for each photon generated, plus
# the random numbers: Philox 28, threefry 81 operations per uniform, none
# for an external stream (4 uniforms an iteration, 4 more at a spawn).
OPS_ITER, OPS_PER_CAND, OPS_PER_PLAN, OPS_SPAWN = 107, 14, 14, 130
OPS_ANISO, OPS_TILT = 65, 30
OPS_RNG = {"philox": 28, "stream": 0, "threefry": 81}
# The global plans (COLL 1, 2) and the tabulated media (MED 1, 2) count
# their data-dependent work in the kernel's counters (kernel.py CNT_*), and
# the bound charges only that: OPS_PER_PLAN for the cell lookup of a live
# slot-iteration and OPS_SECTOR for its azimuth sector (two |.|, the
# CULL_MAX_SUB - 1 products, comparisons and sums, the quadrant, the clamp
# and the list's index); OPS_PER_CAND (the SubPlan cull's 2-D
# point-to-segment test) for each candidate of the (cell, sector)'s list
# (CNT_CAND); OPS_ZPASS (z against the candidate's extent +- r)
# for each that passes the 2-D cull (CNT_CULL); a round's set-up for each
# string tested (CNT_TESTED); and one sphere test for each DOM tested
# (CNT_ROWS): n_dom_cand ladder DOMs a string on the affine path (window
# index, clamp, oz, urdot, dr2, discriminant, entry distance, compare), the
# rows of the segment's z-window on the general path (the DOM position from
# the residual row, the 3-D dot products, the same discriminant and entry
# distance), whose round set-up computes the window (the string and the
# ladder's rows of the segment's ends, their min and max, ceil and floor
# of them -+ the half-width, the clamps to the string's rows, the row
# count).  The ranking of the passes into the rounds is not charged.
OPS_ZPASS, OPS_ROUND_AFFINE, OPS_ROUND_GENERAL = 4, 12, 16
OPS_SECTOR = 28
OPS_SPHERE_AFFINE, OPS_SPHERE_GENERAL = 16, 23
# A tabulated medium's spawn lerps its factors where the closed form takes
# pow/exp: OPS_SPAWN holds the closed form's gs, pa, qa, ra (13: two powf,
# an expf, their divisions and products), a tabulated spawn does the grid
# index (9: offset, scale, floor, clamps, fraction) and four lerps of 3
# (21), and with `ref_table` two more lerps (6) in place of the index
# polynomials (18: two degree-4 Horner forms, the scale, the product).
OPS_FACTORS_CLOSED, OPS_FACTORS_TABLE = 13, 21
OPS_INDEX_POLY, OPS_INDEX_TABLE = 18, 6
# Sea water (MED 2) runs no HG/Liu choice: OPS_ITER's share of it (17: the
# branch test and HG's solve, the longer branch) goes, and each scatter
# (CNT_SCAT) draws one branch: Rayleigh's closed cubic (19 with its test,
# CNT_RAYLEIGH) or the Petzold angle, located in its n_scat-point CDF (4 a
# bisection step, 3 the clamp), solved as the wavelength is (22) and its
# cosine taken (with the test, 27 besides the bisection).
OPS_HG_LIU, OPS_RAYLEIGH, OPS_PETZOLD, OPS_BISECT = 17, 19, 27, 4
# The closed-form ice with the tabulated angle (MED 3) spawns as MED 0 does
# and scatters as water does.  The expected estimator's angular polynomial
# costs a clamp and the cosine (7) and one Horner step (2) a coefficient at
# each deposit (CNT_HITS).
OPS_ANG_SETUP, OPS_ANG_COEF = 7, 2
# Flasher spectra (K1·B4): with stacked spectra a spawn offsets the spectrum
# table by its step's source_type (OPS_TABLE: the conversion to int and the
# multiply-add).  OPS_SPAWN holds the uniform bias grid's index math
# (OPS_BIAS_UNIFORM: offset, scale, floor, two clamps, the fraction); a
# non-uniform grid replaces it by the wavelength's clamp to the grid, a
# bisection over its n_bias points (OPS_BISECT a step) and the fraction's
# division and clamps (OPS_BIAS_SEARCH).
OPS_TABLE, OPS_BIAS_UNIFORM, OPS_BIAS_SEARCH = 3, 6, 6
# OPS_ITER holds one layer-walk step; every further step (CNT_WALK beyond
# one a live slot-iteration) costs the loop index and its clamp (4), the
# two rates (5), the exit tests (6) and the two budgets and the next
# boundary (5)
OPS_WALK_STEP = 20
FP32_PEAK = 67e12              # H100 SXM dense float32 peak
HBM_BYTES_S = 3.35e12


def kernel_bound(spec, tables, counters, rng_mode, n_records=0):
    """(bound_ms, bound_by): the larger of the operations this run needed
    over the float32 peak and the bytes the launch must move (state read
    and written, steps and tables read once, histogram and records written
    once, and of an external stream the rows the run reads: rows 4-7 in
    every live slot-iteration, rows 0-3 at every spawn, 16 bytes each)
    over the HBM rate.  The global plans' collision work, sea water's
    scatters and the layer-walk steps count from the run's counters
    (CNT_CAND ... CNT_WALK)."""
    from clsim_tpu_torch.propagate import kernel as K
    N, T = spec.n_slots, spec.iters_per_call
    cnt = lambda k: float(counters[k])
    work, gen = cnt(K.CNT_WORK), cnt(K.CNT_GEN)
    coll, med = K.kernel_coll(spec), K.kernel_med(spec)
    tab_angle = med in (K.MED_WATER, K.MED_CLOSED_SCAT)
    per_iter = (OPS_ITER + 4 * OPS_RNG[rng_mode]
                + sum(OPS_PER_PLAN + OPS_PER_CAND * p.K_cand
                      for p in spec.sub_plans)
                + (OPS_PER_PLAN + OPS_SECTOR if coll != K.COLL_SUBPLANS
                   else 0)
                - (OPS_HG_LIU if tab_angle else 0)
                + (OPS_ANISO if spec.aniso else 0)
                + (OPS_TILT if spec.nz_tilt else 0))
    per_spawn = OPS_SPAWN + 4 * OPS_RNG[rng_mode]
    if med in (K.MED_TABLES, K.MED_WATER):
        per_spawn += (OPS_FACTORS_TABLE - OPS_FACTORS_CLOSED
                      + (OPS_INDEX_TABLE - OPS_INDEX_POLY
                         if spec.ref_table else 0))
    if spec.n_tables > 1:
        per_spawn += OPS_TABLE
    if not spec.bias_uniform:
        per_spawn += (OPS_BIAS_SEARCH - OPS_BIAS_UNIFORM + OPS_BISECT
                      * math.ceil(math.log2(spec.n_bias + 1)))
    round_ops, sphere_ops = {
        K.COLL_SUBPLANS: (0, 0),
        K.COLL_AFFINE: (OPS_ROUND_AFFINE, OPS_SPHERE_AFFINE),
        K.COLL_GENERAL: (OPS_ROUND_GENERAL, OPS_SPHERE_GENERAL)}[coll]
    petzold = OPS_PETZOLD + OPS_BISECT * math.ceil(math.log2(spec.n_scat + 1))
    ops = (work * per_iter + gen * per_spawn
           + max(cnt(K.CNT_WALK) - work, 0.0) * OPS_WALK_STEP
           + cnt(K.CNT_CAND) * OPS_PER_CAND + cnt(K.CNT_CULL) * OPS_ZPASS
           + cnt(K.CNT_TESTED) * round_ops + cnt(K.CNT_ROWS) * sphere_ops
           + cnt(K.CNT_RAYLEIGH) * OPS_RAYLEIGH
           + (cnt(K.CNT_SCAT) - cnt(K.CNT_RAYLEIGH)) * petzold
           + (cnt(K.CNT_HITS) * (OPS_ANG_SETUP + OPS_ANG_COEF
                                 * len(spec.ang_poly))
              if spec.expected and spec.ang_poly else 0.0))
    rows = K.NSF + (K.NRSF if spec.records else 0)
    nbytes = 4 * (2 * rows * N + K.NST * N + spec.n_doms * spec.hist_n_bins
                  + sum(t.numel() for t in (
                      tables.layers, tables.spec_tab, tables.bias_tab,
                      tables.tilt_zc, tables.cells, tables.rel,
                      tables.strings, tables.wtab, tables.scat))
                  + len(spec.ang_poly)
                  + {"stream": 4 * (work + gen),
                     "threefry": 2 * T}.get(rng_mode, 0)
                  + K.NRC * n_records)
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def device_busy(fn):
    """(device busy share, kernel launches, wall seconds) of one call of fn
    under torch.profiler: the summed time of the device kernels over the
    wall time; None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return busy_of(prof, wall)


def busy_of(prof, wall):
    """device_busy's figures from a finished profiler and the wall."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in kernels)
    return (dev_us * 1e-6 / wall if dev_us > 0 else None), len(kernels), wall


def phase6a(device):
    """The threefry stream: card against CPU bits, the threefry kernel
    against the kernel fed the materialised stream, and against its plain
    version."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    key = rng.as_key(FIT_KEY)
    u_gpu = rng.make_uniform_stream(key.to(device), FIT_T, FIT_SLOTS)
    u_cpu = rng.make_uniform_stream(key, FIT_T, FIT_SLOTS)
    same = bool((u_gpu.cpu().view(torch.int32) == u_cpu.view(torch.int32))
                .all())
    log(f"  rng.make_uniform_stream {tuple(u_gpu.shape)}: card and CPU bits "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("threefry bits differ between card and CPU")
    del u_cpu
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    _, geo, spectra, _, steps = bench_workload(N_SLOTS, 200, device)
    from clsim_tpu_torch.types import PropagationConfig
    # the fit's forward: the main-path configuration in the expected mode
    # (13a holds threefry in the detect modes)
    main_cfg = PropagationConfig(n_slots=N_SLOTS, pancake_factor=5.0,
                                 estimator="expected", soft_binning=True)
    fit = fit_workload(device)
    out = {}
    for name, (m, g, sp, cfg, st), T in (
            ("main-path config (expected)", (medium, geo, spectra, main_cfg,
                                             steps), PHASE2_T),
            ("fit workload (expected)", fit, FIT_T)):
        uni = rng.make_uniform_stream(key.to(device), T,
                                      int(st.x.shape[0]))
        run_tf, spec, tables = kernel_run(m, g, sp, cfg, st, T, key=key)
        run_st, _, _ = kernel_run(m, g, sp, cfg, st, T, uniforms=uni)
        run_tf()
        (_, h_t, c_t), ms_t = cuda_ms(run_tf)
        (_, h_s, c_s), ms_s = cuda_ms(run_st)
        l1 = float((h_t.double() - h_s.double()).abs().sum())
        tot = float(h_s.double().sum())
        log(f"  {name}: threefry kernel {ms_t:.3f} ms, stream-fed kernel "
            f"{ms_s:.3f} ms (medians of 5, {int(st.x.shape[0])} slots x {T}"
            f"); generated {float(c_t[K.CNT_GEN]):.0f} / "
            f"{float(c_s[K.CNT_GEN]):.0f}, hits {float(c_t[K.CNT_HITS]):.0f}"
            f" / {float(c_s[K.CNT_HITS]):.0f}, hist L1 {l1:.6g} of {tot:.6g}")
        if float(c_t[K.CNT_GEN]) != float(c_s[K.CNT_GEN]) or \
                float(c_t[K.CNT_HITS]) != float(c_s[K.CNT_HITS]):
            raise AssertionError(f"{name}: threefry and stream-fed kernel "
                                 "counts differ")
        if l1 > 1e-5 * tot:
            raise AssertionError(f"{name}: threefry and stream-fed kernel "
                                 "histograms differ beyond atomic order")
        del uni
        run_pl, _, _ = kernel_run(m, g, sp, cfg, st, T, key=key, plain=True)
        (_, h_p, c_p), ms_p = cuda_ms(run_pl, reps=1)
        err = compare(name + ", threefry kernel / plain", c_t, h_t, c_p, h_p,
                      1e-5 if cfg is main_cfg else 0.0)
        log(f"  {name}: threefry bound "
            f"{kernel_bound(spec, tables, c_t, 'threefry')}, stream-fed "
            f"bound {kernel_bound(spec, tables, c_s, 'stream')}")
        out[name] = dict(ms=ms_t, plain_ms=ms_p, err=err,
                         bound=kernel_bound(spec, tables, c_t, "threefry"))
    return out["fit workload (expected)"]


def phase6b(device):
    """The B6 deposit modes against their plain version on a shared
    stream (phase 2's tolerances)."""
    import torch
    from clsim_tpu_torch.types import PropagationConfig
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    _, geo, spectra, _, steps = bench_workload(N_SLOTS, 200, device)
    main_cfg = PropagationConfig(n_slots=N_SLOTS, pancake_factor=5.0)
    gen = torch.Generator(device=device).manual_seed(6)
    uni = torch.rand((max(FIT_T, PHASE2_T), 8, max(N_SLOTS, FIT_SLOTS)),
                     generator=gen, device=device)
    m_s, g_s, s_s, c_s, st_s, _ = small_workload(N_SLOTS, 1, True, True,
                                                 device)
    c_s = dataclasses.replace(c_s, estimator="expected", soft_binning=True,
                              expected_angular_poly=ANG_POLY)
    fit = fit_workload(device)
    cases = [
        ("test_kernel workload aniso+tilt, expected + soft + ang_poly",
         (m_s, g_s, s_s, c_s, st_s), PHASE2_T,
         uni[:, :, :N_SLOTS].contiguous(), 0.0),
        ("fit workload, expected + soft", fit, FIT_T,
         uni[:, :, :FIT_SLOTS].contiguous(), 0.0),
        ("main-path config, non-stopping detect",
         (medium, geo, spectra,
          dataclasses.replace(main_cfg, stop_on_detection=False), steps),
         PHASE2_T, uni[:, :, :N_SLOTS].contiguous(), 1e-5),
        ("main-path config, fixed_abs detect",
         (medium, geo, spectra,
          dataclasses.replace(main_cfg, fixed_abs_lens=8.0), steps),
         PHASE2_T, uni[:, :, :N_SLOTS].contiguous(), 1e-5)]
    # propagate[expected]'s err and times are those of the expected
    # instantiation (the first two cases); the detect modes are other
    # instantiations, checked here and reported on their own line
    max_err, timing = {True: 0.0, False: 0.0}, None
    for name, (m, g, sp, cfg, st), T, u, gen_rtol in cases:
        u = u[:T].contiguous()
        run_k, spec, tables = kernel_run(m, g, sp, cfg, st, T, uniforms=u)
        run_p, _, _ = kernel_run(m, g, sp, cfg, st, T, uniforms=u,
                                 plain=True)
        run_p()
        run_k()
        (_, h_k, c_k), ms_k = cuda_ms(run_k)
        (_, h_p, c_p), ms_p = cuda_ms(run_p, reps=1)
        err = compare(name, c_k, h_k, c_p, h_p, gen_rtol)
        max_err[spec.expected] = max(max_err[spec.expected], err)
        log(f"  {name}: kernel {ms_k:.3f} ms (median of 5), plain "
            f"{ms_p:.3f} ms ({spec.n_slots} slots x {T} iterations), "
            f"bound {kernel_bound(spec, tables, c_k, 'stream')}")
        if name.startswith("fit workload"):
            timing = dict(ms=ms_k, plain_ms=ms_p,
                          bound=kernel_bound(spec, tables, c_k, "stream"))
    log(f"  max abs err: expected {max_err[True]:.3g}, detect modes "
        f"{max_err[False]:.3g}")
    return dict(timing, err=max_err[True])


def fit_gates(device, workload, grad_layers, adam_steps=10):
    """The fit's three gates on a workload, IceFit(forward='fused'): the
    loss at truth on the common stream <= 1e-6 of the loss at a +-20%
    lognormal perturbation of the band's a_dust400; the autograd gradient
    (kernel forward, engine backward) of grad_layers' log scale against
    central differences of the kernel forward (rel GRAD_RTOL); `adam_steps`
    Adam steps lower the loss.  Launch counts are zeroed before the Adam steps.
    Returns what phase 6c reads further."""
    import functools
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.parallel.mesh import IceFit
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps = workload
    key = rng.as_key(FIT_KEY)
    L = medium.n_layers
    centres = float(medium.layers_z_start) + (np.arange(L) + 0.5) * \
        float(medium.layer_height)
    band = np.nonzero((centres > FIT_BAND[0]) & (centres < FIT_BAND[1]))[0]
    lo, hi = int(band[0]), int(band[-1]) + 1
    a_true, b_true = medium.a_dust400.clone(), medium.b400.clone()
    pert = torch.as_tensor(np.random.default_rng(99).normal(
        0.0, 0.2, hi - lo).astype(np.float32), device=device)

    def band_field(true):
        return lambda p: torch.cat([true[:lo], true[lo:hi] * torch.exp(
            p["log_s"]), true[hi:]])

    tf_a = lambda p: {"a_dust400": band_field(a_true)(p)}
    tf_b = lambda p: {"b400": band_field(b_true)(p)}
    torch.cuda.reset_peak_memory_stats()
    fit = IceFit(cfg, geo, spectra, forward="fused", max_iterations=FIT_T,
                 param_transform=tf_a)
    # the target: the kernel forward at the truth on IceFit's stream
    with torch.no_grad():
        k0 = fit.step_key(key)
        target = fit.one_forward(medium, steps, k0)
        again = fit.one_forward(medium, steps, k0)
    noise = float((target.double() - again.double()).abs().sum())
    loss = lambda x: float(fit.loss_fn({"log_s": x}, medium, steps, key,
                                       target))
    zero = torch.zeros(hi - lo, device=device)
    with torch.no_grad():
        l_truth, l_start = loss(zero), loss(pert)
    log(f"  target: hist sum {float(target.double().sum()):.6g}, "
        f"{int((target > 0).sum())} of {target.numel()} bins filled; "
        f"run-to-run L1 of two forwards {noise:.3g}; fit band layers "
        f"[{lo}, {hi}); loss at truth {l_truth:.6g}, at the perturbed "
        f"start {l_start:.6g} (ratio {l_truth / l_start:.3g})")
    if not (l_start > 0 and l_truth <= 1e-6 * l_start):
        raise AssertionError("loss at truth is not ~0 on the common stream")
    # the gradient check: autograd (engine backward) against central
    # differences of the kernel forward, at the perturbed start
    x = pert.clone().requires_grad_(True)
    g = torch.autograd.grad(fit.loss_fn({"log_s": x}, medium, steps, key,
                                        target), x)[0]
    h = 0.02
    worst = 0.0
    for j in grad_layers:
        e = torch.zeros_like(pert)
        e[j] = h
        with torch.no_grad():
            fd = (loss(pert + e) - loss(pert - e)) / (2 * h)
        rel = abs(float(g[j]) / fd - 1.0)
        worst = max(worst, rel)
        log(f"  d loss / d log a_dust400[{lo + j}]: autograd "
            f"{float(g[j]):.6g}, central difference (h {h}) {fd:.6g}, "
            f"rel {rel:.3g}")
    if worst > GRAD_RTOL:
        raise AssertionError(f"gradient off its finite difference by "
                             f"{worst:.3g} > {GRAD_RTOL}")
    # Adam steps in log space from the perturbed start
    adam = IceFit(cfg, geo, spectra, forward="fused", max_iterations=FIT_T,
                  param_transform=tf_a,
                  optimizer=functools.partial(torch.optim.Adam, lr=0.05))
    p, losses = {"log_s": pert.clone()}, []
    torch.cuda.synchronize()
    K.MODE_LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(adam_steps):
        p, l_k = adam.step(p, medium, steps, key, target)
        losses.append(float(l_k))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    with torch.no_grad():
        l_end = loss(p["log_s"])
    log(f"  Adam (lr 0.05) {adam_steps} steps in {t_steps:.3f} s: loss "
        + " ".join(f"{v:.5g}" for v in losses) + f" -> {l_end:.5g}; "
        f"|log scale - truth| {float(pert.norm()):.4f} -> "
        f"{float(p['log_s'].norm()):.4f}")
    if not l_end < losses[0]:
        raise AssertionError("the fit did not lower the loss")
    return dict(key=key, pert=pert, target=target, tf_a=tf_a, tf_b=tf_b,
                b_true=b_true, adam=adam, p=p, loss=loss)


def phase6c(device):
    """The fit itself at full width: IceFit(forward='fused') on the fit
    workload, kernel forward and engine-autograd backward."""
    import torch
    from clsim_tpu_torch.parallel.mesh import IceFit
    from clsim_tpu_torch.propagate import engine as E
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.propagate.diff import propagate_expected_diff
    medium, geo, spectra, cfg, steps = fit_workload(device)
    f = fit_gates(device, (medium, geo, spectra, cfg, steps), GRAD_LAYERS)
    key, pert, target, adam, p = (f["key"], f["pert"], f["target"],
                                  f["adam"], f["p"])
    tf_a, tf_b, b_true = f["tf_a"], f["tf_b"], f["b_true"]
    # the gradient at the end point through both variants of
    # propagate_expected_diff: in-kernel threefry (IceFit's) and the
    # stream-fed kernel reading rng.make_uniform_stream of the same key.
    # The backward is the engine on the same numbers and the forwards
    # differ only in atomic order, so the two agree to rel 1e-3
    k1 = adam.step_key(key)
    grads = {}
    for tf in (True, False):
        x = p["log_s"].clone().requires_grad_(True)
        h = propagate_expected_diff(steps, medium._replace(**tf_a(
            {"log_s": x})), geo, spectra, k1, adam.cfg, n_iterations=FIT_T,
            use_threefry=tf)
        chi2 = ((h - target) ** 2).sum() / torch.clamp(target.sum(), min=1.0)
        grads[tf] = torch.autograd.grad(chi2, x)[0]
    torch.cuda.synchronize()
    launches_e = K.MODE_LAUNCHES[K.DEP_EXPECTED]
    launches_t = K.MODE_LAUNCHES[K.DEP_EXPECTED | K.MODE_THREEFRY]
    g_rel = float((grads[False] - grads[True]).norm() / grads[True].norm())
    log(f"  gradient at the end point, stream-fed against threefry forward:"
        f" rel {g_rel:.3g} (norm {float(grads[True].norm()):.6g}); kernel "
        f"launches (ten steps, the end loss and the two gradients) expected "
        f"+ stream {launches_e}, expected + threefry {launches_t}")
    if not g_rel <= 1e-3:
        raise AssertionError("stream-fed and threefry gradients differ")
    if device.type == "cuda" and (launches_e <= 0 or launches_t <= 0):
        raise AssertionError("the fit's forward did not launch the kernel")
    # one score-function step on b400
    fit_b = IceFit(cfg, geo, spectra, forward="fused", max_iterations=FIT_T,
                   param_transform=tf_b, learning_rate=1e-3)
    pb, l_b = fit_b.step({"log_s": pert.clone()}, medium, steps, key,
                         target)
    gb = (pert - pb["log_s"]) / 1e-3
    log(f"  score-function step on b400 (score_function resolved to "
        f"{fit_b.cfg.score_function}): loss {float(l_b):.6g}, gradient "
        f"norm {float(gb.norm()):.6g}, finite {bool(torch.isfinite(gb).all())}")
    if not fit_b.cfg.score_function or not bool(torch.isfinite(gb).all()):
        raise AssertionError("score-function step not finite")
    # scripts/bench_fit.py's three times, medians of 5
    b_leaf = b_true.clone().requires_grad_(True)
    m_b = medium._replace(b400=b_leaf)

    def fwd_kernel():
        with torch.no_grad():
            return propagate_expected_diff(steps, medium, geo, spectra, key,
                                           cfg, n_iterations=FIT_T).sum()

    def fwd_engine():
        with torch.no_grad():
            return E.propagate(steps, medium, geo, spectra, 0, cfg,
                               max_iterations=FIT_T, key=key).hist.sum()

    def grad_step():
        s = propagate_expected_diff(steps, m_b, geo, spectra, key, cfg,
                                    n_iterations=FIT_T).sum()
        return s, torch.autograd.grad(s, b_leaf)[0]

    times = {}
    for name, fn in (("kernel forward", fwd_kernel),
                     ("engine forward", fwd_engine),
                     ("grad step", grad_step)):
        fn()
        _, times[name] = cuda_ms(fn)
    for name in ("kernel forward", "grad step"):
        busy, n_kern, wall = device_busy(dict(
            (("kernel forward", fwd_kernel), ("grad step", grad_step)))[name])
        log(f"  torch.profiler over one {name}: wall {wall * 1e3:.2f} ms, "
            f"{n_kern} kernel launches, device busy share "
            + ("not measured (no device time in the trace)" if busy is None
               else f"{busy:.4f}"))
    mem = torch.cuda.max_memory_allocated()
    log(f"  bench_fit times (medians of 5, {FIT_SLOTS} slots x {FIT_T} "
        "iterations): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
        + f"; grad step / kernel forward {times['grad step'] / times['kernel forward']:.2f}"
        f"; max memory allocated {mem / 2 ** 30:.3f} GiB")
    return launches_e, launches_t


# ---------------------------------------------------------------------------
# phase 7: the global collision plans (B3) and tabulated media (B7)
# ---------------------------------------------------------------------------

JITTER_M = 0.1      # surveyed positions: sigma of the seeded DOM offsets


def ic86(device, jitter=0.0):
    """bench.py::icecube86_geometry rebuilt on the port (78 strings on a
    perturbed 125 m hexagonal lattice, 60 DOMs at 17 m, and 8 DeepCore
    strings of 50 DOMs at 7 m; oversize 5).  With `jitter`, every DOM moves
    by a seeded Gaussian of that sigma in x, y and z."""
    from clsim_tpu_torch.geometry import build_geometry
    rng = np.random.default_rng(86)
    centers = [(0.0, 0.0)]
    ring = 1
    while len(centers) < 78:
        for k in range(6 * ring):
            side, step = k // ring, k % ring
            a0, a1 = np.pi / 3.0 * side, np.pi / 3.0 * (side + 2)
            centers.append(((ring * np.cos(a0) + step * np.cos(a1)) * 125.0,
                            (ring * np.sin(a0) + step * np.sin(a1)) * 125.0))
            if len(centers) >= 78:
                break
        ring += 1
    centers = np.asarray(centers) + rng.normal(0.0, 2.0, (78, 2))
    sids, oids, xs, ys, zs = [], [], [], [], []
    for si, (cx, cy) in enumerate(centers):
        for d in range(60):
            sids.append(si); oids.append(d)
            xs.append(cx); ys.append(cy); zs.append(500.0 - d * 17.0)
    for k in range(8):
        a = 2 * np.pi * k / 8.0
        cx, cy = (72.0 * np.cos(a), 72.0 * np.sin(a)) if k else (30.0, 10.0)
        for d in range(50):
            sids.append(78 + k); oids.append(d)
            xs.append(cx); ys.append(cy); zs.append(-150.0 - d * 7.0)
    pos = np.asarray([xs, ys, zs])
    if jitter:
        pos = pos + np.random.default_rng(87).normal(0.0, jitter, pos.shape)
    return build_geometry(sids, oids, *pos, oversize=5.0, device=device)


def arca_block(device):
    """One KM3NeT/ARCA building block as the Letter of Intent (J. Phys. G
    43 (2016) 084001) publishes it: 115 detection units on a ~90 m
    triangular grid, 18 DOMs each 36 m apart, DOM radius 0.2159 m (oversize
    5).  Each DOM sits at a surveyed position: the nominal one moved by a
    seeded Gaussian of JITTER_M (acoustic positioning, lines in the
    current)."""
    from clsim_tpu_torch.geometry import build_geometry
    pts = [(0.0, 0.0)]
    ring = 1
    while len(pts) < 115:
        for k in range(6 * ring):
            side, step = k // ring, k % ring
            a0, a1 = np.pi / 3.0 * side, np.pi / 3.0 * (side + 2)
            pts.append(((ring * np.cos(a0) + step * np.cos(a1)) * 90.0,
                        (ring * np.sin(a0) + step * np.sin(a1)) * 90.0))
            if len(pts) >= 115:
                break
        ring += 1
    n = 115 * 18
    sids = np.repeat(np.arange(115), 18)
    oids = np.tile(np.arange(18), 115)
    pos = np.asarray([np.repeat([p[0] for p in pts], 18),
                      np.repeat([p[1] for p in pts], 18),
                      np.tile(306.0 - 36.0 * np.arange(18), 115)])
    pos = pos + np.random.default_rng(115).normal(0.0, JITTER_M, (3, n))
    return build_geometry(sids, oids, *pos, om_radius=0.2159, oversize=5.0,
                          device=device)


def photonics_ice(device):
    """The seeded 171-layer ice written as a photonics-format table (ABS,
    effective SCAT at <cos> 0.9, tabulated N_PHASE / N_GROUP on 42 bins of
    10 nm from 260 nm) and parsed by medium/photonics.py: a user's
    photonics ice file, made from a seed."""
    from clsim_tpu_torch.medium.photonics import parse_photonics_ice_table
    medium, _ = seeded_ice(171, -855.0, 10.0, "cpu")
    wl = torch_f32(265.0 + 10.0 * np.arange(42))
    gs = medium.scat_coeff(wl)
    pa, qa, ra = medium.abs_coeffs(wl)
    b, a, t = medium.b400, medium.a_dust400, medium.delta_tau
    absorb = (pa[None] * a[:, None] + qa[None] + ra[None] * t[:, None])
    scat_eff = gs[None] * b[:, None] * (1.0 - 0.9)
    n_ph, n_gr = medium.phase_ref_index(wl), medium.group_ref_index(wl)
    row = lambda key, v: key + " " + " ".join(f"{x:.9g}" for x in v.tolist())
    lines = ["NLAYER 171", "NWVL 42 260 10"]
    for j in range(171):
        z0 = -855.0 + 10.0 * j
        lines += [f"LAYER {z0} {z0 + 10.0}", row("ABS", absorb[j]),
                  row("SCAT", scat_eff[j]), "COS " + " ".join(["0.9"] * 42),
                  row("N_GROUP", n_gr), row("N_PHASE", n_ph)]
    return parse_photonics_ice_table("\n".join(lines), device=device)


def torch_f32(a):
    import torch
    return torch.as_tensor(np.asarray(a, np.float32))


def biased_cherenkov(medium, geo):
    """The Cherenkov spectrum of the medium's own refractive index biased
    by the (oversized) DOM acceptance, as Simulation builds it."""
    from clsim_tpu_torch.hits.acceptance import icecube_dom_acceptance
    from clsim_tpu_torch.ops.spectrum import make_cherenkov_spectrum
    acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                 device="cpu")
    bias_x = float(acc.first_x) + float(acc.dx) * np.arange(
        acc.values.shape[0])
    return make_cherenkov_spectrum(
        medium.ref_index, medium.min_wlen, medium.max_wlen,
        bias_wlen_nm=bias_x, bias_values=acc.values.numpy())


def medium_spectra(medium, geo, device, flashers=()):
    """biased_cherenkov stacked with the given flasher spectra."""
    from clsim_tpu_torch.ops.spectrum import stack_spectra
    return stack_spectra([biased_cherenkov(medium, geo), *flashers],
                         device=device)


def quiet(fn, *a, **kw):
    """fn with the SubPlan fallback warning silenced (every phase 7 case
    refuses SubPlans on purpose)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def phase7_cases(device):
    """7a's workloads at N_SLOTS: [(entry name, inputs, records?)] with the
    main path's cascade-cloud steps (bench_workload) and one shared
    (PHASE2_T, 8, N) stream."""
    import torch
    from clsim_tpu_torch.medium.antares import make_antares_water
    from clsim_tpu_torch.types import PropagationConfig
    T = PHASE2_T
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    _, _, _, _, steps = bench_workload(N_SLOTS, 200, device)
    cfg = PropagationConfig(n_slots=N_SLOTS, pancake_factor=5.0)
    uni = torch.rand((T, 8, N_SLOTS), generator=torch.Generator(
        device=device).manual_seed(7), device=device)
    g86, gj = ic86(device), ic86(device, JITTER_M)
    water = make_antares_water(device=device)
    phot, h61 = photonics_ice(device), hex61(device)
    w = lambda m, g: (m, g, medium_spectra(m, g, device), cfg, steps, uni)
    return [("propagate[global]", "ic86, default config (global affine)",
             w(ice, g86)),
            ("propagate[general]", "jittered ic86 (general)", w(ice, gj)),
            ("propagate[water]", "Antares water, jittered ic86 "
             "(general x water)", w(water, gj)),
            ("propagate[photonics]", "photonics table on hex61 "
             "(SubPlans x photonics)", w(phot, h61))]


def phase7a(device):
    """Each new instantiation against its plain version on one shared
    stream (phase 2's tolerances), the record mode on the first three."""
    from clsim_tpu_torch.propagate import kernel as K
    cases = phase7_cases(device)
    out = {entry: check_instantiation(name, inputs, entry.startswith(
        "propagate[records")) for entry, name, inputs in cases + [
            ("propagate[records," + e[10:], n + " + records", i)
            for e, n, i in cases[:3]]}
    for entry, r in out.items():
        if r["mode"] in (0, K.MODE_RECORDS):
            raise AssertionError(f"{entry}: not a B3/B7 instantiation")
    return out


def check_instantiation(name, inputs, records, l1_tol=L1_TOL, state0=None):
    """One instantiation (with or without records) against its plain
    version on the inputs' shared stream, from fresh state or from
    `state0` (the steady shape): phase 2's checks (histogram L1 within
    l1_tol), with records 5a's, and the bound's counts (TALLIES) within
    max(2, 1%); returns its times, error, bound, mode and account."""
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, uni = inputs
    N = int(steps.x.shape[0])
    cfg = dataclasses.replace(cfg, save_photons=records)
    spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg, N,
                           PHASE2_T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    if state0 is None:
        state0 = K.init_state(steps, records)
    steps_p = K.pack_steps(steps)
    run_k = lambda: K.run_fused_iterations(state0.clone(), steps_p,
                                           tables, spec, uniforms=uni)
    run_p = lambda: K.run_fused_iterations_plain(
        state0.clone(), steps_p, tables, spec, uniforms=uni)
    run_p()      # warm-up: plain, kernel; timed: kernel, plain
    run_k()
    (_, h_k, c_k, *r_k), ms_k = cuda_ms(run_k)
    (_, h_p, c_p, *r_p), ms_p = cuda_ms(run_p, reps=1)
    err = compare(name, c_k, h_k, c_p, h_p, 1e-5, l1_tol)
    n_rec = 0
    if records:
        r_k, r_p = r_k[0], r_p[0]
        n_rec = r_k.shape[0]
        for who, c, r in (("kernel", c_k, r_k), ("plain", c_p, r_p)):
            if not r.shape[0] == float(c[K.CNT_HITS]) \
                    == float(c[K.CNT_QUEUED]):
                raise AssertionError(f"{name}: {who} records != hits")
        if abs(r_k.shape[0] - r_p.shape[0]) > max(2.0,
                                                  0.01 * r_p.shape[0]):
            raise AssertionError(f"{name}: record counts differ")
        n_ok, nk, npl = match_records(name, r_k, r_p, cfg.hist_n_bins)
        if n_ok < 0.999 * max(nk, npl):
            raise AssertionError(f"{name}: {n_ok} of {nk} / {npl} "
                                 "records match")
    # the bound's counts (kernel / plain), held as the hit counts are
    tallies = {t: (float(c_k[K.CNT_TESTED + i]), float(c_p[K.CNT_TESTED + i]))
               for i, t in enumerate(K.TALLIES)}
    bound = kernel_bound(spec, tables, c_k, "stream", n_records=n_rec)
    st = k1_stats(c_k, N, PHASE2_T)
    log(f"  {name}: mode {K.kernel_mode(spec)} (COLL "
        f"{K.kernel_coll(spec)}, MED {K.kernel_med(spec)}), K_cand "
        f"{spec.K_cand}, n_dom_cand {spec.n_dom_cand}; work "
        f"{float(c_k[K.CNT_WORK]):.0f}, spawns {float(c_k[K.CNT_GEN]):.0f}; "
        + ", ".join(f"{t} {a:.0f} / {b:.0f}" for t, (a, b) in tallies.items())
        + f"; kernel {ms_k:.3f} ms (median of 5), plain {ms_p:.3f} ms ({N} "
        f"slots x {PHASE2_T} iterations); bound {bound[0]:.4f} ms by "
        f"{bound[1]}; " + fmt_stats(st))
    for t, (a, b) in tallies.items():
        if abs(a - b) > max(2.0, 0.01 * b):
            raise AssertionError(f"{name}: kernel and plain {t} counts "
                                 "differ")
    return dict(ms=ms_k, plain_ms=ms_p, err=err, bound=bound,
                mode=K.kernel_mode(spec), hits=float(c_k[K.CNT_HITS]),
                stats=st)


# The steady shape of the fixed-horizon instantiations: Simulation's calls
# run 4,096 iterations, in which photons that live to the horizon drain and
# respawn throughout; a launch from fresh state barely spawns after its
# first iteration.  The steady shape advances the fresh state STEADY_ADVANCE
# iterations first (the kernel, Philox PHILOX_SEED) and times PHASE2_T
# iterations from there, on the same shared stream.
STEADY_ADVANCE = 64
# the fixed-horizon instantiations (photons pass through DOMs, or their
# absorption budget is the horizon): 8a's entries given the steady shape
FIXED_HORIZON = ("propagate[expected,global]", "propagate[expected,general]",
                 "propagate[expected,water]", "propagate[pass,global]",
                 "propagate[fixed,global]", "propagate[expected,photonics]")


def steady_state(inputs, records=False):
    """The inputs' fresh state advanced STEADY_ADVANCE iterations by one
    launch in the Philox mode (the state the steady shape starts from)."""
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, _ = inputs
    n = int(steps.x.shape[0])
    cfg = dataclasses.replace(cfg, save_photons=records)
    spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg, n,
                           STEADY_ADVANCE)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    state = K.init_state(steps, records)
    K.run_fused_iterations(state, K.pack_steps(steps), tables, spec,
                           seed=PHILOX_SEED)
    return state


def steps_photons(sim, cascade, seed):
    """The photons of the steps Simulation.simulate(..., seed) propagates."""
    return float(sum(int(b.num_photons.sum()) for b in
                     sim.steps_from_particles([cascade],
                                              np.random.default_rng(seed))))


def check_run(name, res, photons):
    diag = res.diagnostics
    log(f"  {name}: generated {diag['generated']:.0f} (steps' photons "
        f"{photons:.0f}), hits {diag['hits']:.0f}, dropped "
        f"{diag['dropped']:.0f}, abandoned {diag['abandoned']:.0f}; live "
        f"slot-iterations {diag['work']:.0f}, "
        + fmt_stats(k1_stats(res.diag_totals)))
    if diag["generated"] != photons:
        raise AssertionError(f"{name}: generated != the steps' photons")
    if diag["dropped"] != 0 or diag["abandoned"] != 0:
        raise AssertionError(f"{name}: photons dropped or abandoned")
    if not diag["hits"] > 0 or not bool(res.hist.isfinite().all()):
        raise AssertionError(f"{name}: no hits or a non-finite histogram")


def launched(modes):
    """MODE_LAUNCHES of the given modes (read right after a path)."""
    from clsim_tpu_torch.propagate import kernel as K
    return {m: K.MODE_LAUNCHES[m] for m in modes}


def reset_counts():
    from clsim_tpu_torch.propagate import kernel as K
    K.MODE_LAUNCHES.clear()


def phase7b(device, modes):
    """The full IceCube detector at its default configuration."""
    import torch
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.types import PropagationConfig
    _, cascade = main_path_sim(device)
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    sim = quiet(Simulation, medium=ice, geometry=ic86(device),
                config=PropagationConfig(n_slots=N_SLOTS))
    photons = steps_photons(sim, cascade, 11)
    reset_counts()
    res, wall = timed(lambda: quiet(sim.simulate, [cascade], seed=11))
    n = launched([modes["propagate[global]"]])
    check_run("ic86 default", res, photons)
    ppm = sim.step_generator.mean_photons_per_meter[0]
    expected = ppm * 5.21 * 0.924 / 0.9216 * CASCADE_GEV
    batches = sim.steps_from_particles([cascade], np.random.default_rng(11))
    _, t_prop = timed(lambda: quiet(sim.run_steps, batches, 11))
    log(f"  launches {n}, other kernels {K_other()}; yield {photons:.0f} "
        f"(PPC formula {expected:.0f}); simulate {wall:.3f} s = "
        f"{photons / wall:.6g} photons/s end to end; propagation "
        f"{t_prop:.3f} s = {photons / t_prop:.6g} photons/s")
    if min(n.values()) <= 0:
        raise AssertionError("ic86 default did not launch the global-affine "
                             "instantiation")
    if abs(photons / expected - 1.0) > 0.1:
        raise AssertionError("photon yield off the PPC formula by > 10%")
    if tuple(res.hist.shape) != (5080, 512):
        raise AssertionError(f"histogram shape {tuple(res.hist.shape)}")
    return n


def K_other():
    from clsim_tpu_torch.propagate import kernel as K
    return dict(K.MODE_LAUNCHES)


def mcpe_check(name, sim, res, n_mcpe, wlen_acceptance, angular):
    """The MCPE count against the sum of the records' hit probabilities."""
    import torch
    from clsim_tpu_torch.hits.mcpe import cos_impact, hit_probability
    rec = res.rec
    p = torch.clamp(hit_probability(
        rec["weight"][0], rec["wavelength"][0],
        cos_impact(rec["dir_theta"][0], rec["dir_phi"][0]), wlen_acceptance,
        angular).double(), 0.0, 1.0)
    mean, var = float(p.sum()), float((p * (1 - p)).sum())
    z = (n_mcpe - mean) / math.sqrt(max(var, 1e-12))
    log(f"  {name}: MCPEs {n_mcpe}, expected {mean:.6g} (sum of hit "
        f"probabilities), z = {z:.3f}")
    if abs(z) >= 5:
        raise AssertionError(f"{name}: MCPE count off its expectation")


def check_records(name, res, cfg):
    """Records = hits, the histogram rebuilt from the records equal to the
    result's."""
    import torch
    rec, diag = res.rec, res.diagnostics
    n_rec = int(res.rec_count[0])
    nb = cfg.hist_n_bins
    tb = torch.clamp((rec["time"][0] - cfg.hist_t_min) / cfg.hist_dt, 0.0,
                     nb - 1).to(torch.int64)
    rebuilt = torch.zeros(res.hist.numel(), dtype=torch.float64,
                          device=rec["time"].device).index_add_(
        0, rec["dom"][0].to(torch.int64) * nb + tb, rec["weight"][0].double())
    h = res.hist.reshape(-1).double()
    log(f"  {name}: records {n_rec}, hits {diag['hits']:.0f}; histogram "
        f"from records max |diff| {float((rebuilt - h).abs().max()):.3g}")
    if n_rec != diag["hits"] or n_rec <= 0:
        raise AssertionError(f"{name}: records != hits")
    if not bool(((rebuilt - h).abs() <= 1e-4 * h.abs() + 1e-6).all()):
        raise AssertionError(f"{name}: histogram rebuilt from records "
                             "differs")


def phase7c(device, modes):
    """Surveyed positions with records: simulate and simulate_hits on
    jittered ic86."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.types import PropagationConfig
    _, cascade = main_path_sim(device)
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    geo = ic86(device, JITTER_M)
    mk = lambda rec: quiet(Simulation, medium=ice, geometry=geo,
                           config=PropagationConfig(n_slots=N_SLOTS,
                                                    save_photons=rec))
    sim0, sim = mk(False), mk(True)
    photons = steps_photons(sim, cascade, 11)
    reset_counts()
    res0, t0 = timed(lambda: quiet(sim0.simulate, [cascade], seed=11))
    res, t1 = timed(lambda: quiet(sim.simulate, [cascade], seed=11))
    hits, t2 = timed(lambda: quiet(sim.simulate_hits, [cascade], seed=11))
    n = launched([modes["propagate[general]"],
                  modes["propagate[records,general]"]])
    log(f"  launches {n}, other kernels {K_other()}; simulate {t0:.3f} s "
        f"= {photons / t0:.6g} photons/s, with records {t1:.3f} s, "
        f"simulate_hits {t2:.3f} s")
    check_run("jittered ic86", res0, photons)
    check_run("jittered ic86 + records", res, photons)
    check_records("jittered ic86", res, sim.config)
    mcpe_check("jittered ic86", sim, res, len(hits[0]), sim.wlen_acceptance,
               sim.angular_coeffs)
    if min(n.values()) <= 0:
        raise AssertionError("jittered ic86 did not launch the general "
                             "instantiations")
    return n


def phase7d(device, modes):
    """A sea-water telescope: one KM3NeT/ARCA building block in Antares
    water, with and without records, MCPEs and multi-PMT hits."""
    import torch
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.hits.acceptance import (
        cos_cherenkov_angular_sensitivity, km3net_dom_acceptance)
    from clsim_tpu_torch.hits.mcpe import mcpes_to_numpy, sample_mcpes
    from clsim_tpu_torch.hits.multi_pmt import (km3net_31_pmt_layout,
                                                sample_multi_pmt_hits)
    from clsim_tpu_torch.medium.antares import make_antares_water
    from clsim_tpu_torch.types import PropagationConfig
    _, cascade = main_path_sim(device)
    water, geo = make_antares_water(device=device), arca_block(device)
    mk = lambda rec: quiet(Simulation, medium=water, geometry=geo,
                           config=PropagationConfig(n_slots=N_SLOTS,
                                                    save_photons=rec))
    sim0, sim = mk(False), mk(True)
    photons = steps_photons(sim, cascade, 11)
    reset_counts()
    res0, t0 = timed(lambda: quiet(sim0.simulate, [cascade], seed=11))
    res, t1 = timed(lambda: quiet(sim.simulate, [cascade], seed=11))
    n = launched([modes["propagate[water]"],
                  modes["propagate[records,water]"]])
    log(f"  ARCA block: {geo.n_strings} units, {geo.n_doms} DOMs; launches "
        f"{n}, other kernels {K_other()}; simulate {t0:.3f} s = "
        f"{photons / t0:.6g} photons/s, with records {t1:.3f} s")
    check_run("ARCA block in water", res0, photons)
    check_run("ARCA block in water + records", res, photons)
    check_records("ARCA block", res, sim.config)
    if min(n.values()) <= 0:
        raise AssertionError("the water instantiations were not launched")
    acc = km3net_dom_acceptance(device=device)
    flat = torch.tensor([1.0], device=device)   # 31 PMTs: all directions
    gen = torch.Generator(device=device).manual_seed(12)
    m = sample_mcpes(res.rec, res.rec_count, gen, acc, flat)
    mcpe_check("ARCA block, KM3NeT acceptance", sim, res,
               len(mcpes_to_numpy(m)[0]), acc, flat)
    accept, dom, pmt, t = sample_multi_pmt_hits(
        res.rec, res.rec_count, gen, km3net_31_pmt_layout(device=device),
        acc, cos_cherenkov_angular_sensitivity(device=device))
    log(f"  31-PMT hits {int(accept.sum())} of {int(res.rec_count[0])} "
        f"records ({int((pmt >= 0).sum())} on a cathode)")
    return n


def phase7e(device, modes):
    """A photonics-table ice: the cascade on hex61."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.types import PropagationConfig
    _, cascade = main_path_sim(device)
    sim = Simulation(medium=photonics_ice(device), geometry=hex61(device),
                     config=PropagationConfig(n_slots=N_SLOTS))
    photons = steps_photons(sim, cascade, 11)
    reset_counts()
    res, wall = timed(lambda: sim.simulate([cascade], seed=11))
    n = launched([modes["propagate[photonics]"]])
    log(f"  launches {n}, other kernels {K_other()}; simulate {wall:.3f} s "
        f"= {photons / wall:.6g} photons/s")
    check_run("photonics ice on hex61", res, photons)
    if min(n.values()) <= 0:
        raise AssertionError("the photonics instantiation was not launched")
    return n


# ---------------------------------------------------------------------------
# phase 8: LED flasher runs (K1·B4) and the deposit modes on the global plans
# and tabulated media (K1·B3/B7 × B6/B8b)
# ---------------------------------------------------------------------------

# the LED spectra stacked after the Cherenkov spectrum (index 0): the
# standard DOMs' 405 nm LEDs and the color DOMs' four (flasher_extras
# CDOM_LED_WLEN), with flasher_info_to_pulses' spectrum_index_by_wlen
LED_WLENS = (405, 340, 370, 450, 505)
LED_INDEX = {w: i + 1 for i, w in enumerate(LED_WLENS)}
# photons per LED at brightness and width 127, the real 1.17e10 per LED: the
# weighted Simulation scales a pulse by its LED's correction factor (1.85e-3
# at 405 nm on ic86: ~2.2e7 photons an LED)
FLASH_PHOTONS_AT_MAX = 1.17e10
STD_DOM, COLOR_DOM = (0, 30), (14, 8)
# Standard Candle 1: the real 2.5e13 would make 4.6e10 photons after the
# 405 nm factor, ~1.2e8 host steps, more than the run's time allows; cut
# 1/926 to 2.7e10, ~5.0e7 photons
SC_PHOTONS = 2.7e10
BIAS_L1_TOL = 4e-3          # tests/test_kernel.py:554-575
FIT8_LAYERS = (28, 35, 42)  # 8f gradient check: band layers near the flash


def led_spectra(wlens=LED_WLENS):
    from clsim_tpu_torch.sources.flasher import led_spectrum
    return [led_spectrum(w) for w in wlens]


def narrow_led_table():
    """tests/test_kernel.py::test_kernel_flasher_spectrum_dispatch's narrow
    405 nm LED: a Gaussian of 10 nm on 11 points."""
    from clsim_tpu_torch.ops.spectrum import make_tabulated_spectrum
    wl = np.linspace(380.0, 430.0, 11)
    return make_tabulated_spectrum(wl, np.exp(-0.5 * ((wl - 405) / 10) ** 2))


def with_source_types(steps, types):
    import torch
    return steps._replace(source_type=torch.as_tensor(
        np.asarray(types, np.int32), device=steps.x.device))


def phase8_cases(device):
    """8a's workloads at N_SLOTS on one shared (PHASE2_T, 8, N) stream:
    [(entry, name, inputs, records, l1_tol)]."""
    import torch
    from clsim_tpu_torch.medium.antares import make_antares_water
    from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                              stack_spectra)
    from clsim_tpu_torch.types import PropagationConfig
    T, N = PHASE2_T, N_SLOTS
    uni = torch.rand((T, 8, N), generator=torch.Generator(
        device=device).manual_seed(8), device=device)
    cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    h61 = hex61(device)
    # (i) test_kernel's flasher-dispatch workload (aniso + tilt, half the
    # slots source_type 1 with its 405 nm LED table), at N slots on hex61
    m, _, _, c, st, _ = small_workload(N, 1, True, True, device)
    flasher = (m, h61,
               stack_spectra([cher, narrow_led_table()], device=device),
               c, with_source_types(st, np.arange(N) >= N // 2), uni)
    # (ii) the six-table mix on ic86: bench_workload's steps cycling
    # through source types 0-5
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    _, _, _, _, cloud = bench_workload(N, 200, device)
    g86, gj = ic86(device), ic86(device, JITTER_M)
    cfg = PropagationConfig(n_slots=N, pancake_factor=5.0)
    six = (ice, g86, medium_spectra(ice, g86, device, led_spectra()), cfg,
           with_source_types(cloud, np.arange(N) % 6), uni)
    # (iii) test_kernel's geomspace bias of 23 points, on hex61
    m0, _, _, c0, st0, _ = small_workload(N, 1, False, False, device)
    bx = np.geomspace(265.0, 675.0, 23)
    by = 0.2 + 0.15 * np.sin(np.linspace(0, 5, 23)) ** 2
    bias = (m0, h61, stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0, bias_wlen_nm=bx,
        bias_values=by)], device=device), c0, st0, uni)
    # (v) the B6 deposit modes with the global plans and the media
    expected = dict(estimator="expected", soft_binning=True,
                    expected_angular_poly=ANG_POLY)
    water, phot = make_antares_water(device=device), photonics_ice(device)
    mode = lambda med, g, **kw: (med, g, medium_spectra(med, g, device),
                                 dataclasses.replace(cfg, **kw), cloud, uni)
    return [
        ("propagate[flasher]", "(i) flasher dispatch, test_kernel workload "
         "aniso+tilt on hex61, half source_type 1", flasher, False, L1_TOL),
        ("propagate[flasher,global]", "(ii) six stacked spectra on ic86",
         six, False, L1_TOL),
        ("propagate[bias]", "(iii) geomspace bias of 23 points on hex61",
         bias, False, BIAS_L1_TOL),
        ("propagate[flasher,records]", "(iv) = (i) + records", flasher, True,
         L1_TOL),
        ("propagate[flasher,records,global]", "(ii) + records", six, True,
         L1_TOL),
        ("propagate[expected,global]", "(v) expected + soft + ang_poly, "
         "ic86 (global affine)", mode(ice, g86, **expected), False, L1_TOL),
        ("propagate[expected,general]", "(v) expected + soft + ang_poly, "
         "jittered ic86 (general)", mode(ice, gj, **expected), False, L1_TOL),
        ("propagate[expected,water]", "(v) expected + soft + ang_poly, "
         "Antares water on jittered ic86", mode(water, gj, **expected), False,
         L1_TOL),
        ("propagate[pass,global]", "(v) non-stopping detect, ic86",
         mode(ice, g86, stop_on_detection=False), False, L1_TOL),
        ("propagate[fixed,global]", "(v) fixed_abs detect, ic86",
         mode(ice, g86, fixed_abs_lens=8.0), False, L1_TOL),
        ("propagate[expected,photonics]", "(v) expected, photonics ice on "
         "hex61", mode(phot, h61, estimator="expected"), False, L1_TOL)]


def phase8a(device):
    """Each case against its plain version on the shared stream: phase 2's
    tolerances (L1 <= 4e-3 on the non-uniform bias), records matched on
    (slot, dom) as in 5a, the bound's counts within max(2, 1%); the
    fixed-horizon cases also at the steady shape (entry + "/steady")."""
    out = {}
    for entry, name, inputs, records, l1_tol in phase8_cases(device):
        out[entry] = check_instantiation(name, inputs, records, l1_tol)
        if entry in FIXED_HORIZON:
            out[entry + "/steady"] = check_instantiation(
                name + ", steady shape", inputs, records, l1_tol,
                state0=steady_state(inputs))
    return out


def flasher_sim(device, medium=None, geo=None, **cfg_kw):
    """A Simulation on ic86 (default: the seeded ice) at N_SLOTS with the
    five LED spectra stacked after the Cherenkov one."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.types import PropagationConfig
    if medium is None:
        medium, _ = seeded_ice(171, -855.0, 10.0, device)
    return quiet(Simulation, medium=medium,
                 geometry=ic86(device) if geo is None else geo,
                 config=PropagationConfig(n_slots=N_SLOTS, **cfg_kw),
                 flasher_spectra=led_spectra())


def flash(geo, dom, mask=None, photons_at_max=FLASH_PHOTONS_AT_MAX):
    """The pulses of one flasher-board flash of the DOM `dom` of `geo`
    (fake_flasher_info: brightness and width 127; by default the six LEDs
    of its default mask, LEDs 7-12)."""
    from clsim_tpu_torch.sources.flasher_extras import (
        fake_flasher_info, flasher_info_to_pulses)
    info = fake_flasher_info(*dom) if mask is None else \
        fake_flasher_info(*dom, mask=mask)
    return flasher_info_to_pulses(info, geo, LED_INDEX,
                                  photons_at_max_brightness=photons_at_max)


def sources_photons(sim, sources, seed):
    """The photons of the steps Simulation.simulate(sources, seed)
    propagates."""
    return float(sum(int(b.num_photons.sum()) for b in
                     sim.steps_from_particles(sources,
                                              np.random.default_rng(seed))))


def phase8_flash(device, name, sim, pulses, mode, seed=21):
    """Simulation.simulate of one flash: generated = the steps' photons,
    dropped = abandoned = 0, histogram sum = hit weight, the
    instantiation launched; wall, propagation time and photons/s."""
    photons = sources_photons(sim, pulses, seed)
    reset_counts()
    res, wall = timed(lambda: quiet(sim.simulate, pulses, seed=seed))
    n = launched([mode])
    check_run(name, res, photons)
    hsum = float(res.hist.double().sum())
    if abs(hsum / float(res.weight_hits) - 1.0) > 1e-4:
        raise AssertionError(f"{name}: histogram sum differs from the hit "
                             "weight")
    split = host_split(sim, pulses, seed)
    log(f"  {name}: {len(pulses)} LEDs, spectra "
        f"{sorted(set(p.spectrum_index for p in pulses))}, launches {n}, "
        f"other kernels {K_other()}; hist sum {hsum:.6g}; simulate "
        f"{wall:.3f} s = {photons / wall:.6g} photons/s end to end; "
        + fmt_split(split, photons))
    if min(n.values()) <= 0:
        raise AssertionError(f"{name}: instantiation {mode} not launched")
    return n


def phase8d(device, mode):
    """simulate_hits of the standard-DOM flash with save_photons (the record
    mode of the global affine plan): records = hits, MCPEs against the sum
    of hit probabilities."""
    sim = flasher_sim(device, save_photons=True)
    pulses = flash(sim.geometry, STD_DOM)
    photons = sources_photons(sim, pulses, 21)
    reset_counts()
    res, t1 = timed(lambda: quiet(sim.simulate, pulses, seed=21))
    hits, t2 = timed(lambda: quiet(sim.simulate_hits, pulses, seed=21))
    n = launched([mode])
    log(f"  launches {n}, other kernels {K_other()}; simulate with records "
        f"{t1:.3f} s, simulate_hits {t2:.3f} s")
    check_run("standard-DOM flash + records", res, photons)
    check_records("standard-DOM flash", res, sim.config)
    mcpe_check("standard-DOM flash", sim, res, len(hits[0]),
               sim.wlen_acceptance, sim.angular_coeffs)
    if min(n.values()) <= 0:
        raise AssertionError("simulate_hits did not launch the record mode "
                             "of the global plan")
    return n


def phase8e_pipeline(device, sim, mode):
    """EventPipeline.process of four events (a cascade, the standard-DOM
    flash, an empty event, a Standard Candle 1 pulse) with max_in_flight 2."""
    from clsim_tpu_torch.parallel.pipeline import EventPipeline
    from clsim_tpu_torch.sources.flasher_extras import standard_candle_pulses
    _, cascade = main_path_sim(device)
    events = [[cascade], flash(sim.geometry, STD_DOM), [],
              standard_candle_pulses(1, photons_per_pulse=SC_PHOTONS,
                                     spectrum_index=LED_INDEX[405])]
    pipe = EventPipeline(sim, max_in_flight=2)
    reset_counts()
    results, wall = timed(lambda: quiet(pipe.process, events, seed=13))
    n = launched([mode])
    d = pipe.stats.as_dict()
    log(f"  {len(events)} events in {wall:.3f} s; launches {n}, other "
        f"kernels {K_other()}; per event (generated, hits): "
        + ", ".join(f"{r.event_id}: ({r.n_generated:.0f}, {r.n_hits:.0f})"
                    for r in results))
    log("  RunStatistics: " + ", ".join(f"{k} {v:.6g}" for k, v in d.items()))
    log(f"  DeviceUtilization {d['DeviceUtilization']:.6g} (the union of "
        "the batches' CUDA-event spans around propagate_auto over process's "
        "wall from its start to the last harvest; max_in_flight 2: the "
        "harvester thread propagates while this thread prepares)")
    if [r.event_id for r in results] != list(range(len(events))):
        raise AssertionError("pipeline results not in submission order")
    for r in results:
        if sum(r.per_particle.values()) != r.n_generated:
            raise AssertionError(f"event {r.event_id}: generated "
                                 f"{r.n_generated} != its steps' photons "
                                 f"{sum(r.per_particle.values())}")
        if not np.isfinite(r.hist).all():
            raise AssertionError(f"event {r.event_id}: non-finite histogram")
    if results[2].n_generated != 0 or min(
            r.n_generated for i, r in enumerate(results) if i != 2) <= 0:
        raise AssertionError("pipeline: wrong events empty")
    if (d["NumKernelCalls"] < 3 or d["TotalNumPhotonsGenerated"]
            != sum(r.n_generated for r in results)
            or d["TotalNumHitsDropped"] != 0
            or d["TotalNumPhotonsAbandoned"] != 0
            or not d["TotalDeviceTime"] > 0):
        raise AssertionError("RunStatistics not filled as expected")
    if min(n.values()) <= 0:
        raise AssertionError("the pipeline did not launch the kernel")
    return n


def golden_run(device, name, hold_hist=True):
    """A golden configuration from its particles through the kernel
    (util.golden.run_config: the native sampler on the golden's numpy
    stream, then Simulation.run_steps in the Philox stream, mode 0): the
    golden's exact n_generated and, with hold_hist, the hits, coarse time
    groups and hottest DOMs within 5 sigma (util.golden.statistical_compare;
    Philox is not the golden's threefry).  The weighted counts' variance
    takes E[w^2] / E[w] of the hits' weights, recorded by the record mode
    on the same steps and seed.  The slot batch is also held kernel
    against plain version on a shared stream (golden_shared_stream).
    Returns the main path's launches."""
    from clsim_tpu_torch.util import golden as G
    if hold_hist:
        golden_shared_stream(device, name)
    reset_counts()
    res, wall = timed(lambda: G.run_config(name, device))
    n = launched([0])
    g = G.load_golden(name)
    gen, g_gen = float(res["n_generated"]), float(g["n_generated"])
    l1 = float(np.abs(res["hist"] - g["hist"]).sum() / g["hist"].sum())
    log(f"  {name}: {wall:.3f} s, launches {n}; generated {gen:.0f} / "
        f"{g_gen:.0f} (run / golden), hits {float(res['n_hits']):.0f} / "
        f"{float(g['n_hits']):.0f}, histogram L1 {l1:.6g} of the golden's "
        "total")
    if gen != g_gen:
        raise AssertionError(f"{name}: n_generated differs from the golden's")
    if hold_hist:
        rec = G.run_config(name, device, save_photons=True)
        w = rec["hit_weights"]
        factor = float((w * w).sum() / w.sum())
        l1_rec = float(np.abs(rec["hist"] - res["hist"]).sum()
                       / res["hist"].sum())
        log(f"    record mode on the same steps and seed: hits "
            f"{float(rec['n_hits']):.0f}, records {len(w)}, histogram L1 "
            f"{l1_rec:.6g} of mode 0's; hit weights: mean {w.mean():.6g}, "
            f"max {w.max():.6g}, E[w^2]/E[w] {factor:.6g}")
        z = G.statistical_compare(name, float(res["n_hits"]),
                                  float(res["weight_hits"]), res["hist"],
                                  float(g["n_hits"]),
                                  float(g["weight_hits"]), g["hist"],
                                  weight_factor=factor)
        log(f"    largest |z| of the hit count, the coarse time groups and "
            f"the hottest DOMs {z:.3f}")
    if min(n.values()) <= 0:
        raise AssertionError(f"{name} did not launch the kernel")
    return n


def fit8_workload(device, n=FIT_SLOTS):
    """The flasher fit's inputs on ic86: phase 6's ice (seeded 171 layers,
    aniso + tilt) and estimator settings at the default segment cap, and
    one flash of DOM (0, 30)'s six LEDs as n one-photon steps (the first n
    of FlasherStepGenerator(photons_per_step=1)'s, empty slots where the
    Poisson draws fall short), with the Cherenkov and 405 nm spectra.
    Returns the workload and the number of steps the flash made."""
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.sources.flasher import FlasherStepGenerator
    from clsim_tpu_torch.sources.flasher_extras import flasher_num_photons
    from clsim_tpu_torch.types import PropagationConfig, StepBatch
    medium, r = seeded_ice(171, -855.0, 10.0, device)
    medium = aniso_tilt(medium, r, True, True, device)
    geo = ic86(device)
    cher = biased_cherenkov(medium, geo)
    spectra = medium_spectra(medium, geo, device, led_spectra((405,)))
    cfg = PropagationConfig(n_slots=n, estimator="expected",
                            soft_binning=True, fixed_abs_lens=8.0,
                            pancake_factor=5.0, hist_t_min=0.0,
                            hist_t_max=3000.0, hist_n_bins=128)
    # photons_at_max_brightness such that the six LEDs carry ~n photons
    per_led = n / 6 / flasher_num_photons(127, 127, 1.0)
    gen = FlasherStepGenerator(cher, photons_per_step=1)
    rng = np.random.default_rng(2025)
    batch = StepBatch.concatenate(
        [b for p in flash(geo, STD_DOM, photons_at_max=per_led)
         for b in gen.convert(p, 0, rng)])
    made = batch.n_steps
    batch = (StepBatch(*[np.asarray(f)[:n] for f in batch]) if made >= n
             else batch.pad_to(n))
    return (medium, geo, spectra, cfg,
            steps_from_numpy(batch._asdict(), device)), made


def phase8f(device):
    """The flasher ice fit on ic86: the fit's forward instantiation
    (expected + threefry on the global affine plan) against its plain
    version, then fit_gates on one flash, with the peak memory."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    workload, made = fit8_workload(device)
    medium, geo, spectra, cfg, steps = workload
    key = rng.as_key(FIT_KEY)
    run_k, spec, tables = quiet(kernel_run, *workload, FIT_T, key=key)
    run_p, _, _ = quiet(kernel_run, *workload, FIT_T, key=key, plain=True)
    run_k()
    (_, h_k, c_k), ms_k = cuda_ms(run_k)
    (_, h_p, c_p), ms_p = cuda_ms(run_p, reps=1)
    mode = K.kernel_mode(spec)
    log(f"  one flash of DOM {STD_DOM}: {made} one-photon steps made, "
        f"{FIT_SLOTS} slots ({int((steps.num_photons > 0).sum())} "
        f"filled), {spec.n_tables} spectra; fit forward mode {mode} (COLL "
        f"{K.kernel_coll(spec)}, MED {K.kernel_med(spec)}, threefry "
        f"{spec.threefry})")
    err = compare("fit forward (expected + threefry, ic86), kernel / plain",
                  c_k, h_k, c_p, h_p, 1e-5)
    bound = kernel_bound(spec, tables, c_k, "threefry")
    log(f"  fit forward: kernel {ms_k:.3f} ms (median of 5), plain "
        f"{ms_p:.3f} ms ({FIT_SLOTS} slots x {FIT_T} iterations); bound "
        f"{bound[0]:.4f} ms by {bound[1]}")
    if mode != (K.DEP_EXPECTED | K.MODE_THREEFRY
                | K.COLL_AFFINE << K.COLL_SHIFT):
        raise AssertionError("the flasher fit's forward is not the global "
                             "affine plan's expected + threefry mode")
    quiet(fit_gates, device, workload, FIT8_LAYERS)
    n = launched([mode])
    log(f"  launches (ten Adam steps and the end loss) {n}, other kernels "
        f"{K_other()}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if min(n.values()) <= 0:
        raise AssertionError("the flasher fit did not launch the kernel")
    return dict(ms=ms_k, plain_ms=ms_p, err=err, bound=bound, mode=mode), n


@contextlib.contextmanager
def launch_times():
    """Within the block, time every kernel launch (run_fused_iterations)
    between CUDA events on its stream; yields a one-element list that holds
    their summed seconds once the block has ended (one synchronize)."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    inner, events, out = K.run_fused_iterations, [], [0.0]

    def timed_launch(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = inner(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return r

    K.run_fused_iterations = timed_launch
    try:
        yield out
    finally:
        K.run_fused_iterations = inner
    torch.cuda.synchronize()
    out[0] = sum(a.elapsed_time(b) for a, b in events) * 1e-3


def flash_mode_runs(device):
    """Simulation.simulate of the standard-DOM flash in each deposit mode
    on the global plans and the media, counts reset before each: yields
    (entry, result, the steps' photons, wall s, the kernel launches' s)."""
    from clsim_tpu_torch.medium.antares import make_antares_water
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    g86, gj, h61 = ic86(device), ic86(device, JITTER_M), hex61(device)
    water, phot = make_antares_water(device=device), photonics_ice(device)
    expected = dict(estimator="expected", soft_binning=True,
                    expected_angular_poly=ANG_POLY, fixed_abs_lens=8.0)
    # hex61 numbers its strings and DOMs from 1: its DOM (1, 30) is the
    # centre string's mid-depth DOM, ic86's (0, 30)
    for entry, medium, geo, kw in (
            ("propagate[expected,global]", ice, g86, expected),
            ("propagate[expected,general]", ice, gj, expected),
            ("propagate[expected,water]", water, gj, expected),
            ("propagate[pass,global]", ice, g86,
             dict(stop_on_detection=False)),
            ("propagate[fixed,global]", ice, g86, dict(fixed_abs_lens=8.0)),
            ("propagate[expected,photonics]", phot, h61,
             dict(estimator="expected", fixed_abs_lens=8.0))):
        sim = flasher_sim(device, medium=medium, geo=geo, **kw)
        pulses = flash(geo, (1, 30) if geo is h61 else STD_DOM)
        photons = sources_photons(sim, pulses, 21)
        reset_counts()
        with launch_times() as kernel_s:
            res, wall = timed(lambda: quiet(sim.simulate, pulses, seed=21))
        yield entry, res, photons, wall, kernel_s[0], sim, pulses


def phase8g(device, modes):
    """The deposit modes on the global plans and the media through
    Simulation.simulate of the standard-DOM flash: generated = the steps'
    photons, nothing dropped or abandoned, each instantiation launched;
    the wall time beside the kernel's, and the account."""
    out = {}
    for entry, res, photons, wall, kernel_s, sim, pulses in \
            flash_mode_runs(device):
        n = launched([modes[entry]])
        log(f"  {entry}: simulate {wall:.3f} s = {photons / wall:.6g} "
            f"photons/s, the kernel's launches {kernel_s:.4f} s, "
            f"launches {n}, other kernels {K_other()}; "
            + fmt_stats(k1_stats(res.diag_totals)))
        log("    " + fmt_split(host_split(sim, pulses, 21), photons))
        check_run(entry, res, photons)
        if min(n.values()) <= 0:
            raise AssertionError(f"{entry}: instantiation not launched")
        out.update(n)
    return out


# ---------------------------------------------------------------------------
# phase 9: the probe kernels (the Pallas probes P1-P15 as H1-H4) and the
# main path's kernel accounted for by their numbers
# ---------------------------------------------------------------------------

# Work of one live slot-iteration, of one layer-walk step beyond the first
# and of one spawn of the main path's instantiation (csrc/propagate.cuh,
# COLL 0, MED 0, DEP_STOP), counted from its source beside kernel_bound's
# ALU operations: dependent table-read levels (an iteration: the cell's
# candidate list and the layer entries of its first walk step, one more a
# further step; a spawn: the step row, the bias entry and the spectrum's
# binary search), IEEE divisions and square roots (an iteration: 1 / dz at
# the walk's set-up, the two distances at its end, 1 / |d_xy|^2, the
# absorption carry, HG's two quotients and the scattering sine; a walk step
# none, its exit is tested by products; a spawn: the emission time, the
# wavelength solve, the medium factors, the Cherenkov cone, the group
# velocity and the bias; the rotations take rsqrtf), and library
# transcendentals (an iteration: logf, powf, sincosf; a spawn: two powf,
# expf, logf, sincosf).  The walk steps a slot-iteration and the lanes
# that run the spawn path are measured (CNT_WALK, CNT_SPAWN_WARPS).
K1_READS = (1, 1, 2)
K1_DIVS = (8, 0, 12)
K1_TRANSC = (3, 0, 5)


def probe_account(p2, rows, occ):
    """The main-path kernel's measured time (phase 2's main-path case)
    against the sum the probes predict for its work: each class of work
    (phase 2's counters times the counts above, at the measured walk steps
    and spawn-path lanes) over the rate its probe measured at the card's
    most resident blocks, then (c) what running at the kernel's own `occ`
    blocks a SM adds (the same work at the probes' rates at occ blocks),
    (b) the ALU work times P12's divergence ratio (divergent over coherent
    trip counts) less the ALU work, (e) the hits at the histogram probe's
    deposit rate.  Returns the terms (ms)."""
    row = lambda p, v: next(r for r in rows if r["p"] == p
                            and r["variant"] == v)
    rate = lambda p, v: row(p, v)["g_steps"] * 1e9
    spec, st = p2["spec"], p2["stats"]
    W, G, H = p2["work"], p2["gen"], p2["hits"]
    walk = st["walk"]
    spawn_lanes = 32.0 * st["spawn_warps"]
    ops_iter = (OPS_ITER + (walk - 1.0) * OPS_WALK_STEP
                + sum(OPS_PER_PLAN + OPS_PER_CAND * pl.K_cand
                      for pl in spec.sub_plans))
    levels_spawn = K1_READS[2] + math.ceil(math.log2(spec.n_spec))
    per = lambda c, sp: W * (c[0] + walk * c[1]) + spawn_lanes * sp
    at = f", {occ} blocks/SM"
    work = [  # (term, lane-ops, (probe, variant), ops a probe step)
        ("(a) dependent table reads", per(K1_READS, levels_spawn),
         ("P9", "chain (32, 176) f32 global"), 1),
        ("(d) ALU operations", W * ops_iter + spawn_lanes * OPS_SPAWN,
         ("P15", "fma n=40"), 1),
        ("(d) IEEE divisions and square roots", per(K1_DIVS, K1_DIVS[2]),
         ("P15", "div n=10, b=0 (no subnormals)"), 1),
        ("(d) library transcendentals", per(K1_TRANSC, K1_TRANSC[2]),
         ("P7", "transc k13"), 6)]
    at_occ = {"P9": "chain (32, 176) global" + at, "P15": None,
              "P7": "transc k13" + at}
    terms, slow = {}, 0.0
    for name, n, (p, v), k in work:
        t_full = n / (k * rate(p, v))
        v_occ = (("fma n=40" if v.startswith("fma") else "div n=10, b=0")
                 + at if p == "P15" else at_occ[p])
        slow += n / (k * rate(p, v_occ)) - t_full
        terms[name] = t_full * 1e3
    div_ratio = (row("P12", "candidates divergent 1-10")["ms"]
                 / row("P12", "candidates coherent (sorted) 1-10")["ms"])
    alu = sum(v for k, v in terms.items() if k.startswith("(d)"))
    terms[f"(c) {occ} blocks a SM against the most"] = slow * 1e3
    terms["(b) divergence"] = alu * (div_ratio - 1.0)
    hist = next(r for r in rows if r["p"] == "H4"
                and r["variant"].startswith("hist_atomic detect"))
    terms["(e) histogram atomics"] = H / hist["rate"] * 1e3
    total = sum(terms.values())
    log(f"  account of the main-path kernel (phase 2: {W:.0f} live "
        f"slot-iterations, {walk:.4f} walk steps each, {G:.0f} spawns, "
        f"{spawn_lanes:.0f} lane-iterations on the spawn path "
        f"({spawn_lanes / max(G, 1.0):.3f} a spawn), {H:.0f} hits; {occ} "
        f"blocks of 256 a SM; ALU {ops_iter:.1f} a slot-iteration, "
        f"{OPS_SPAWN} a spawn; divergence ratio {div_ratio:.3f}):")
    for k, v in terms.items():
        log(f"    {k}: {v:.4f} ms ({v / p2['ms']:.1%} of the kernel's "
            f"{p2['ms']:.3f} ms)")
    log(f"    sum {total:.4f} ms against {p2['ms']:.3f} ms measured "
        f"(bound {p2['bound'][0]:.4f} ms); unexplained "
        f"{p2['ms'] - total:.4f} ms; largest term: "
        f"{max(terms, key=terms.get)}")
    return dict(terms, total=total)


def phase9(device, p2, expected_hits):
    """Every probe variant against its plain version at 262,144 lanes
    (clsim_tpu_torch.probes.run_probes: exact where the kernel rounds as the
    plain version does, the stated tolerances elsewhere), the launches of
    each probe kernel on this path, and the main-path kernel's account."""
    from clsim_tpu_torch import _build
    from clsim_tpu_torch import probes as PR
    info = PR.ptxas_info(_build.BUILD_INFO["log"])
    for name, v in info.items():
        if name.startswith("_Z11probe_state") or "ILb0ELi0ELb0ELb0ELi0ELi0E" \
                in name:
            log(f"  ptxas {name[:60]}: {v}")
    for k in PR.LAUNCHES:
        PR.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    # histogram deposits a slot makes in one launch: the main path's hits;
    # two a DOM entry in the expected mode with soft binning (8a, ic86)
    rows = PR.run_probes(device, hit_rate=p2["hits"] / N_SLOTS,
                         expected_rate=2.0 * expected_hits / N_SLOTS,
                         log=log)
    launches = dict(PR.LAUNCHES)
    log(f"  {len(rows)} probe variants in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError("a probe kernel was not launched")
    occ = PR._lib().clsim_main_occupancy()
    probe_account(p2, rows, occ)
    out = {}
    for k in PR.LAUNCHES:
        r = PR.representative(rows, k)
        out[k] = dict(r, launches=launches[k],
                      err=max(x["err"] for x in rows if x["kernel"] == k))
    return out


# the phase 8 entries of the kernels line: the instantiations that 8b-8g's
# paths launch (8a's non-uniform bias and flasher record mode on hex61 run
# the main path's instantiations and no path of phase 8)
PATH8 = ("propagate[flasher]", "propagate[flasher,global]",
         "propagate[flasher,records,global]", "propagate[expected,global]",
         "propagate[expected,general]", "propagate[expected,water]",
         "propagate[pass,global]", "propagate[fixed,global]",
         "propagate[expected,photonics]", "propagate[threefry,global]")


# ---------------------------------------------------------------------------
# kernel bodies on one card, in turns (--turns): each turn is a process of
# its own that imports the package from its root (a parent commit unpacked
# under build/ with git archive, or this checkout) and times, at phase 2's
# shape, the two main-path instantiations in the stream and the Philox mode
# and the record, general, water, expected and threefry instantiations in
# the stream mode; builds at a root are cached, so only a body's first turn
# compiles it
# ---------------------------------------------------------------------------

# the mangled template arguments <RECORDS, DEP, THREEFRY, FIXED, COLL, MED>
# of the timed instantiations in ptxas's log
K1_MANGLED = {"propagate": "ILb0ELi0ELb0ELb0ELi0ELi0E",
              "propagate[global]": "ILb0ELi0ELb0ELb0ELi1ELi0E",
              "propagate[records]": "ILb1ELi0ELb0ELb0ELi0ELi0E",
              "propagate[records,global]": "ILb1ELi0ELb0ELb0ELi1ELi0E",
              "propagate[general]": "ILb0ELi0ELb0ELb0ELi2ELi0E",
              "propagate[records,general]": "ILb1ELi0ELb0ELb0ELi2ELi0E",
              "propagate[water]": "ILb0ELi0ELb0ELb0ELi2ELi2E",
              "propagate[records,water]": "ILb1ELi0ELb0ELb0ELi2ELi2E",
              "propagate[expected,global]": "ILb0ELi2ELb0ELb0ELi1ELi0E",
              "propagate[expected,general]": "ILb0ELi2ELb0ELb0ELi2ELi0E",
              "propagate[expected,water]": "ILb0ELi2ELb0ELb0ELi2ELi2E",
              "propagate[expected,photonics]": "ILb0ELi2ELb0ELb0ELi0ELi1E",
              "propagate[pass,global]": "ILb0ELi1ELb0ELb0ELi1ELi0E",
              "propagate[fixed,global]": "ILb0ELi0ELb0ELb1ELi1ELi0E",
              "propagate[threefry]": "ILb0ELi2ELb1ELb0ELi0ELi0E",
              "propagate[threefry,global]": "ILb0ELi2ELb1ELb0ELi1ELi0E"}


# ---------------------------------------------------------------------------
# phase 10: particles to goldens, the oracle and the detailed propagator
# ---------------------------------------------------------------------------

GOLDEN_T = 128      # iterations of golden_shared_stream's comparison


def golden_shared_stream(device, name):
    """The golden configuration's first slot batch, kernel against plain
    version on one shared (GOLDEN_T, 8, N) stream: phase 2's tolerances."""
    import torch
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.util import golden as G
    sim, sources = G.CONFIGS[name](device)
    batch = sim.steps_from_particles(sources, np.random.default_rng(
        G.GOLDEN_SEED))[0]
    steps = steps_from_numpy(batch._asdict(), device)
    n = batch.n_steps
    spec, cell_tab = K.fused_spec(sim.medium, sim.geometry, sim.spectra,
                                  sim.config, n, GOLDEN_T)
    tables = K.build_tables(spec, sim.medium, sim.geometry, sim.spectra,
                            cell_tab)
    uni = torch.as_tensor(np.random.default_rng(7).random(
        (GOLDEN_T, 8, n)).astype(np.float32), device=device)
    state0, steps_p = K.init_state(steps), K.pack_steps(steps)
    _, h_k, c_k = K.run_fused_iterations(state0.clone(), steps_p, tables,
                                         spec, uniforms=uni)
    _, h_p, c_p = K.run_fused_iterations_plain(state0.clone(), steps_p,
                                               tables, spec, uniforms=uni)
    compare(f"{name}, shared stream, mode {K.kernel_mode(spec)}", c_k, h_k,
            c_p, h_p)

# the BASELINE matrix (clsim_tpu_torch/validate/matrix.py), 4,096 steps a
# configuration.  Phase 10b runs the cascade at ORACLE_PHOTONS photons a
# step, muon and flasher at MATRIX_PHOTONS, and cascade-biased at
# FULL_MATRIX_PHOTONS, validate_oracle.py's 1e6: at 262,144 photons one
# kernel hit of weight 1.075e6 (1 / bias at 262.5 nm, a legitimate draw
# from the spectrum's edge) put a coarse time bin 12 sigma off, since the
# weighted bins take their variance from the oracle's sample, which held
# no such hit.  The biased cascade runs with both of matrix.SEEDS against
# its one oracle sample.  --oracle-matrix runs three at FULL_MATRIX_PHOTONS (>= 1e6)
# and cascade-biased at FULL_BIASED_PHOTONS (>= 2e6, the size at which the
# JAX package recorded its four usable equal-count bins, VALIDATION.md),
# through the kernel and the card's engine.  The float64 oracle takes ~17
# s a 524,288 photons on one host core; the configurations' oracles run in
# worker processes on the host while the card runs the propagator.
ORACLE_PHOTONS = 128
MATRIX_PHOTONS = 64
FULL_MATRIX_PHOTONS = 245
FULL_BIASED_PHOTONS = 489
ORACLE_WORKERS = 4
DETAILED_GEV = 1.0e4    # 10c's cascade: ~52,000 one-metre segments


def oracle_matrix_cases(device, sizes, backends, power, second_draw=()):
    """Each configuration of `sizes` (config -> photons a step) through
    matrix.propagate with each backend on the card (the configurations of
    `second_draw` also with its second seed) and through the oracle (in
    host worker processes, matrix.oracle_of), held by matrix.check_case:
    the statistics (with the usable equal-count bins when `power`),
    generated = the steps' photons, unit weights in the unbiased
    configurations, every hit recorded with weight 1/bias in the biased
    one (the kernel's buffer holds every photon, its stalled launches
    logged), and the kernel launched by "auto" only.  Every case runs
    before a failure raises.  Returns a list of one dict a case (config,
    backend, seed, photons, hits, oracle hits, largest |z|, usable bins,
    seconds, kernel launches)."""
    import concurrent.futures
    import multiprocessing
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.validate import matrix as MX
    ctx = multiprocessing.get_context("spawn")
    out, failures = [], []
    with concurrent.futures.ProcessPoolExecutor(
            min(ORACLE_WORKERS, len(sizes)), mp_context=ctx) as pool:
        oracles = {c: pool.submit(MX.oracle_of, c, pps)
                   for c, pps in sizes.items()}
        for config, pps in sizes.items():
            w = MX.workload(config, device, pps)
            photons = MX.N_STEPS * pps
            runs = []
            for backend in backends:
                for draw in (0, 1) if config in second_draw else (0,):
                    (res, n), t_k = timed(
                        lambda: MX.propagate(w, backend, draw))
                    runs.append((backend, MX.SEEDS[draw], res, t_k, n))
            o, t_o = oracles[config].result()
            for backend, seed, res, t_k, n in runs:
                name = f"{config} [{backend}, seed {seed}]"
                case = MX.check_case(config, w, res, n, o, backend, power)
                cmp, hits = case.cmp, float(res.n_hits)
                usable = [s.value for s in cmp.stats if s.kind == "usable"]
                stalled = (None if res.diag_totals is None
                           else float(res.diag_totals[K.CNT_STALLED]))
                log(f"  {name}: {photons} photons ({MX.N_STEPS} x {pps}), "
                    f"generated {float(res.n_generated):.0f}, hits "
                    f"{hits:.0f}, oracle hits {o[1]}; largest |z| "
                    f"{cmp.max_z:.3f}"
                    + (f", usable equal-count bins {usable[0]:.0f}"
                       if usable else "")
                    + f"; {backend} {t_k:.3f} s ({n} kernel launches"
                    + ("" if stalled is None
                       else f", {stalled:.0f} stalled record launches")
                    + f"), oracle {t_o:.3f} s")
                if case.records is not None:
                    log(f"    records {len(case.records[1])}, largest weight "
                        f"{case.records[1].max():.6g}, |weight x bias - 1| "
                        f"{case.unfold:.3g}")
                if case.problems or case.records is not None or power:
                    for line in cmp.lines:
                        log("    " + line)
                if case.problems:
                    failures.append(f"{name}: {'; '.join(case.problems)}")
                out.append(dict(config=config, backend=backend, seed=seed,
                                photons=photons, hits=hits,
                                oracle_hits=int(o[1]), max_z=cmp.max_z,
                                usable=usable[0] if usable else None,
                                seconds=t_k, launches=n, stalled=stalled))
    if failures:
        raise AssertionError("the oracle matrix failed: "
                             + " | ".join(failures))
    return out


def phase10b(device):
    """ROADMAP parity contract 2 on the card: the BASELINE matrix through
    the kernel in the Philox mode (propagate_auto; the record mode in the
    biased configuration) against the port's float64 oracle on the same
    steps (its own numpy stream), every statistic within 5 sigma: the
    cascade at 4,096 x ORACLE_PHOTONS photons, muon and flasher at 4,096 x
    MATRIX_PHOTONS, cascade-biased at 4,096 x FULL_MATRIX_PHOTONS with
    both propagator seeds against its one oracle sample (its usable
    equal-count bins, which need ~2e6 photons, are logged, held by
    --oracle-matrix)."""
    sizes = {"cascade": ORACLE_PHOTONS, "muon": MATRIX_PHOTONS,
             "flasher": MATRIX_PHOTONS,
             "cascade-biased": FULL_MATRIX_PHOTONS}
    return oracle_matrix_cases(device, sizes, ("auto",), power=False,
                               second_draw=("cascade-biased",))


def oracle_matrix_only():
    """--oracle-matrix: build, then the four configurations at 4,096 x
    FULL_MATRIX_PHOTONS photons (cascade-biased FULL_BIASED_PHOTONS)
    through the kernel (backend auto) and the card's engine against the
    oracle, with every statistic of scripts/validate_oracle.py held; prints
    one JSON line of the cases."""
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    log(card)
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.validate import matrix as MX
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 1: built in {time.perf_counter() - t0:.2f} s")
    log("the oracle matrix at full size")
    t0 = time.perf_counter()
    cases = oracle_matrix_cases(
        torch.device("cuda", 0),
        {c: FULL_BIASED_PHOTONS if c == "cascade-biased"
         else FULL_MATRIX_PHOTONS for c in MX.CONFIGS}, ("auto", "engine"),
        power=True)
    log(f"  the oracle matrix passed in {time.perf_counter() - t0:.1f} s "
        f"on {card}")
    print(json.dumps({"oracle_matrix": cases, "card": card}))


def phase10c(device):
    """A DetailedCascadePropagator cascade (beta spread 0.02) through
    Simulation(propagators=[...]).simulate on hex61 with phase 3's ice:
    generated = the steps' photons, steps with beta < 1, histogram sum =
    hit weight, nothing dropped or abandoned, the main path's
    instantiation launched."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.sources import Particle, ParticleType
    from clsim_tpu_torch.sources.detailed import DetailedCascadePropagator
    from clsim_tpu_torch.types import PropagationConfig
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    geo = hex61(device)
    det = DetailedCascadePropagator(medium, biased_cherenkov(medium, geo),
                                    beta_spread=0.02)
    sim = Simulation(medium=medium, geometry=geo,
                     config=PropagationConfig(n_slots=N_SLOTS),
                     propagators=[det])
    cascade = Particle.cascade(ParticleType.EMinus, pos=(0.0, 0.0, 0.0),
                               time=0.0, energy=DETAILED_GEV, zenith=1.9,
                               azimuth=0.7)
    batches = sim.steps_from_particles([cascade], np.random.default_rng(17))
    photons = float(sum(int(b.num_photons.sum()) for b in batches))
    beta = np.concatenate([b.beta[b.num_photons > 0] for b in batches])
    reset_counts()
    res, wall = timed(lambda: sim.simulate([cascade], seed=17))
    n = launched([0])
    hsum = float(res.hist.double().sum())
    log(f"  {DETAILED_GEV:.0f} GeV cascade: {len(beta)} steps, beta "
        f"{beta.min():.4f}-{beta.max():.4f} (mean {beta.mean():.5f}); "
        f"simulate {wall:.3f} s, launches {n}, other kernels {K_other()}; "
        f"hist sum {hsum:.6g}")
    check_run("detailed cascade", res, photons)
    if not (beta < 1.0).any():
        raise AssertionError("detailed cascade: no step with beta < 1")
    if abs(hsum / float(res.weight_hits) - 1.0) > 1e-4:
        raise AssertionError("detailed cascade: histogram sum differs from "
                             "the hit weight")
    if min(n.values()) <= 0:
        raise AssertionError("detailed cascade did not launch the kernel")
    return n


# ---------------------------------------------------------------------------
# phase 11: photon tables on the card, and scatter-history rings
# ---------------------------------------------------------------------------

TAB_SLOTS = 65536        # scripts/bench_tabulator.py's workload
TAB_PHOTONS = 32
TAB_REPS = 3             # 11a's runs without the profiler (median wall)
TAB_CMP_ITERS = 32       # 11a's kernel-against-plain launch: the run's
                         # first iterations, on the same keys
TAB_ROW_WARM = 3         # --tab-turns' kernel row: launches to warm the
TAB_ROW_REPS = 11        # clocks, then launches timed (median); the
                         # kernels line times TAB_REPS with no warm-up
TAB_PLAIN_CHUNKS = 2     # the eager plain version's first chunks of 16
                         # iterations, timed on the card beside the kernel
TAB_RUNS = 8             # 11b's independent runs
TAB_REF_PHOTONS = 8      # 11b's photons a slot (11a's 32 cut for time)
# 11b's radial groups: data bins [lo, hi) of the default r axis (200
# power-2 bins to 580 m), from r = 5.8 m out
TAB_GROUPS = [(20, 40), (40, 60), (60, 80), (80, 100), (100, 120),
              (120, 140), (140, 160), (160, 180), (180, 200)]
TAB_SMALL = (1024, 1)    # 11c's reduced size: slots, photons a slot
HIST_H = 4               # 11d's ring entries
RING_GEV = 1.0e3         # 11d's cascade
RING_TOL = 2e-2          # ring fields, card engine against the CPU engine
RING_STREAM = (8192, 64)  # 11d's shared stream: slots, iterations
TAB_REPLACES = "clsim_tpu/tabulator/table.py:143"   # the JAX jitted chunk
# Operations of csrc/tabulate.cu counted from its source as OPS_ITER is:
# a tested sub-step on spherical axes (its distance and position 5, the
# source-relative vector, l, h, rho and r 22 with the two square roots,
# the azimuth's cosine, clamp, arccosine and scaling 9, cos(polar) and the
# time residual 6, the bounds 2, frac, exponent and weight 6, four bin
# indices at 10 each and 4 more on each of the two power-2 axes, the flat
# index 8 and its clamp 2, the run's compare and sum 3, the counts 3), and
# with the impact axis its two threefry draws, the direction's rotation
# (scatter_dir 30) and the cosine with a fifth index (20).  A live
# slot-iteration costs OPS_ITER with its four threefry draws and the
# angular polynomial (2 a coefficient); a spawn OPS_SPAWN with five draws.
OPS_TAB_SUBSTEP = 113
OPS_TAB_IMPACT = 2 * OPS_RNG["threefry"] + 50


def tab_bound(block, c, n, iters, touched):
    """(bound_ms, bound_by, per-deposit bytes ms) of a tabulator launch of
    `iters` iterations on n slots with counters c (TAB_COUNTERS): the larger
    of the operations over the float32 peak and the bytes over the HBM
    rate.  Bytes: the state read and written once, the steps and the key
    tables read once, and each bin the launch touched (`touched`, the
    table's nonzero bins after it) read and written once, 16 bytes (the
    table accumulates).  The third figure charges 16 bytes to every nonzero
    sub-step instead (each deposit its own read-modify-write)."""
    from clsim_tpu_torch.propagate import kernel as K
    tab, p = block.tab, block.params
    per_iter = (OPS_ITER + 4 * OPS_RNG["threefry"]
                + 2 * (0 if block.impact else tab.n_ang)
                + (OPS_ANISO if p.aniso else 0)
                + (OPS_TILT if p.nz_tilt else 0))
    ops = (c["substeps"] * (OPS_TAB_SUBSTEP
                            + (OPS_TAB_IMPACT if block.impact else 0))
           + c["work"] * per_iter
           + max(c["walk"] - c["work"], 0.0) * OPS_WALK_STEP
           + c["generated"] * (OPS_SPAWN + 5 * OPS_RNG["threefry"]))
    fixed = (4 * (2 * (K.NSF + 1) * n + K.NST * n) + 8 * iters
             * (1 + (block.n_sub if block.impact else 0)))
    t_ops = ops / FP32_PEAK * 1e3
    t_bytes = (fixed + 16 * touched) / HBM_BYTES_S * 1e3
    t_dep = (fixed + 16 * c["entries"]) / HBM_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_dep)


def tab_inputs(device, b400=0.04, medium=None):
    """bench_tabulator.py's medium (171 homogeneous layers) or `medium`,
    the unbiased Cherenkov spectrum of its refractive index and the source
    at the origin along +x."""
    from clsim_tpu_torch.medium.properties import make_homogeneous_ice
    from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                              stack_spectra)
    from clsim_tpu_torch.tabulator import make_reference_source
    if medium is None:
        medium = make_homogeneous_ice(n_layers=171, z_start=-855.0,
                                      layer_height=10.0, b400=b400,
                                      device=device)
    spectra = stack_spectra([make_cherenkov_spectrum(
        medium.ref_index, medium.min_wlen, medium.max_wlen)], device=device)
    source = make_reference_source(0.0, 0.0, 0.0, 0.0, np.pi / 2, 0.0,
                                   device=device)
    return medium, spectra, source


def tab_steps(n, photons, device, seed=3):
    """Isotropic 1 mm Cherenkov steps at the origin, directions from
    default_rng(seed) (bench_tabulator.py's steps at seed 3)."""
    r = np.random.default_rng(seed)
    costh = r.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = r.uniform(0, 2 * np.pi, n)
    return step_batch(n, device, x=0.0, y=0.0, z=0.0, length=1e-3,
                      dir_x=sinth * np.cos(phi), dir_y=sinth * np.sin(phi),
                      dir_z=costh, num_photons=photons)


def tab_cfg(steps):
    """bench_tabulator.py's config (35 m segments, 4 walk steps)."""
    from clsim_tpu_torch.types import PropagationConfig
    return PropagationConfig(n_slots=int(steps.x.shape[0]),
                             max_layer_steps=4, max_segment_m=35.0)


def tab_call(inputs, steps, seed, axes=None, tally=None):
    """tabulate one batch with tab_cfg's config."""
    from clsim_tpu_torch.tabulator import tabulate
    medium, spectra, source = inputs
    return tabulate([steps], medium, spectra, source, seed=seed, axes=axes,
                    cfg=tab_cfg(steps), tally=tally)


def check_table(name, table, tally, device):
    """Finite values, a positive sum, the raw table float64 on `device`,
    and every comb weight landed in it (its sum equal to the sum of all
    comb weights)."""
    import torch
    raw = tally["raw"]
    landed = float(raw.sum())
    weight = float(tally["weight"])
    log(f"  {name}: n_photons {table.n_photons:.0f}, iterations "
        f"{tally['iterations']}, host syncs {tally['syncs']}, nonzero comb "
        f"entries {tally['entries']}, table atomics {tally['atomics']}, "
        f"table sum {landed:.10g} / comb weight {weight:.10g}, table "
        f"{raw.numel()} bins {raw.dtype} on {raw.device}")
    if raw.device.type != torch.device(device).type or \
            raw.dtype != torch.float64:
        raise AssertionError(f"{name}: the table is not float64 on {device}")
    if not np.isfinite(table.values).all() or not table.values.sum() > 0:
        raise AssertionError(f"{name}: non-finite or empty table")
    if abs(landed - weight) > 1e-9 * weight or tally["entries"] <= 0:
        raise AssertionError(f"{name}: deposits missing from the table")


def launch_ms(fn, state0, table, reps):
    """(fn's last result, its state, every ms, every result) of `reps`
    calls fn(state, table) between CUDA events, each on a fresh copy of
    state0 and the zeroed table."""
    import torch
    times, results = [], []
    for r in range(reps):
        state = state0.clone()
        table.zero_()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        c = fn(state, table)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        results.append(c)
    return c, state, times, results


def tab_kernel_against_plain(inputs, axes, steps, key, iters, device):
    """One launch of `iters` iterations from the initial state, the kernel
    (TK.launch) and the plain version (tabulate_iterations_plain) on the
    same state, steps and keys on the card: equal photons made and alive
    slots, nonzero sub-steps, sub-steps, live slot-iterations and walk
    steps within max(2, 1%), table sums equal to the weight sums (1e-9),
    the tables' L1 <= L1_TOL of the total.  Returns the kernel row's
    figures: max |table difference|, the kernel's and the plain version's
    median ms (CUDA events around the launch alone; the kernel over
    TAB_REPS launches, the plain version one run), the bound, the
    counters."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    medium, spectra, source = inputs
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                tab_cfg(steps), 1.0, 46.0)
    n = int(steps.x.shape[0])
    state0, sp = TT.init_state(steps), K.pack_steps(steps)
    keys = TK.launch_keys(key, 0, iters, plan.block.n_sub, plan.block.impact,
                          device)
    out = {}
    cycles = {}
    for name, fn, reps in (
            ("kernel", lambda st, tb: TK.launch(plan.block, st, sp, keys,
                                                tb), TAB_REPS),
            ("plain", lambda st, tb: TT.tabulate_iterations_plain(
                plan, st, sp, keys, tb), 1)):
        table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)
        c, state, times, cs = launch_ms(fn, state0, table, reps)
        out[name] = (dict(zip(TK.TAB_COUNTERS, c.tolist())), table,
                     float(np.median(times)), state)
        cycles[name] = [(t, tab_stats(dict(zip(TK.TAB_COUNTERS, x.tolist())))
                         ["cycles_per_warp_iter"]) for t, x in zip(times, cs)]
    (ck, tk, ms, sk), (cp, tp, plain_ms, spl) = out["kernel"], out["plain"]
    for k in ("generated", "alive"):
        if ck[k] != cp[k]:
            raise AssertionError(f"11a: kernel {k} {ck[k]} != plain {cp[k]}")
    for k in ("entries", "substeps", "work", "walk"):
        if abs(ck[k] - cp[k]) > max(2.0, 0.01 * cp[k]):
            raise AssertionError(f"11a: kernel {k} {ck[k]} vs plain {cp[k]}")
    for name, c, t in (("kernel", ck, tk), ("plain", cp, tp)):
        if abs(float(t.sum()) - c["weight"]) > 1e-9 * c["weight"]:
            raise AssertionError(f"11a: the {name} table's sum is not its "
                                 "weight sum")
    l1 = float((tk - tp).abs().sum() / tp.abs().sum())
    err = float((tk - tp).abs().max())
    touched = int((tk != 0).sum())
    bound = tab_bound(plan.block, ck, n, iters, touched)
    # one atomic for each nonzero sub-step (csrc/tabulate.cu)
    if ck["atomics"] != ck["entries"] or l1 > L1_TOL:
        raise AssertionError(f"11a: kernel against plain: L1 {l1}, "
                             f"atomics {ck['atomics']}")
    each = ", ".join(
        f"{t:.4f} ms at " + ("n/a" if cy is None else f"{cy:.1f}")
        + " cycles a warp-iteration" for t, cy in cycles["kernel"])
    log(f"  11a kernel against plain version, first {iters} iterations on "
        f"the same keys: table L1 {l1:.4e} of the total, max |difference| "
        f"{err:.4e}, in_flight equal in {int((sk[1] == spl[1]).sum())} of "
        f"{n} slots; kernel {ck}; plain {cp}; kernel {ms:.4f} ms (median "
        f"of {TAB_REPS}: {each}), plain version {plain_ms:.2f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}; {touched} bins touched; 16 B a "
        f"nonzero sub-step instead: {bound[2]:.4f} ms); account "
        + fmt_tab_stats(tab_stats(ck)))

    # a compacted launch: every other live slot of the plain version's
    # state, iters // 4 iterations more, kernel against plain version; the
    # slots off the list keep their state bit for bit
    live = TT.live_slots(spl, int(cp["alive"]))[::2].contiguous()
    keys2 = TK.launch_keys(key, iters, iters // 4, plan.block.n_sub,
                           plan.block.impact, device)
    res = []
    for fn in (TK.launch, lambda *a: TT.tabulate_iterations_plain(plan,
                                                                  *a[1:])):
        st, tb = spl.clone(), torch.zeros_like(tk)
        c = dict(zip(TK.TAB_COUNTERS, fn(plan.block, st, sp, keys2, tb,
                                         live).tolist()))
        res.append((c, tb, st))
    (c2k, t2k, s2k), (c2p, t2p, s2p) = res
    off = torch.ones(n, dtype=torch.bool, device=device)
    off[live.long()] = False
    for k in ("generated", "alive"):
        if c2k[k] != c2p[k]:
            raise AssertionError(f"11a compacted: kernel {k} {c2k[k]} != "
                                 f"plain {c2p[k]}")
    for k in ("entries", "substeps", "work", "walk"):
        if abs(c2k[k] - c2p[k]) > max(2.0, 0.01 * c2p[k]):
            raise AssertionError(f"11a compacted: kernel {k} {c2k[k]} vs "
                                 f"plain {c2p[k]}")
    l1c = float((t2k - t2p).abs().sum() / t2p.abs().sum())
    if not (torch.equal(s2k[:, off], spl[:, off])
            and torch.equal(s2p[:, off], spl[:, off])) or l1c > L1_TOL or \
            abs(float(t2k.sum()) - c2k["weight"]) > 1e-9 * c2k["weight"]:
        raise AssertionError(f"11a compacted: L1 {l1c}, or a slot off the "
                             "list changed, or deposits missing")
    log(f"  11a compacted launch ({live.shape[0]} of {n} slots, "
        f"{iters // 4} iterations): table L1 {l1c:.4e}, kernel {c2k}, "
        f"plain {c2p}; the {int(off.sum())} slots off the list unchanged")
    return dict(err=max(err, float((t2k - t2p).abs().max())), ms=ms,
                plain_ms=plain_ms, bound=bound[:2], counters=ck)


TAB_STAGES = ("spawn", "walk", "coords", "weight", "scatter")


def tab_stats(c):
    """The tabulator kernel's account from counters c (TAB_COUNTERS, a
    launch's or a run's sums): live-lane efficiency (live slot-iterations
    over 32 x warp-iterations), the comb's lane efficiency (sub-steps over
    the lane-slots of the rounds the kernel ran, comb_slots), sub-steps a
    live slot-iteration, atomics a nonzero sub-step, cycles a
    warp-iteration and each stage's share of lane 0's cycles.  A counter
    the kernel lacks (an older checkout under --tab-turns) reads as
    None."""
    ratio = lambda a, b: (c[a] / c[b] if c.get(a) is not None
                          and c.get(b) else None)
    out = dict(live_eff=(c["work"] / (32 * c["warps"]) if c.get("warps")
                         else None),
               comb_eff=ratio("substeps", "comb_slots"),
               substeps_per_iter=ratio("substeps", "work"),
               atomics_per_entry=ratio("atomics", "entries"))
    cyc = [c.get(f"cyc_{k}") for k in TAB_STAGES]
    total = sum(cyc) if None not in cyc else 0
    out["cycles_per_warp_iter"] = (total / c["warps"] if total else None)
    out["shares"] = ({k: v / total for k, v in zip(TAB_STAGES, cyc)}
                     if total else None)
    return out


def fmt_tab_stats(st):
    f = lambda v: "n/a" if v is None else f"{v:.4f}"
    shares = ("n/a" if st["shares"] is None else ", ".join(
        f"{k} {v:.4f}" for k, v in st["shares"].items()))
    return (f"live-lane efficiency {f(st['live_eff'])}, comb lane "
            f"efficiency {f(st['comb_eff'])}, sub-steps a live slot-iteration "
            f"{f(st['substeps_per_iter'])}, atomics a nonzero sub-step "
            f"{f(st['atomics_per_entry'])}, cycles a warp-iteration "
            f"{f(st['cycles_per_warp_iter'])}; shares of lane 0's cycles: "
            + shares)


@contextlib.contextmanager
def tab_launch_times():
    """Within the block, time every tabulator kernel launch
    (tabulator.kernel.launch) between CUDA events on its stream; yields a
    list that holds, once the block has ended (one synchronize), a dict
    for each launch: its iterations, the slots it served, its ms and its
    counters."""
    import torch
    from clsim_tpu_torch.tabulator import kernel as TK
    inner, events, out = TK.launch, [], []

    def timed_launch(block, state, steps, keys, table, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        c = inner(block, state, steps, keys, table, *a, **kw)
        e1.record()
        slots = a[0] if a else kw.get("slots")
        events.append((int(keys.iter.shape[0]), int(
            state.shape[1] if slots is None else slots.shape[0]), e0, e1, c))
        return c

    TK.launch = timed_launch
    try:
        yield out
    finally:
        TK.launch = inner
    torch.cuda.synchronize()
    out.extend(dict(iters=i, slots=n, ms=e0.elapsed_time(e1),
                    counters=dict(zip(TK.TAB_COUNTERS, c.tolist())))
               for i, n, e0, e1, c in events)


def fmt_launches(lt):
    return ", ".join(f"{x['ms']:.4f} ms ({x['iters']} it, {x['slots']} "
                     "slots)" for x in lt)


def summed(lt):
    """The counters of launches lt summed."""
    out = collections.Counter()
    for x in lt:
        out.update(x["counters"])
    return dict(out)


def normalize_split(raw, shape, norm):
    """table._normalized on the raw device table: its wall (s, ending in a
    synchronize), and the device time of its division kernels and of its
    device-to-host copies from one more call under the profiler (None
    when the trace holds none); and the first touch of a fresh host array
    of the table's size alone (np.empty, then filled), the host's share of
    a copy into untouched pageable memory."""
    import torch
    from clsim_tpu_torch.tabulator import table as TT
    from clsim_tpu_torch.util.profiling import trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TT._normalized(raw, shape, norm)
    whole = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as prof:
            TT._normalized(raw, shape, norm)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copy = sum(e.device_time for e in dev if e.name.startswith("Memcpy"))
    divide = sum(e.device_time for e in dev
                 if not e.name.startswith("Memcpy"))
    t0 = time.perf_counter()
    np.empty(shape).fill(0.0)
    touch = time.perf_counter() - t0
    return dict(whole=whole, divide=divide * 1e-6 if divide else None,
                copy=copy * 1e-6 if copy else None, touch=touch)


def phase11a(device, card):
    """The tabulator at full size on its kernel: bench_tabulator.py's
    65,536 slots x 32 photons on the default spherical axes (83,775,864
    float64 bins on the card).  One run under profile_device_time (reps 1:
    its first call is the wall clock ending in synchronize, and its
    CUDA-event span) with the launch count set to 0 just before it gives
    photons/s, the kernel's launches and the peak memory; TAB_REPS - 1 more
    runs the median wall, and one under torch.profiler the device busy
    share (device time over that median wall) and every launch an
    iteration.  Then the kernel against its plain version on the run's first
    TAB_CMP_ITERS iterations (the kernel row), and the eager plain
    version's first chunks on the card, timed and traced as the kernel
    run is."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import default_spherical_axes
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    from clsim_tpu_torch.util.profiling import profile_device_time, trace
    inputs = tab_inputs(device)
    axes = default_spherical_axes()
    if axes.n_bins != 83775864:
        raise AssertionError(f"default spherical axes: {axes.n_bins} bins")
    tab_call(inputs, tab_steps(1024, 1, device), seed=0)      # warm-up
    steps = tab_steps(TAB_SLOTS, TAB_PHOTONS, device)
    n_photons = TAB_SLOTS * TAB_PHOTONS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tally, out = {}, {}

    def run():
        out["table"] = tab_call(inputs, steps, 1, axes, tally)

    TK.LAUNCHES["tabulate"] = 0
    with tab_launch_times() as lt:
        pdt = profile_device_time(run, reps=1, warmup=0)
    launches = TK.LAUNCHES["tabulate"]
    peak = torch.cuda.max_memory_allocated()
    check_table("11a", out.pop("table"), tally, device)
    wall, iters = pdt["first_call_s"], tally["iterations"]
    if launches != tally["syncs"] or launches == 0 or len(lt) != launches:
        raise AssertionError(f"11a: {launches} kernel launches, "
                             f"{tally['syncs']} syncs, {len(lt)} timed")
    kernel_s = sum(x["ms"] for x in lt) * 1e-3
    log(f"  11a: {TAB_SLOTS} slots x {TAB_PHOTONS} photons = {n_photons} "
        f"photons in {wall:.4f} s = {n_photons / wall:.6g} photons/s, "
        f"{iters} iterations ({wall / iters * 1e3:.4f} ms an iteration) in "
        f"{launches} kernel launches, {tally['atomics']} table atomics for "
        f"{tally['entries']} nonzero sub-steps, peak "
        f"memory {peak / 2 ** 30:.4f} GiB, on {card}")
    log(f"  11a kernel launches between CUDA events: " + fmt_launches(lt)
        + f"; summed {kernel_s:.6f} s = {n_photons / kernel_s:.6g} photons/s "
        f"of kernel; on {card}")
    stats = tab_stats(tally)
    log(f"  11a kernel account over the run: " + fmt_tab_stats(stats))
    log(f"  11a profile_device_time (reps 1, warmup 0): " + ", ".join(
        f"{k} {v}" for k, v in pdt.items()) + f"; on {card}")
    # the time outside the kernel: tabulate's normalization, by stage
    norm = np.ones(axes.shape[:3])
    norm[1:-1, 1:-1, 1:-1] = axes.bin_volumes() / (np.pi * 0.16510 ** 2)
    split = normalize_split(tally["raw"], axes.shape, norm)
    nm = lambda v: "not measured" if v is None else f"{v:.4f} s"
    log(f"  11a outside the kernel: table._normalized {split['whole']:.4f} s;"
        f" its division on the card {nm(split['divide'])} and device-to-host"
        f" copies {nm(split['copy'])} of device time (profiler); a bare "
        f"first touch of a host array of the table's size "
        f"{split['touch']:.4f} s; on {card}")
    del tally

    def timed_and_traced(name, fn, n_it):
        """fn's median wall over TAB_REPS runs (the first given), and its
        device busy share and launches an iteration under the profiler."""
        walls = []
        for _ in range(TAB_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        with tempfile.TemporaryDirectory() as d:
            with trace(d) as prof:
                t0 = time.perf_counter()
                fn()
                pwall = time.perf_counter() - t0
            trace_mb = os.path.getsize(os.path.join(d, "trace.json")) / 2 ** 20
        busy, kernels, _ = busy_of(prof, med)
        if kernels == 0:
            raise AssertionError(f"11a: the trace of {name} holds no kernel")
        busy_s = "not measured (no device time in the trace)" \
            if busy is None else f"{busy:.4f} ({busy * med:.4f} s of " \
            "device time)"
        log(f"  11a {name}: {med:.4f} s ({med / n_it * 1e3:.4f} ms an "
            f"iteration over {n_it}) without the profiler (median of "
            + ", ".join(f"{w:.4f}" for w in walls) + f"), {pwall:.4f} s "
            f"under it (x{pwall / med:.2f}); device busy share {busy_s} "
            "(device time in the trace over the median wall without the "
            f"profiler), {kernels} launches = {kernels / n_it:.4f} an "
            f"iteration, Chrome trace {trace_mb:.1f} MiB; on {card}")
        return med, busy

    timed_and_traced("the whole run (kernel)", lambda: tab_call(
        inputs, steps, 1, axes), iters)
    # the same photons on four times the slots (more warps a SM)
    wide = tab_steps(4 * TAB_SLOTS, TAB_PHOTONS // 4, device)
    tally = {}
    with tab_launch_times() as lt_w:
        _, wall_w = timed(lambda: tab_call(inputs, wide, 1, axes, tally))
    kernel_w = sum(x["ms"] for x in lt_w) * 1e-3
    log(f"  11a on {4 * TAB_SLOTS} slots x {TAB_PHOTONS // 4} photons: "
        f"{wall_w:.4f} s = {n_photons / wall_w:.6g} photons/s, "
        f"{tally['iterations']} iterations in {tally['syncs']} launches "
        f"({fmt_launches(lt_w)}; kernel {kernel_w:.6f} s against "
        f"{kernel_s:.6f} s on {TAB_SLOTS} slots); on {card}")
    del tally, wide
    key = rng.fold_in(rng.base_key(1), 0)
    row = tab_kernel_against_plain(inputs, axes, steps, key, TAB_CMP_ITERS,
                                   device)

    # the eager plain version on the card: tabulate's iteration run through
    # tabulate_iterations_plain for its first chunks of 16
    medium, spectra, source = inputs
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                tab_cfg(steps), 1.0, 46.0)
    n_it = TAB_PLAIN_CHUNKS * TT.CHUNK_ITERS
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)

    sp = K.pack_steps(steps)

    def first_chunks():
        # _tabulate_batch's loop, one sync a chunk, on the plain version
        table.zero_()
        state = TT.init_state(steps)
        for i0 in range(0, n_it, TT.CHUNK_ITERS):
            keys = TK.launch_keys(key, i0, TT.CHUNK_ITERS, plan.block.n_sub,
                                  plan.block.impact, device)
            TT.tabulate_iterations_plain(plan, state, sp, keys,
                                         table).tolist()

    timed_and_traced("the eager plain version's first chunks",
                     first_chunks, n_it)
    row.update(launches=launches, kernel_s=kernel_s, stats=stats,
               split=split)
    return row


def phase11b(device):
    """The analytic referee at full size: scattering off (b400 1e-9, a
    scattering length of ~1e9 m), no anisotropy, TAB_RUNS independent runs
    of 65,536 slots x TAB_REF_PHOTONS photons (fresh step directions and
    seed each) on the default spherical axes; each radial group's unnormalized content
    summed over azimuth, cos(polar) and time against
    validate/table_referee's float64 expectation, |z| < 5 with the
    standard error from the runs' spread."""
    from clsim_tpu_torch.tabulator import default_spherical_axes
    from clsim_tpu_torch.validate import table_referee as REF
    from clsim_tpu_torch.hits.acceptance import dom_angular_sensitivity
    inputs = tab_inputs(device, b400=1e-9)
    medium, spectra, _ = inputs
    axes = default_spherical_axes()
    shells, walls = [], []
    for k in range(TAB_RUNS):
        tally = {}
        steps = tab_steps(TAB_SLOTS, TAB_REF_PHOTONS, device, seed=100 + k)
        _, wall = timed(lambda: tab_call(inputs, steps, 50 + k, axes, tally))
        walls.append(wall)
        shells.append(REF.radial_shells(tally["raw"], axes.shape,
                                        TAB_GROUPS))
        del tally
    per_bin = REF.radial_expectation(
        medium, spectra, dom_angular_sensitivity(device=device),
        axes.axes[0].bin_edges(), TAB_SLOTS * TAB_REF_PHOTONS)
    expected = np.array([per_bin[lo:hi].sum() for lo, hi in TAB_GROUPS])
    z = REF.radial_z(shells, expected)
    shells = np.asarray(shells)
    edges = axes.axes[0].bin_edges()
    for (lo, hi), e, s, zz in zip(TAB_GROUPS, expected, shells.T, z):
        log(f"  11b: r {edges[lo]:.3f}-{edges[hi]:.3f} m: content "
            f"{s.sum():.8g} / expected {TAB_RUNS * e:.8g} (ratio "
            f"{s.sum() / (TAB_RUNS * e):.6f}), run spread "
            f"{s.std(ddof=1) / s.mean():.3e} relative, z {zz:.3f}")
    log(f"  11b: {TAB_RUNS} runs of {TAB_SLOTS * TAB_REF_PHOTONS} photons, "
        f"{np.mean(walls):.4f} s a run (mean), max |z| "
        f"{np.abs(z).max():.3f}")
    if not np.all(np.abs(z) < 5.0):
        raise AssertionError(f"11b: radial shells off the expectation, z {z}")


def tab_small_axes():
    """11c's reduced axes: the default kinds at coarser binning, and the
    spherical ones with an 8-bin impact-angle axis."""
    from clsim_tpu_torch.tabulator import (Axis, CylindricalAxes,
                                           SphericalAxes)
    sph = [Axis(0.0, 580.0, 50, 2), Axis(0.0, 180.0, 12), Axis(-1.0, 1.0, 20),
           Axis(0.0, 7000.0, 30, 2)]
    return {"spherical": SphericalAxes(sph),
            "cylindrical": CylindricalAxes(
                [Axis(0.0, 580.0, 40, 2), Axis(0.0, np.pi, 12),
                 Axis(-800.0, 800.0, 40), Axis(0.0, 7000.0, 30, 2)]),
            "spherical + impact": SphericalAxes(sph + [Axis(-1.0, 1.0, 8)])}


def tab_media(device):
    """11c's media beyond bench_tabulator.py's ice, each with the spherical
    reduced axes: the seeded 171-layer ice with tests/test_kernel.py's
    anisotropy and tilt, and the photonics-table ice (a tabulated medium,
    the kernel's MED 1)."""
    medium, r = seeded_ice(171, -855.0, 10.0, device)
    return {"tilt + anisotropy": aniso_tilt(medium, r, True, True, device),
            "photonics table": photonics_ice(device)}


def tab_plain_on(inputs, steps, seed, axes, device):
    """tabulate's batch loop for one batch on the plain version (launches of
    CHUNK_ITERS, one sync each, until no slot is alive): the raw table and
    the photons made."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    medium, spectra, source = inputs
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                tab_cfg(steps), 1.0, 46.0)
    key = rng.fold_in(rng.base_key(seed), 0)
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)
    state, sp = TT.init_state(steps), K.pack_steps(steps)
    made = 0.0
    for i0 in range(0, TT.MAX_ITERATIONS, TT.CHUNK_ITERS):
        keys = TK.launch_keys(key, i0, TT.CHUNK_ITERS, plan.block.n_sub,
                              plan.block.impact, device)
        c = dict(zip(TK.TAB_COUNTERS, TT.tabulate_iterations_plain(
            plan, state, sp, keys, table).tolist()))
        made += c["generated"]
        if c["alive"] == 0:
            break
    return table, made


def phase11c(device):
    """The kernel against its plain version, same seed, reduced size
    (TAB_SMALL), in five configurations: the three reduced axes on
    bench_tabulator.py's ice, and the spherical ones in a tilted
    anisotropic ice and in a photonics-table ice.  The kernel's table
    (tabulate on the card) against the plain version's on the card and the
    port's on the CPU: the deposited (unnormalized) table's L1 <= 2e-3 of
    its total and n_photons equal (the photons the plain version made on
    the card too); the spherical one round-tripped through save_table_fits
    / read_fits.  The normalized values' L1 is printed beside it:
    normalization divides both by the same float64 bin volumes, and in a
    cylindrical table one deposit that float rounding moves between two
    bins near the axis (where the azimuth is ill-conditioned and the bins'
    volumes tiny) weighs more there than thousands elsewhere."""
    import torch
    from clsim_tpu_torch.tabulator import read_fits, save_table_fits
    n, photons = TAB_SMALL
    cpu = torch.device("cpu")
    axes_of = tab_small_axes()
    cases = [(name, axes, None, None) for name, axes in axes_of.items()]
    media_card, media_cpu = tab_media(device), tab_media(cpu)
    cases += [(name, axes_of["spherical"], media_card[name], media_cpu[name])
              for name in media_card]
    for name, axes, med_card, med_cpu in cases:
        out = []
        for dev, med in ((device, med_card), (cpu, med_cpu)):
            tally = {}
            table, wall = timed(lambda: tab_call(
                tab_inputs(dev, medium=med), tab_steps(n, photons, dev), 11,
                axes, tally))
            check_table(f"11c {name} on {dev.type}", table, tally, dev)
            out.append((table, wall, tally["raw"].cpu().numpy()))
        (tk, wk, rk), (tc, wc, rc) = out
        (tp, made), wp = timed(lambda: tab_plain_on(
            tab_inputs(device, medium=med_card),
            tab_steps(n, photons, device), 11, axes, device))
        rp = tp.cpu().numpy()
        l1 = float(np.abs(rk - rc).sum() / np.abs(rc).sum())
        l1_p = float(np.abs(rk - rp).sum() / np.abs(rp).sum())
        l1_norm = float(np.abs(tk.values - tc.values).sum()
                        / np.abs(tc.values).sum())
        log(f"  11c {name}: {n} slots x {photons} photons, kernel table L1 "
            f"{l1_p:.4e} of the total against the plain version on the "
            f"card, {l1:.4e} against the port on the CPU (normalized values "
            f"{l1_norm:.4e}), n_photons {tk.n_photons:.0f} / plain on the "
            f"card {made:.0f} / CPU {tc.n_photons:.0f}; kernel {wk:.3f} s, "
            f"plain on the card {wp:.3f} s, CPU {wc:.3f} s")
        if (l1 > L1_TOL or l1_p > L1_TOL
                or not tk.n_photons == tc.n_photons == made):
            raise AssertionError(f"11c {name}: kernel and plain tables "
                                 "differ")
        if name == "spherical":
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "table.fits")
                save_table_fits(tk, path)
                vals, edges, header, _ = read_fits(path)
            if not (np.array_equal(vals, tk.values.astype(np.float32))
                    and all(np.array_equal(e, a.bin_edges())
                            for e, a in zip(edges, axes.axes))
                    and header["n_photons"] == tk.n_photons):
                raise AssertionError("11c: FITS round trip differs")
            log(f"  11c: FITS round trip of the spherical table ({vals.size} "
                "values) equal")


def engine_ring_inputs(device, n, T):
    """11d's shared-stream workload: phase 2's test_kernel workload (aniso
    + tilt) at n slots with stopping records and HIST_H ring entries."""
    medium, geo, spectra, cfg, steps, uni = small_workload(n, T, True, True,
                                                           device)
    cfg = dataclasses.replace(cfg, save_photons=True,
                              photon_history_entries=HIST_H)
    return steps, medium, geo, spectra, cfg, uni


def match_engine_rings(name, res_a, res_b, cap):
    """The engine's per-slot record rings of two runs on one stream: slots
    with the same record count (>= 99.9% of them) hold records within
    REC_TOLS and ring fields within RING_TOL (>= 99.9% of the records)."""
    from clsim_tpu_torch.propagate import engine as E
    ca = res_a.rec_count.cpu().numpy()
    cb = res_b.rec_count.cpu().numpy()
    same = ca == cb
    valid = same[:, None] & (np.arange(cap)[None, :]
                             < np.minimum(ca, cap)[:, None])
    ok = np.ones(int(valid.sum()), bool)
    worst = {}
    fields = REC_TOLS + [(f, RING_TOL) for f in E.HIST_FIELDS]
    for f, tol in fields:
        a = res_a.rec[f].double().cpu().numpy()[valid]
        b = res_b.rec[f].double().cpu().numpy()[valid]
        close = np.abs(a - b) <= tol + 1e-3 * np.abs(b)
        ok &= close.reshape(len(ok), -1).all(1)
        worst[f] = float(np.abs(a - b).max()) if a.size else 0.0
    log(f"  {name}: records {ca.sum()} / {cb.sum()}, slots with equal "
        f"counts {same.mean():.6f}, records within tolerance "
        f"{ok.sum()} of {len(ok)}; worst |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    if abs(int(ca.sum()) - int(cb.sum())) > max(2, 0.01 * cb.sum()):
        raise AssertionError(f"{name}: record counts differ")
    if same.mean() < 0.999 or ok.sum() < 0.999 * len(ok) or len(ok) < 100:
        raise AssertionError(f"{name}: records or rings differ")


def phase11d(device):
    """Scatter-history rings on the card: Simulation.simulate of a 1 TeV
    cascade on the main-path configuration with save_photons and HIST_H
    ring entries runs the engine on the card (no kernel launch); each
    record holds min(num_scatters, H) filled entries, depths rising in
    ring order up to the record's depth; and on a shared stream the card's
    engine records, rings included, match the CPU engine's."""
    import torch
    from clsim_tpu_torch.propagate import engine as E
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.sources import Particle, ParticleType
    sim, _ = main_path_sim(device, save_photons=True,
                           photon_history_entries=HIST_H)
    cascade = Particle.cascade(ParticleType.EMinus, pos=(0.0, 0.0, 0.0),
                               time=0.0, energy=RING_GEV, zenith=1.9,
                               azimuth=0.7)
    photons = steps_photons(sim, cascade, 23)
    reset_counts()
    res, wall = timed(lambda: sim.simulate([cascade], seed=23))
    launches = sum(K.MODE_LAUNCHES.values())
    rec = res.rec
    n = int(res.rec_count[0])
    log(f"  11d: {RING_GEV:.0f} GeV cascade on hex61, {N_SLOTS} slots, H "
        f"{HIST_H}: generated {float(res.n_generated):.0f} (steps' photons "
        f"{photons:.0f}), hits {float(res.n_hits):.0f}, records {n}, "
        f"{res.n_iterations} iterations, simulate {wall:.4f} s, kernel "
        f"launches {launches}, result on {res.hist.device}")
    if launches != 0 or res.diag_totals is not None:
        raise AssertionError("11d: a ring run launched the kernel")
    if res.hist.device != device or rec["hist_x"].device != device:
        raise AssertionError("11d: the engine did not run on the card")
    if float(res.n_generated) != photons or n != float(res.n_hits) or n < 100:
        raise AssertionError("11d: generated, hits or records off")
    ns = rec["num_scatters"][0].to(torch.int64)
    habs = rec["hist_abs"][0]
    filled = (habs > 0).sum(1)
    if not torch.equal(filled, torch.clamp(ns, max=HIST_H)):
        raise AssertionError("11d: filled ring entries != min(scatters, H)")
    # oldest entry first: a wrapped ring starts at num_scatters % H
    j = torch.arange(HIST_H, device=device)[None, :]
    start = torch.where(ns >= HIST_H, ns % HIST_H, 0)[:, None]
    ordered = habs.gather(1, (start + j) % HIST_H)
    used = j < torch.clamp(ns, max=HIST_H)[:, None]
    rising = (ordered[:, 1:] >= ordered[:, :-1]) | ~used[:, 1:]
    below = (habs <= rec["dist_in_abs_lens"][0][:, None] + 1e-4) | \
        (habs == 0)
    log(f"  11d: records with scatters {int((ns > 0).sum())}, wrapped rings "
        f"{int((ns > HIST_H).sum())}, most scatters {int(ns.max())}")
    if not bool(rising.all()) or not bool(below.all()):
        raise AssertionError("11d: ring depths not rising or beyond the "
                             "record's depth")
    # the card's engine against the CPU engine on one stream
    n_s, T = RING_STREAM
    runs = []
    for dev in (device, torch.device("cpu")):
        steps, medium, geo, spectra, cfg, uni = engine_ring_inputs(dev, n_s,
                                                                   T)
        runs.append(E.propagate(steps, medium, geo, spectra, 0, cfg,
                                uniforms=uni))
    match_engine_rings(f"11d shared stream ({n_s} slots x {T} iterations, "
                       "card / CPU engine)", *runs,
                       cfg.photon_capacity_per_slot)


def ptxas_figures(log_text, pick):
    """{label: dict(registers, spill_stores, spill_loads, smem, blocks)}
    from nvcc -Xptxas -v output ({} when cached) for each kernel whose
    mangled name pick(name) labels (None skips it); blocks: resident
    blocks of 256 threads a SM by registers (8 a thread per allocation
    unit) and static shared memory (228 KB a SM, 1 KB a block reserved),
    at most 8 (64 warps)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = pick(m.group(1))
            continue
        if cur is None:
            continue
        d = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            d.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            smem = int(sm.group(1)) if sm else 0
            by_regs = 65536 // (256 * (-(-regs // 8) * 8))
            by_smem = 233472 // (smem + 1024)
            d.update(registers=regs, smem=smem,
                     blocks=min(8, by_regs, by_smem))
    return out


def k1_ptxas(log_text, every=False):
    """ptxas_figures of K1's timed instantiations (K1_MANGLED), or with
    `every` of all its instantiations by mangled name."""
    if every:
        return ptxas_figures(log_text, lambda f: f if "propagate_kernel" in f
                             else None)
    return ptxas_figures(log_text, lambda f: next(
        (e for e, k in K1_MANGLED.items() if "propagate_kernel" + k in f),
        None))


def k1_ptxas_modes(log_text):
    """ptxas_figures of every K1 instantiation keyed by its mode (kernel.py
    kernel_mode) from its template arguments <RECORDS, DEP, THREEFRY,
    FIXED, COLL, MED>, so that bodies whose kernel signatures differ
    compare instantiation by instantiation."""
    import re
    out = {}
    for name, d in k1_ptxas(log_text, every=True).items():
        m = re.search(r"ILb(\d)ELi(\d)ELb(\d)ELb(\d)ELi(\d)ELi(\d)E", name)
        if m is not None:
            r, dep, tf, fx, coll, med = map(int, m.groups())
            out[dep | 4 * tf | 8 * fx | 16 * r | coll << 5 | med << 7] = d
    return out


def k1_ptxas_lines(log_text):
    """One line per K1 instantiation from nvcc's -Xptxas -v log, in mode
    order: its mode, registers, spilled bytes and resident blocks a SM."""
    return [f"K1 mode {mode}: {d.get('registers')} registers, spill "
            f"{d.get('spill_stores', 0)}/{d.get('spill_loads', 0)} bytes, "
            f"{d.get('blocks')} blocks a SM"
            for mode, d in sorted(k1_ptxas_modes(log_text).items())]


def k1_ptxas_against(results):
    """For each turn's body with a build log's K1 figures (`k1_ptxas`,
    k1_ptxas_modes' by mode, JSON keys), a line: its instantiations, and
    of those the first body also has, how many have equal figures and
    which modes differ."""
    first = next((r["k1_ptxas"] for r in results if r["k1_ptxas"]), None)
    for r in results:
        d = r["k1_ptxas"]
        if not d:
            continue
        common = [m for m in d if m in first]
        differ = [m for m in common if d[m] != first[m]]
        log(f"ptxas {r['label']}: K1's {len(d)} instantiations; of the "
            f"{len(common)} the first body also builds, "
            f"{len(common) - len(differ)} equal the first body's figures"
            + (f", modes {differ} differ" if differ else ""))


def tab_ptxas(log_text):
    """ptxas_figures of T1's 8 instantiations, labelled
    tabulate<MED, CYL, IMPACT>."""
    import re

    def pick(f):
        m = re.search(r"tabulate_kernelILi(\d)ELb(\d)ELb(\d)E", f)
        return f"tabulate<{m.group(1)}, {m.group(2)}, {m.group(3)}>" \
            if m else None

    return ptxas_figures(log_text, pick)


def k1_turn_cases(device):
    """[(entry, inputs, records, key, T, philox?, steady?)] of a turn:
    phase 2's main-path inputs on hex61 and on ic86 (both random modes),
    the record mode on both, 7a's jittered ic86 in ice and in water (with
    and without records), 8a's fixed-horizon cases at phase 2's shape and
    at the steady shape, the fit's forward in threefry and the flasher
    fit's on ic86."""
    from clsim_tpu_torch.ops import rng
    main = main_path_inputs(device)
    glob = on_ic86(main, device)
    cases7 = {e: i for e, _, i in phase7_cases(device)}
    gen, wat = cases7["propagate[general]"], cases7["propagate[water]"]
    cases8 = {e: i for e, _, i, _, _ in phase8_cases(device)}
    key = rng.as_key(FIT_KEY)
    out = [("propagate", main, False, None, PHASE2_T, True, False),
           ("propagate[global]", glob, False, None, PHASE2_T, True, False),
           ("propagate[records]", main, True, None, PHASE2_T, False, False),
           ("propagate[records,global]", glob, True, None, PHASE2_T, False,
            False),
           ("propagate[general]", gen, False, None, PHASE2_T, False, False),
           ("propagate[records,general]", gen, True, None, PHASE2_T, False,
            False),
           ("propagate[water]", wat, False, None, PHASE2_T, False, False),
           ("propagate[records,water]", wat, True, None, PHASE2_T, False,
            False)]
    for entry in FIXED_HORIZON:
        for steady in (False, True):
            out.append((entry, cases8[entry], False, None, PHASE2_T, False,
                        steady))
    return out + [
        ("propagate[threefry]", fit_workload(device) + (None,), False, key,
         FIT_T, False, False),
        ("propagate[threefry,global]", fit8_workload(device)[0] + (None,),
         False, key, FIT_T, False, False)]


def k1_turn_worker(root):
    """One turn: import the package at `root`, time every case of
    k1_turn_cases and run 8g's flashes (flash_mode_runs), print one line
    'K1 {json}' with each case's times and account (k1_stats) and each
    flash's wall and kernel seconds."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    out = dict(root=root, build_s=build_s,
               ptxas=k1_ptxas(_build.BUILD_INFO["log"]),
               k1_ptxas=k1_ptxas_modes(_build.BUILD_INFO["log"]), entries={})
    for entry, inp, records, key, T, philox, steady in k1_turn_cases(device):
        medium, geo, spectra, cfg, steps, uni = inp
        cfg = dataclasses.replace(cfg, save_photons=records)
        N = int(steps.x.shape[0])
        spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg, N, T,
                               threefry=key is not None)
        tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
        state0 = (steady_state(inp) if steady
                  else K.init_state(steps, records))
        steps_p = K.pack_steps(steps)
        keys = None if key is None else rng.key_table(key, T).to(device)
        run = lambda **kw: (lambda: K.run_fused_iterations(
            state0.clone(), steps_p, tables, spec, **kw))
        runs = {"stream": run(uniforms=uni, keys=keys)}
        if philox:
            runs["philox"] = run(seed=PHILOX_SEED)
        res = {}
        for rng_mode, fn in runs.items():
            for _ in range(20):   # the card's clocks up before the timing
                fn()
            (_, _, c, *_), ms = cuda_ms(fn, reps=11)
            res[rng_mode] = dict(ms=ms, counters=[float(x) for x in c],
                                 mode=K.kernel_mode(spec),
                                 stats=k1_stats(c, N, T))
        out["entries"][entry + ("/steady" if steady else "")] = res
    # 8g's flashes: each fixed-horizon instantiation on its path
    out["flash"] = {e: dict(wall=wall, kernel_s=ks, photons=photons,
                            stats=k1_stats(res.diag_totals))
                    for e, res, photons, wall, ks, _, _ in
                    flash_mode_runs(device)}
    print("K1 " + json.dumps(out), flush=True)


def host_split_worker(root):
    """One turn of --host-split: import the package at `root`, build its
    kernels, then for phase 3's cascade and 8b's standard-DOM flash time
    Simulation.simulate's wall and host_split's stages, three times each
    after one warm-up call; print one line 'SPLIT {json}' with the
    medians and every wall."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from clsim_tpu_torch import _build
    device = torch.device("cuda", 0)
    _build.load()
    sim, cascade = main_path_sim(device)
    fsim = flasher_sim(device)
    out = dict(root=root, native=getattr(sim.step_generator, "_native",
                                         None) is not None, cases={})
    for name, s, sources, seed in (
            ("phase 3", sim, [cascade], 11),
            ("8b", fsim, flash(fsim.geometry, STD_DOM), 21)):
        quiet(s.simulate, sources, seed=seed)
        walls, splits = [], []
        for _ in range(3):
            walls.append(timed(lambda: quiet(s.simulate, sources,
                                             seed=seed))[1])
            splits.append(host_split(s, sources, seed))
        out["cases"][name] = dict(
            simulate=float(np.median(walls)), walls=walls,
            **{k: float(np.median([sp[k] for sp in splits]))
               for k in splits[0]})
    print("SPLIT " + json.dumps(out), flush=True)


def run_turn(flag, root, prefix):
    """Run this script with `flag root` in a process of its own and parse
    its line that starts with `prefix`."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"),
                           flag, root], cwd=here, capture_output=True,
                          text=True, timeout=900)
    line = next((x for x in proc.stdout.splitlines()
                 if x.startswith(prefix)), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"turn {root} failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    return json.loads(line[len(prefix):])


def run_turns(flag, prefix, turns, json_path, report):
    """Run this script's worker `flag` for each turn 'label:root' in the
    order given (e.g. parent, new, new, parent), each in a process of its
    own (run_turn); after each, report(result, label, root, first, card)
    prints it (first: the label's first turn) and, with json_path, the
    card's name and every parsed turn are written there.  Returns the
    turns."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(card)
    results, seen = [], set()
    for turn in turns:
        label, root = turn.split(":")
        r = run_turn(flag, root, prefix)
        r["label"] = label
        results.append(r)
        report(r, label, root, label not in seen, card)
        seen.add(label)
        if json_path:
            with open(json_path, "w") as f:
                json.dump(dict(card=card, turns=results), f)
    return results


def host_split_turns(turns, json_path=None):
    """--host-split LABEL:ROOT ...: host_split_worker for each turn in the
    order given, printing each turn's simulate wall and stages."""
    def report(r, label, root, first, card):
        for name, c in r["cases"].items():
            log(f"turn {label} ({root}, native sampler {r['native']}) "
                f"{name}: simulate {c['simulate']:.4f} s (walls "
                + ", ".join(f"{w:.4f}" for w in c["walls"]) + "); "
                + fmt_split(c))

    return run_turns("--split-worker", "SPLIT ", turns, json_path, report)


def k1_turns(turns, json_path=None):
    """--turns LABEL:ROOT ...: k1_turn_worker for each turn in the order
    given, printing every turn's times, each case's account in the first
    turn of each body, and the ptxas figures of each body."""
    def report(r, label, root, first, card):
        log(f"turn {label} ({root}), build {r['build_s']:.1f} s: "
            + "; ".join(f"{e} " + ", ".join(f"{m} {v[m]['ms']:.4f} ms"
                                            for m in v)
                        for e, v in r["entries"].items()))
        log(f"  flashes {label}: " + "; ".join(
            f"{e} simulate {v['wall']:.3f} s, kernel {v['kernel_s']:.4f} s"
            for e, v in r["flash"].items()))
        if first:
            for e, v in r["entries"].items():
                log(f"  account {label} {e}: " + fmt_stats(v["stream"]["stats"]))
            for e, v in r["flash"].items():
                log(f"  account {label} flash {e}: " + fmt_stats(v["stats"]))

    results = run_turns("--k1-worker", "K1 ", turns, json_path, report)
    ptx = {}
    for r in results:
        for e, d in r["ptxas"].items():
            ptx.setdefault(r["label"], {})[e] = d
    for label, d in ptx.items():
        log(f"ptxas {label}: " + json.dumps(d))
    k1_ptxas_against(results)
    return results


# the benchmark's stream cells at a small size (--cell-turns): the first
# events of each traffic mix's pool on its configuration's world
CELL_CONFIG = "ic86-production"
CELL_EVENTS = {"cascades-40tev": 8, "flashes": 2}
CELL_SEED = 2 ** 33 + 22


@contextlib.contextmanager
def coarse_cull_lists():
    """Within the block, plans build the card's cull table with the JAX
    package's coarse lists (card_cull_table's fallback, budget 0); kept
    plans are dropped on entry and on exit."""
    from clsim_tpu_torch.propagate import kernel as K
    inner = K.card_cull_table
    K.clear_plans()
    K.card_cull_table = lambda *a, **kw: inner(*a, **dict(kw, budget=0))
    try:
        yield
    finally:
        K.card_cull_table = inner
        K.clear_plans()


def cell_turn_worker(root):
    """One turn of --cell-turns: import the package at `root`, build its
    kernels, then on the benchmark configuration's world (this checkout's
    benchmark/) propagate the first CELL_EVENTS events of each stream
    traffic with Simulation.simulate after one warm-up event: K1's launches'
    seconds between CUDA events, the photons, the hits and the account
    (k1_stats of the summed counters); where the body has the card's cull
    table, the same events again with the coarse lists (coarse_cull_lists),
    whose hits, counts and histograms must equal the card's.  Prints one
    line 'CELL {json}'."""
    sys.path.insert(0, os.path.abspath(root))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(1, here)
    import importlib
    import torch
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.propagate import kernel as K
    from benchmark.world import PROGRAM, program_world
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    out = dict(root=root, build_s=time.perf_counter() - t0,
               k1_ptxas=k1_ptxas_modes(_build.BUILD_INFO["log"]), cases={})
    bench = os.path.join(here, "benchmark")
    with open(os.path.join(bench, "configs", CELL_CONFIG + ".json")) as f:
        conf = json.load(f)
    world = quiet(program_world, conf, device)
    variants = {"card": contextlib.nullcontext}
    if hasattr(K, "card_cull_table"):
        variants["coarse"] = coarse_cull_lists
    for traffic, n_ev in CELL_EVENTS.items():
        with open(os.path.join(bench, "traffic", traffic + ".json")) as f:
            tr = json.load(f)
        src = importlib.import_module(f"benchmark.sources.{tr['source']}")
        events = [src.sources(PROGRAM, world, d)
                  for d in src.pool(tr, conf)[:n_ev + 1]]
        runs = {}
        for name, ctx in variants.items():
            with ctx():
                quiet(world.sim.simulate, events[0], seed=CELL_SEED)
                totals, hists, hits = 0.0, [], []
                with launch_times() as ks:
                    t0 = time.perf_counter()
                    for i, ev in enumerate(events[1:]):
                        res = quiet(world.sim.simulate, ev,
                                    seed=CELL_SEED + 1 + i)
                        totals = totals + res.diag_totals.double().cpu()
                        hists.append(res.hist.double().cpu())
                        hits.append(float(res.n_hits))
                    wall = time.perf_counter() - t0
            photons = float(totals[K.CNT_GEN])
            runs[name] = dict(k1_s=ks[0], wall=wall, photons=photons,
                              ns_per_photon=ks[0] / photons * 1e9,
                              hits=hits, counters=totals.tolist(),
                              stats=k1_stats(totals), hists=hists)
        if "coarse" in runs:
            a, b = runs["card"], runs["coarse"]
            same = [k for k in ("CNT_GEN", "CNT_HITS", "CNT_TESTED",
                                "CNT_CULL", "CNT_ROWS", "CNT_WALK")
                    if a["counters"][getattr(K, k)]
                    != b["counters"][getattr(K, k)]]
            l1 = max(float((x - y).abs().sum() / max(float(y.sum()), 1.0))
                     for x, y in zip(a["hists"], b["hists"]))
            if a["hits"] != b["hits"] or same or l1 > 1e-5:
                raise AssertionError(
                    f"{traffic}: the card's lists and the coarse lists "
                    f"differ: hits {a['hits']} / {b['hits']}, counters "
                    f"{same}, histogram L1 {l1:.3g}")
            a["coarse_l1"] = l1
        for r in runs.values():
            del r["hists"]
        out["cases"][traffic] = runs
    print("CELL " + json.dumps(out), flush=True)


def cell_turns(turns, json_path=None):
    """--cell-turns LABEL:ROOT ...: cell_turn_worker for each turn in the
    order given, printing each case's K1 seconds a photon and account and
    the ptxas figures of the global plans' instantiations (COLL 1, 2)."""
    def report(r, label, root, first, card):
        for traffic, runs in r["cases"].items():
            for name, v in runs.items():
                log(f"turn {label} ({root}) {traffic} [{name} lists]: K1 "
                    f"{v['k1_s']:.4f} s for {v['photons']:.0f} photons, "
                    f"{v['ns_per_photon']:.4f} ns a photon, simulate "
                    f"{v['wall']:.3f} s, hits {sum(v['hits']):.0f}; "
                    + fmt_stats(v["stats"]))
        if first:
            for mode, d in sorted(r["k1_ptxas"].items(), key=lambda x:
                                  int(x[0])):
                if (int(mode) >> 5) & 3:
                    log(f"  ptxas {label} K1 mode {mode}: "
                        f"{d.get('registers')} registers, spill "
                        f"{d.get('spill_stores', 0)}/"
                        f"{d.get('spill_loads', 0)} bytes, "
                        f"{d.get('blocks')} blocks a SM")

    return run_turns("--cell-worker", "CELL ", turns, json_path, report)


def tab_turn_worker(root):
    """One turn of --tab-turns: import the package at `root`, build its
    kernels, then time T1's kernel row (11a's first TAB_CMP_ITERS
    iterations on every slot, TAB_ROW_WARM + TAB_ROW_REPS launches between
    CUDA events: the median of the first TAB_REPS, as the kernels line
    times it, and of the last TAB_ROW_REPS, warm), TAB_REPS runs of 11a's
    full tabulate (wall, and each kernel
    launch between CUDA events) and one on four times the slots; print one
    line 'TAB {json}' with these, the runs' counters and the ptxas figures
    of T1's instantiations and of every K1 instantiation."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import default_spherical_axes
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    log_text = _build.BUILD_INFO["log"]
    out = dict(root=root, build_s=time.perf_counter() - t0,
               ptxas=tab_ptxas(log_text),
               k1_ptxas=k1_ptxas_modes(log_text))
    inputs = tab_inputs(device)
    axes = default_spherical_axes()
    tab_call(inputs, tab_steps(1024, 1, device), seed=0)      # warm-up
    steps = tab_steps(TAB_SLOTS, TAB_PHOTONS, device)
    medium, spectra, source = inputs
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                tab_cfg(steps), 1.0, 46.0)
    keys = TK.launch_keys(rng.fold_in(rng.base_key(1), 0), 0, TAB_CMP_ITERS,
                          plan.block.n_sub, plan.block.impact, device)
    state0, sp = TT.init_state(steps), K.pack_steps(steps)
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)
    c, _, times, _ = launch_ms(lambda st, tb: TK.launch(
        plan.block, st, sp, keys, tb), state0, table,
        TAB_ROW_WARM + TAB_ROW_REPS)
    out["row"] = dict(ms=float(np.median(times[TAB_ROW_WARM:])),
                      cold_ms=float(np.median(times[:TAB_REPS])),
                      times=times,
                      counters=dict(zip(TK.TAB_COUNTERS, c.tolist())))
    del table
    out["runs"] = []
    for _ in range(TAB_REPS):
        tally = {}
        with tab_launch_times() as lt:
            _, wall = timed(lambda: tab_call(inputs, steps, 1, axes, tally))
        out["runs"].append(dict(wall=wall, iterations=tally["iterations"],
                                kernel_ms=sum(x["ms"] for x in lt),
                                launches=lt))
    wide = tab_steps(4 * TAB_SLOTS, TAB_PHOTONS // 4, device)
    with tab_launch_times() as lt:
        _, wall = timed(lambda: tab_call(inputs, wide, 1, axes))
    out["wide"] = dict(wall=wall, kernel_ms=sum(x["ms"] for x in lt),
                       launches=lt)
    print("TAB " + json.dumps(out), flush=True)


def tab_turns(turns, json_path=None):
    """--tab-turns LABEL:ROOT ...: tab_turn_worker for each turn in the
    order given, printing each turn's kernel row, each run's wall and
    kernel time with every launch, the runs' account (tab_stats) on the
    first turn of each body, and the ptxas figures of each body (T1's,
    and whether K1's equal the first body's)."""
    def report(r, label, root, first, card):
        runs = r["runs"]
        log(f"turn {label} ({root}), build {r['build_s']:.1f} s: kernel row "
            f"{r['row']['ms']:.4f} ms (median of {TAB_ROW_REPS} after "
            f"{TAB_ROW_WARM}; of the first {TAB_REPS}: "
            f"{r['row']['cold_ms']:.4f}); 11a "
            f"kernel " + ", ".join(f"{x['kernel_ms']:.3f}" for x in runs)
            + " ms, wall " + ", ".join(f"{x['wall']:.4f}" for x in runs)
            + f" s; 4x slots kernel {r['wide']['kernel_ms']:.3f} ms, wall "
            f"{r['wide']['wall']:.4f} s; on {card}")
        log(f"  launches {label}: " + fmt_launches(runs[0]["launches"]))
        if first:
            log(f"  account {label} kernel row: "
                + fmt_tab_stats(tab_stats(r["row"]["counters"])))
            log(f"  account {label} 11a: " + fmt_tab_stats(tab_stats(
                summed(runs[0]["launches"]))))
            log(f"  account {label} 4x slots: " + fmt_tab_stats(tab_stats(
                summed(r["wide"]["launches"]))))

    results = run_turns("--tab-worker", "TAB ", turns, json_path, report)
    for r in results:
        if r["ptxas"]:
            log(f"ptxas {r['label']}: " + json.dumps(r["ptxas"]))
    k1_ptxas_against(results)
    return results


# ---------------------------------------------------------------------------
# phase 12: photons over ranks (parallel/mesh.py, parallel/bootstrap.py)
# ---------------------------------------------------------------------------

MESH_RANKS = 2           # 12b's ranks, processes sharing the one card
MESH_FIT_LR = 1e-3       # 12b's IceFit step


def all_reduce_ms(mesh, res, reps=3):
    """Median milliseconds of all_reduce_result on `res` (the result's
    float64 buffer summed, the iteration count maxed) over the mesh."""
    import torch
    from clsim_tpu_torch.parallel.mesh import all_reduce_result
    times = []
    for _ in range(reps):
        _, t = timed(lambda: all_reduce_result(res, mesh))
        times.append(t * 1e3)
    return float(np.median(times))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def batch_keys(seed, n):
    """Simulation.run_steps' batch keys on a mesh: fold_in(PRNGKey(seed), i)."""
    from clsim_tpu_torch.ops import rng
    return [rng.fold_in(rng.base_key(seed), i) for i in range(n)]


def slot_slice(batch, r, n_ranks):
    """Rank r's contiguous slot slice of a slot batch (host or tensors)."""
    n = int(batch.x.shape[0]) // n_ranks
    return type(batch)(*[f[r * n:(r + 1) * n] for f in batch])


def one_process_slices(sim, batches, seed, n_ranks):
    """Every rank's slot slice of every batch through propagate_auto's
    kernel with the kernel body's seed of that rank (parallel/mesh.
    shard_seed), summed in one process: the histogram and the counters."""
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.parallel.mesh import shard_seed
    from clsim_tpu_torch.propagate.dispatch import propagate_auto
    hist, totals = 0.0, 0.0
    for b, key in zip(batches, batch_keys(seed, len(batches))):
        for r in range(n_ranks):
            res = propagate_auto(
                steps_from_numpy(slot_slice(b, r, n_ranks)._asdict(),
                                 sim.device), sim.medium, sim.geometry,
                sim.spectra, shard_seed(key, r), sim.config, backend="fused")
            hist = hist + res.hist.double()
            totals = totals + res.diag_totals
    return hist, totals


def phase12a(device, card):
    """Simulation(mesh=) of phase 3's cascade at world size 1 on NCCL,
    against propagate_auto on the same slot batches with rank 0's seed."""
    import torch
    import torch.distributed as dist
    from clsim_tpu_torch.parallel.bootstrap import (global_photon_mesh,
                                                    initialize_distributed)
    from clsim_tpu_torch.propagate import kernel as K
    ok = initialize_distributed(f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    try:
        backend = dist.get_backend()
        mesh = global_photon_mesh()
        log(f"  initialize_distributed -> {ok}, backend {backend}, mesh "
            f"rank {mesh.rank} of {mesh.size} on {mesh.device}")
        if not ok or backend != "nccl" or mesh.size != 1:
            raise AssertionError("world 1 did not come up on NCCL")
        sim, cascade = main_path_sim(device, mesh=mesh)
        run = sim._propagate
        if run.backend != "fused":
            raise AssertionError(f"the mesh served {run.backend}: "
                                 f"{run.backend_reason}")
        photons = steps_photons(sim, cascade, 11)
        # the first collective sets up NCCL's communicator
        _, first = timed(lambda: sim.simulate([cascade], seed=11))
        reset_counts()
        res, wall = timed(lambda: sim.simulate([cascade], seed=11))
        launches = K.MODE_LAUNCHES[0]
        check_run("Simulation(mesh=) world 1", res, photons)
        hsum = float(res.hist.double().sum())
        if abs(hsum / float(res.weight_hits) - 1.0) > 1e-4:
            raise AssertionError("histogram sum differs from the hit weight")
        if launches <= 0:
            raise AssertionError("the mesh did not launch the main-path "
                                 "instantiation")
        batches = sim.steps_from_particles([cascade],
                                           np.random.default_rng(11))
        h_ref, c_ref = one_process_slices(sim, batches, 11, 1)
        compare("mesh world 1 / propagate_auto with rank 0's seed",
                res.diag_totals, res.hist, c_ref, h_ref)
        log(f"  launches {launches}; simulate over the mesh {wall:.4f} s = "
            f"{photons / wall:.6g} photons/s end to end (the first call, "
            f"NCCL's set-up included, {first:.4f} s); all_reduce_result of "
            f"the result ({res.hist.numel() + res.diag_totals.numel() + 3} "
            f"float64) {all_reduce_ms(mesh, res):.3f} ms, median of 3 "
            f"({card})")
    finally:
        dist.destroy_process_group()


def mesh_worker(port, rank, n_ranks, root):
    """One rank of 12b: join the group of n_ranks processes (gloo when they
    share the cards, NCCL with a card each: bootstrap.default_backend),
    propagate this rank's process_step_slice of phase 3's slot batches
    through make_sharded_propagate, take one IceFit(mesh=) step on this
    rank's slice of the fit workload, and write root/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.parallel.bootstrap import (global_photon_mesh,
                                                    initialize_distributed,
                                                    process_step_slice)
    from clsim_tpu_torch.parallel.mesh import IceFit, make_sharded_propagate
    from clsim_tpu_torch.propagate import kernel as K
    _build.load()     # phase 1 built the library: this only loads it
    ok = initialize_distributed(f"tcp://127.0.0.1:{port}",
                                world_size=n_ranks, rank=rank)
    mesh = global_photon_mesh()
    if not ok or mesh.rank != rank or mesh.size != n_ranks:
        raise AssertionError("the rank did not join the group")
    device = mesh.device
    out = dict(rank=rank, device=str(device), backend_dist=dist.get_backend())
    sim, cascade = main_path_sim(device, mesh=mesh)
    run = make_sharded_propagate(mesh, sim.config, medium=sim.medium,
                                 geo=sim.geometry, spectra=sim.spectra)
    batches = sim.steps_from_particles([cascade], np.random.default_rng(11))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, totals = 0.0, 0.0
    for b, key in zip(batches, batch_keys(11, len(batches))):
        sl = process_step_slice(int(b.x.shape[0]))
        local = steps_from_numpy({k: v[sl] for k, v in b._asdict().items()},
                                 device)
        res = run(local, sim.medium, sim.geometry, sim.spectra, key)
        hist = hist + res.hist.double()
        totals = totals + res.diag_totals
    torch.cuda.synchronize()
    out.update(backend=run.backend, wall=time.perf_counter() - t0,
               launches=K.MODE_LAUNCHES[0], hist=hist.cpu(),
               totals=totals.cpu(), batches=len(batches),
               all_reduce_ms=all_reduce_ms(mesh, res))
    # one IceFit step on this rank's slice of the fit workload
    medium, geo, spectra, cfg, steps = fit_workload(device)
    fit_in = torch.load(os.path.join(root, "fit.pt"), weights_only=True)
    sl = process_step_slice(FIT_SLOTS)
    fit = IceFit(cfg, geo, spectra, forward="fused", max_iterations=FIT_T,
                 param_transform=band_transform(medium),
                 learning_rate=MESH_FIT_LR, mesh=mesh)
    step = lambda: fit.step({"log_s": fit_in["pert"].to(device)}, medium,
                            type(steps)(*[f[sl] for f in steps]), FIT_KEY,
                            fit_in["target"].to(device))
    reset_counts()
    (p, loss), fit_wall = timed(step)
    out.update(fit_wall=fit_wall, loss=float(loss), log_s=p["log_s"].cpu(),
               fit_launches=K.MODE_LAUNCHES[K.DEP_EXPECTED
                                            | K.MODE_THREEFRY])
    # the same step again: the first one of a process also loads the
    # engine's CUDA kernels
    out["fit_wall_again"] = timed(step)[1]
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


def fit_band(medium):
    """fit_gates' band: the layers [lo, hi) whose centres lie in FIT_BAND."""
    L = medium.n_layers
    centres = float(medium.layers_z_start) + (np.arange(L) + 0.5) * \
        float(medium.layer_height)
    band = np.nonzero((centres > FIT_BAND[0]) & (centres < FIT_BAND[1]))[0]
    return int(band[0]), int(band[-1]) + 1


def band_transform(medium):
    """fit_gates' a_dust400 transform: the band's layers scaled by
    exp(log_s), the rest held at the truth."""
    import torch
    lo, hi = fit_band(medium)
    true = medium.a_dust400.clone()
    return lambda p: {"a_dust400": torch.cat([
        true[:lo], true[lo:hi] * torch.exp(p["log_s"]), true[hi:]])}


def mesh_batches(sim, cascade, n_ranks):
    """Simulation.steps_from_particles of `cascade` (seed 11) on a mesh of
    n_ranks: slot batches of n_ranks x n_slots slots."""
    from clsim_tpu_torch.sources.ppc import assign_steps_to_slots
    from clsim_tpu_torch.types import StepBatch
    return assign_steps_to_slots(StepBatch.concatenate(
        sim.source_converter.convert([(cascade, 0)],
                                     np.random.default_rng(11))),
        n_ranks * sim.config.n_slots)


def phase12b(device, card, n_ranks=MESH_RANKS):
    """n_ranks ranks, each a process of this script (--mesh-worker): by
    default two on gloo sharing cuda:0; with a card a rank (--mesh N), NCCL.
    The all-reduced main path against one process summing every slice with
    its rank's seed, and one IceFit(mesh=) step against -lr * sum_r g_r
    computed in one process."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.parallel.mesh import IceFit
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps = fit_workload(device)
    tf = band_transform(medium)
    lo, hi = fit_band(medium)
    pert = torch.as_tensor(np.random.default_rng(99).normal(
        0.0, 0.2, hi - lo).astype(np.float32), device=device)
    fit = IceFit(cfg, geo, spectra, forward="fused", max_iterations=FIT_T,
                 param_transform=tf)
    slices = [slot_slice(steps, r, n_ranks) for r in range(n_ranks)]
    keys = [rng.fold_in(rng.as_key(FIT_KEY), r) for r in range(n_ranks)]
    with torch.no_grad():    # the target: the sharded forward at the truth
        target = sum(fit.one_forward(medium, s, k)
                     for s, k in zip(slices, keys))
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.save(dict(pert=pert.cpu(), target=target.cpu()),
               os.path.join(root, "fit.pt"))
    here = os.path.abspath(__file__)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, "--mesh-worker",
                               str(port), str(r), str(n_ranks), root],
                              cwd=os.path.dirname(here),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n_ranks)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed ({p.returncode}):\n"
                                 + o[-4000:])
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
             for r in range(n_ranks)]
    expected = "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"
    for r, o in enumerate(ranks):
        if o["backend_dist"] != expected:
            raise AssertionError(f"rank {r} joined on {o['backend_dist']}, "
                                 f"not {expected}")
        log(f"  rank {r} on {o['device']} ({o['backend_dist']}): "
            f"{o['backend']} body, "
            f"{o['batches']} batch(es), propagation {o['wall']:.4f} s "
            f"(all_reduce_result alone {o['all_reduce_ms']:.3f} ms, median "
            f"of 3), {o['launches']} main-path launches; IceFit step "
            f"{o['fit_wall']:.4f} s (the same step again "
            f"{o['fit_wall_again']:.4f} s), {o['fit_launches']} threefry "
            f"launches, "
            f"loss {o['loss']:.9g} ({card})")
        if o["backend"] != "fused" or o["launches"] <= 0 \
                or o["fit_launches"] <= 0:
            raise AssertionError(f"rank {r} did not launch the kernel")
    log(f"  the ranks' processes took {wall:.1f} s, start-up included")
    r0 = ranks[0]
    for o in ranks[1:]:
        if not (torch.equal(o["hist"], r0["hist"])
                and torch.equal(o["totals"], r0["totals"])
                and torch.equal(o["log_s"], r0["log_s"])
                and o["loss"] == r0["loss"]):
            raise AssertionError("the ranks' results differ")
    # one process: both slices of phase 3's batches with each rank's seed
    sim, cascade = main_path_sim(device)
    batches = mesh_batches(sim, cascade, n_ranks)
    h_ref, c_ref = one_process_slices(sim, batches, 11, n_ranks)
    compare(f"mesh world {n_ranks} / one process summing every slice",
            r0["totals"].to(device), r0["hist"].to(device), c_ref, h_ref)
    diag = r0["totals"]
    if float(diag[K.CNT_DROPPED]) != 0 or float(diag[K.CNT_ALIVE]) != 0:
        raise AssertionError("photons dropped or abandoned over the mesh")
    # the fit: each rank's gradient dL/dH . dh_r/dp in one process
    x = pert.clone().requires_grad_(True)
    med = medium._replace(**tf({"log_s": x}))
    hs = [fit.one_forward(med, s, k) for s, k in zip(slices, keys)]
    total = sum(h.detach() for h in hs)
    chi2 = lambda h: ((h - target) ** 2).sum() / torch.clamp(target.sum(),
                                                              min=1.0)
    g = [torch.autograd.grad(chi2(total + h - h.detach()), x,
                             retain_graph=True)[0] for h in hs]
    want = -MESH_FIT_LR * sum(g)
    got = r0["log_s"].to(device) - pert
    rel = float((got - want).norm() / want.norm())
    l_ref = float(chi2(total))
    rel_jax = float((got + MESH_FIT_LR * n_ranks * g[0]).norm()
                    / want.norm())
    log(f"  IceFit(mesh=) step against -lr sum_r g_r: rel {rel:.3g} (norm "
        f"{float(want.norm()):.6g}; |g_r| "
        + ", ".join(f"{float(v.norm()):.6g}" for v in g)
        + f"; against the JAX rule -lr {n_ranks} g_0: {rel_jax:.3g}); loss "
        f"{r0['loss']:.9g}, one process {l_ref:.9g}")
    if not rel <= 1e-3:
        raise AssertionError("the mesh's fit step is not -lr sum_r g_r")
    if abs(r0["loss"] / l_ref - 1.0) > 1e-4:
        raise AssertionError("the mesh's loss differs from one process's")


# ---------------------------------------------------------------------------
# phase 13: every configuration the JAX kernel serves (K1·B4, B5): in-kernel
# threefry with the detect modes and records, the goldens in their own
# stream, the hole-ice angular polynomial at full length, the tabulated
# scattering angle in the closed-form ice
# ---------------------------------------------------------------------------

TF_KEY = (13, 2026)        # 13a's threefry key
# 13a's deposit modes, each with threefry: config changes and entry names
TF_MODES = {"stop": dict(), "pass": dict(stop_on_detection=False),
            "fixed": dict(fixed_abs_lens=8.0),
            "pass,fixed": dict(stop_on_detection=False, fixed_abs_lens=8.0),
            "records": dict(save_photons=True)}
# iterations of one threefry call on a path (the key table covers one
# call): enough to drain phase 3's cascade and the goldens' slot batches
TF_PATH_T = 32768


def tf_entry(mode, glob):
    return f"propagate[threefry,{mode}{',global' if glob else ''}]"


def tf_against(name, inputs, key):
    """One threefry instantiation at phase 2's shape: the kernel against the
    same kernel fed rng.make_uniform_stream of the key (equal generated
    and hit counts, histograms equal up to atomic order, L1 <= 1e-5, and
    equal record counts) and against its plain version with the key table
    (phase 2's tolerances, the walk steps, records by 5a's matching); the
    Philox sibling (the same mode without threefry) timed beside it."""
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, uni = inputs
    rec = cfg.save_photons
    spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg, N_SLOTS,
                           PHASE2_T, threefry=True)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    sib = spec._replace(threefry=False)
    state0, steps_p = K.init_state(steps, rec), K.pack_steps(steps)
    keys = rng.key_table(key, PHASE2_T).to(state0.device)
    run = lambda sp, **kw: (lambda: K.run_fused_iterations(
        state0.clone(), steps_p, tables, sp, **kw))
    run_t, run_s = run(spec, keys=keys), run(sib, uniforms=uni)
    run_x = run(sib, seed=PHILOX_SEED)
    run_p = lambda: K.run_fused_iterations_plain(state0.clone(), steps_p,
                                                 tables, spec, keys=keys)
    run_t()
    (_, h_t, c_t, *r_t), ms_t = cuda_ms(run_t)
    (_, h_s, c_s, *r_s), ms_s = cuda_ms(run_s, reps=1)
    run_x()
    (_, _, c_x, *_), ms_x = cuda_ms(run_x)
    (_, h_p, c_p, *r_p), ms_p = cuda_ms(run_p, reps=1)
    l1 = float((h_t.double() - h_s.double()).abs().sum())
    tot = float(h_s.double().sum())
    log(f"  {name}: threefry / stream-fed kernel: generated "
        f"{float(c_t[K.CNT_GEN]):.0f} / {float(c_s[K.CNT_GEN]):.0f}, hits "
        f"{float(c_t[K.CNT_HITS]):.0f} / {float(c_s[K.CNT_HITS]):.0f}, hist "
        f"L1 {l1:.6g} of {tot:.6g}")
    if float(c_t[K.CNT_GEN]) != float(c_s[K.CNT_GEN]) or \
            float(c_t[K.CNT_HITS]) != float(c_s[K.CNT_HITS]):
        raise AssertionError(f"{name}: threefry and stream-fed kernel counts "
                             "differ")
    if l1 > 1e-5 * tot:
        raise AssertionError(f"{name}: threefry and stream-fed kernel "
                             "histograms differ beyond atomic order")
    err = compare(name + ", threefry kernel / plain", c_t, h_t, c_p, h_p,
                  1e-5)
    check_walk(name, c_t, c_p)
    n_rec = 0
    if rec:
        (r_t,), (r_s,), (r_p,) = r_t, r_s, r_p
        n_rec = r_t.shape[0]
        if n_rec != r_s.shape[0]:
            raise AssertionError(f"{name}: threefry and stream-fed record "
                                 "counts differ")
        for who, c, r in (("kernel", c_t, r_t), ("plain", c_p, r_p)):
            if not r.shape[0] == float(c[K.CNT_HITS]) \
                    == float(c[K.CNT_QUEUED]):
                raise AssertionError(f"{name}: {who} records != hits")
        if abs(n_rec - r_p.shape[0]) > max(2.0, 0.01 * r_p.shape[0]):
            raise AssertionError(f"{name}: record counts differ")
        n_ok, nk, npl = match_records(name, r_t, r_p, cfg.hist_n_bins)
        if n_ok < 0.999 * max(nk, npl):
            raise AssertionError(f"{name}: {n_ok} of {nk} / {npl} records "
                                 "match")
    bound = kernel_bound(spec, tables, c_t, "threefry", n_records=n_rec)
    bound_x = kernel_bound(sib, tables, c_x, "philox", n_records=n_rec)
    log(f"  {name}: mode {K.kernel_mode(spec)}, threefry kernel "
        f"{ms_t:.4f} ms (median of 5), bound {bound[0]:.4f} ms by "
        f"{bound[1]}; Philox sibling (mode {K.kernel_mode(sib)}) "
        f"{ms_x:.4f} ms (median of 5), bound {bound_x[0]:.4f} ms by "
        f"{bound_x[1]}; stream-fed {ms_s:.4f} ms, plain {ms_p:.3f} ms "
        f"({N_SLOTS} slots x {PHASE2_T} iterations); "
        + fmt_stats(k1_stats(c_t, N_SLOTS, PHASE2_T)))
    return dict(ms=ms_t, plain_ms=ms_p, err=err, bound=bound,
                mode=K.kernel_mode(spec), ms_philox=ms_x)


def phase13a(device):
    """Threefry with every detect mode and with records, on the main-path
    configuration (mode 0's family) and on ic86 (global affine), each at
    phase 2's shape (tf_against).  Returns {entry: figures}."""
    from clsim_tpu_torch.ops import rng
    key = rng.as_key(TF_KEY)
    main = main_path_inputs(device)
    uni = rng.make_uniform_stream(key.to(device), PHASE2_T, N_SLOTS)
    out = {}
    for glob, inputs in ((False, main), (True, on_ic86(main, device))):
        medium, geo, spectra, cfg, steps, _ = inputs
        for mode, change in TF_MODES.items():
            name = tf_entry(mode, glob)
            out[name] = tf_against(
                name, (medium, geo, spectra,
                       dataclasses.replace(cfg, **change), steps, uni), key)
    return out


def tf_run(name, steps_list, medium, geo, spectra, cfg, key, photons):
    """The slot batches through propagate_fused(threefry_key=fold_in(key,
    i), max_calls=1) in one call of TF_PATH_T iterations each, summed;
    with records, a buffer for every photon.  Holds nothing dropped or
    abandoned, generated = `photons` when given, records = hits.  Returns
    (hist, totals, records, wall)."""
    import torch
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    hist, totals, n_rec = 0.0, 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, st in enumerate(steps_list):
        kw = {}
        if cfg.save_photons:
            kw["rec_capacity"] = int(st.num_photons.sum()) + 1
        res, tot = quiet(K.propagate_fused, st, medium, geo, spectra, 0, cfg,
                         iters_per_call=TF_PATH_T, max_calls=1,
                         threefry_key=rng.fold_in(key, i), **kw)
        hist = hist + res.hist.double()
        totals = totals + tot
        if cfg.save_photons:
            n_rec += int(res.rec_count[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen, hits = float(totals[K.CNT_GEN]), float(totals[K.CNT_HITS])
    log(f"  {name}: {len(steps_list)} slot batch(es) in {wall:.3f} s; "
        f"generated {gen:.0f}" + ("" if photons is None else
                                   f" (steps' photons {photons:.0f})")
        + f", hits {hits:.0f}, abandoned {float(totals[K.CNT_ALIVE]):.0f}, "
        f"dropped {float(totals[K.CNT_DROPPED]):.0f}"
        + (f", records {n_rec}" if cfg.save_photons else ""))
    if photons is not None and gen != photons:
        raise AssertionError(f"{name}: generated != the steps' photons")
    if float(totals[K.CNT_ALIVE]) != 0 or float(totals[K.CNT_DROPPED]) != 0:
        raise AssertionError(f"{name}: photons abandoned or dropped")
    if not hits > 0 or not bool(hist.isfinite().all()):
        raise AssertionError(f"{name}: no hits or a non-finite histogram")
    if cfg.save_photons and n_rec != hits:
        raise AssertionError(f"{name}: records != hits")
    return hist, totals, n_rec, wall


def phase13a_path(device, entries):
    """13a's instantiations on a path: phase 3's cascade (seed 11) through
    propagate_fused with threefry_key = fold_in(TF_KEY, batch) in each
    mode, on hex61 and on ic86.  Returns the launches of each mode."""
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.ops import rng
    sim, cascade = main_path_sim(device)
    batches = sim.steps_from_particles([cascade], np.random.default_rng(11))
    steps_list = [steps_from_numpy(b._asdict(), device) for b in batches]
    photons = float(sum(int(b.num_photons.sum()) for b in batches))
    g86 = ic86(device)
    key = rng.as_key(TF_KEY)
    n = {}
    for glob, geo, spectra in ((False, sim.geometry, sim.spectra),
                               (True, g86, medium_spectra(sim.medium, g86,
                                                          device))):
        for mode, change in TF_MODES.items():
            name = tf_entry(mode, glob)
            cfg = dataclasses.replace(sim.config, **change)
            reset_counts()
            tf_run(name + " path (phase 3's cascade)", steps_list, sim.medium,
                   geo, spectra, cfg, key, photons)
            n.update(launched([entries[name]["mode"]]))
            log(f"    launches {K_other()}")
            if n[entries[name]["mode"]] <= 0:
                raise AssertionError(f"{name}: not launched on its path")
    return n


def phase13b(device):
    """The goldens in their own threefry stream through the kernel: each
    slot batch i through propagate_fused(threefry_key=fold_in(
    base_key(GOLDEN_SEED), i), max_calls=1), the keys util.golden's
    engine run takes, summed; n_generated equal to the golden's, hits
    within max(2, 1%), histogram L1 <= 2e-3 of the golden's total (phase
    2's contract for kernel against plain), printed beside
    compare_to_golden's 1e-3.  config2's golden was frozen with spice_lea:
    without it in the repository its histogram is held against the port's
    engine on the card in the same stream and on the same fallback ice
    (util.golden._run_threefry), and its photon count against the golden.
    Returns the launches."""
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.util import golden as G
    n = collections.Counter()
    for name, make in G.CONFIGS.items():
        sim, sources = make(device)
        batches = sim.steps_from_particles(
            sources, np.random.default_rng(G.GOLDEN_SEED))
        steps_list = [steps_from_numpy(b._asdict(), device) for b in batches]
        g = G.load_golden(name)
        reset_counts()
        hist, tot, _, _ = tf_run(f"{name} (threefry, kernel)", steps_list,
                                 sim.medium, sim.geometry, sim.spectra,
                                 sim.config, rng.base_key(G.GOLDEN_SEED),
                                 float(g["n_generated"]))
        n.update(K.MODE_LAUNCHES)
        log(f"    launches {K_other()}")
        hist = hist.cpu().numpy().reshape(-1)
        gen, hits = float(tot[K.CNT_GEN]), float(tot[K.CNT_HITS])
        l1_g = float(np.abs(hist - g["hist"].ravel()).sum()
                     / g["hist"].sum())
        ref, what = g, "golden"
        if name == "config2_muon_spice" and not G.REFERENCE_ICE.is_dir():
            ref, wall = timed(lambda: G._run_threefry(sim, batches))
            what = "engine"
            log(f"    no spice_lea: the port's engine on the card in the "
                f"same stream and ice, {wall:.2f} s, is the reference")
        l1 = float(np.abs(hist - ref["hist"].ravel()).sum()
                   / ref["hist"].sum())
        log(f"  {name}: generated {gen:.0f} / {float(g['n_generated']):.0f}"
            f" (kernel / golden), hits {hits:.0f} / "
            f"{float(ref['n_hits']):.0f} (kernel / {what}); histogram L1 "
            f"{l1:.6g} of the {what}'s total (held <= {L1_TOL}; "
            f"compare_to_golden's bound 1e-3); L1 to the golden {l1_g:.6g}")
        if gen != float(g["n_generated"]):
            raise AssertionError(f"{name}: n_generated differs from the "
                                 "golden's")
        if abs(hits - float(ref["n_hits"])) > max(2.0, 0.01 *
                                                  float(ref["n_hits"])):
            raise AssertionError(f"{name}: hits differ from the {what}'s")
        if l1 > L1_TOL:
            raise AssertionError(f"{name}: histogram L1 {l1} > {L1_TOL}")
    return n


def phase13c(device):
    """The fit workload with the hole-ice polynomial (HOLE_ICE_H2_50CM, 11
    coefficients) in the expected estimator and threefry: the kernel
    against its plain version (phase 2's tolerances), then IceFit's gates
    through fit_gates with one Adam step (its launches counted)."""
    from clsim_tpu_torch.hits.acceptance import HOLE_ICE_H2_50CM
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps = fit_workload(device)
    poly = tuple(float(c) for c in HOLE_ICE_H2_50CM["coefficients"])
    cfg = dataclasses.replace(cfg, expected_angular_poly=poly)
    key = rng.as_key(FIT_KEY)
    run_k, spec, tables = kernel_run(medium, geo, spectra, cfg, steps, FIT_T,
                                     key=key)
    run_p, _, _ = kernel_run(medium, geo, spectra, cfg, steps, FIT_T,
                             key=key, plain=True)
    run_k()
    (_, h_k, c_k), ms_k = cuda_ms(run_k)
    (_, h_p, c_p), ms_p = cuda_ms(run_p, reps=1)
    name = f"fit workload + hole-ice polynomial ({len(poly)} coefficients)"
    err = compare(name + ", threefry kernel / plain", c_k, h_k, c_p, h_p)
    bound = kernel_bound(spec, tables, c_k, "threefry")
    log(f"  {name}: mode {K.kernel_mode(spec)}, kernel {ms_k:.4f} ms "
        f"(median of 5), plain {ms_p:.3f} ms ({FIT_SLOTS} slots x {FIT_T} "
        f"iterations), bound {bound[0]:.4f} ms by {bound[1]}; "
        + fmt_stats(k1_stats(c_k, FIT_SLOTS, FIT_T)))
    mode = K.kernel_mode(spec)
    fit_gates(device, (medium, geo, spectra, cfg, steps), GRAD_LAYERS,
              adam_steps=1)
    n = launched([mode])
    log(f"  launches of the Adam step and the end loss: {n}")
    if n[mode] <= 0:
        raise AssertionError("the hole-ice fit did not launch the kernel")
    return dict(ms=ms_k, plain_ms=ms_p, err=err, bound=bound, mode=mode), n


def closed_scat_inputs(device):
    """Phase 2's main-path inputs with the Antares scattering angle on the
    closed-form seeded ice (the kernel's MED_CLOSED_SCAT)."""
    from clsim_tpu_torch.medium.antares import make_antares_water
    medium, geo, spectra, cfg, steps, uni = main_path_inputs(device)
    medium = medium._replace(
        scattering=make_antares_water(device=device).scattering)
    return medium, geo, spectra, cfg, steps, uni


CLOSED_SCAT = {"propagate[closed-scat]": dict(),
               "propagate[expected,closed-scat]": dict(
                   estimator="expected", soft_binning=True)}


def phase13d(device):
    """B5: the main-path ice with the Antares scattering table on the
    closed-form medium, the kernel against its plain version on phase 2's
    shared stream in detect and in expected mode (check_instantiation),
    then Simulation.simulate of phase 3's cascade in that ice in each mode
    (its launches counted)."""
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.types import PropagationConfig
    medium, geo, spectra, cfg, steps, uni = closed_scat_inputs(device)
    out, n = {}, {}
    _, cascade = main_path_sim(device)
    for name, change in CLOSED_SCAT.items():
        r = check_instantiation(name, (medium, geo, spectra,
                                       dataclasses.replace(cfg, **change),
                                       steps, uni), False)
        if r["mode"] >> K.MED_SHIFT != K.MED_CLOSED_SCAT:
            raise AssertionError(f"{name}: mode {r['mode']} is not "
                                 "MED_CLOSED_SCAT's")
        out[name] = r
        sim = Simulation(medium=medium, geometry=hex61(device),
                         config=PropagationConfig(n_slots=N_SLOTS, **change))
        photons = steps_photons(sim, cascade, 11)
        reset_counts()
        res, wall = timed(lambda: sim.simulate([cascade], seed=11))
        n.update(launched([r["mode"]]))
        log(f"  {name}: Simulation.simulate {wall:.3f} s = "
            f"{photons / wall:.6g} photons/s; launches {K_other()}")
        check_run(name + " (phase 3's cascade)", res, photons)
        if n[r["mode"]] <= 0:
            raise AssertionError(f"{name}: not launched on its path")
    return out, n


# ---------------------------------------------------------------------------
# phase 14: the call loop (repack and balance between launches, each launch
# over the live prefix) and the event pipeline (host and device overlapped)
# ---------------------------------------------------------------------------

UNEVEN_T = 256           # 14a: iterations a call of the replayed stream
UNEVEN_CALLS = 64        # 14a: calls at most
LOOP_IPC = (256, 1024, 4096)   # 14b: iterations a call
LOOP_MODES = (("off", dict(repack=False)), ("repack", dict(repack=True)),
              ("balance", dict(repack=True, balance=True)))
LOOP_REPS = 5            # 14b: simulate runs a case (medians)
PIPE_DEPTHS = (1, 4)     # 14c: the synchronous loop and the default depth
PIPE_COPIES = 4          # 14c: 8e's four events, four times
PIPE_CASCADES = 16       # 14c: the host-bound stream of phase 3's cascades


def uneven_inputs(device, n=None, T=UNEVEN_T):
    """14a's workload: phase 2's main-path configuration (hex61, the seeded
    171-layer ice) with (i * 7919) % 97 photons in slot i, so that the
    queue depths spread over 0-96, and one (T, 8, n) stream."""
    import torch
    from clsim_tpu_torch.types import PropagationConfig
    n = N_SLOTS if n is None else n
    medium, _ = seeded_ice(171, -855.0, 10.0, device)
    _, geo, spectra, _, steps = bench_workload(
        n, (np.arange(n, dtype=np.int64) * 7919) % 97, device)
    cfg = PropagationConfig(n_slots=n, pancake_factor=5.0)
    uni = torch.rand((T, 8, n), generator=torch.Generator(
        device=device).manual_seed(7), device=device)
    return medium, geo, spectra, cfg, steps, uni


def prefix_launch_check(inputs, n_active):
    """One launch over the first n_active slots (state advanced one launch
    first, so that the slots past the prefix hold photons in flight):
    the state past the prefix unchanged bit for bit, and the launch against
    its plain version with the same n_active (phase 2's tolerances, the
    main path's generated-count allowance).  Returns (kernel counters,
    plain counters)."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, uni = inputs
    n = int(steps.x.shape[0])
    spec, cell_tab = quiet(K.fused_spec, medium, geo, spectra, cfg, n,
                           int(uni.shape[0]))
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = K.pack_steps(steps)
    state0, _, _ = K.run_fused_iterations(K.init_state(steps), steps_p,
                                          tables, spec, uniforms=uni)
    state_k, h_k, c_k = K.run_fused_iterations(
        state0.clone(), steps_p, tables, spec, uniforms=uni, call_no=1,
        n_active=n_active)
    _, h_p, c_p = K.run_fused_iterations_plain(
        state0.clone(), steps_p, tables, spec, uniforms=uni, call_no=1,
        n_active=n_active)
    torch.cuda.synchronize()
    live_past = int(((state0[0, n_active:] > 0.5)
                     | (state0[1, n_active:] > 0.5)).sum())
    if not torch.equal(state_k[:, n_active:], state0[:, n_active:]):
        raise AssertionError("a launch over the live prefix changed a slot "
                             "past it")
    log(f"  launch over the first {n_active} of {n} slots: the {n - n_active}"
        f" slots past it unchanged bit for bit ({live_past} of them live); "
        f"live slot-iterations {float(c_k[K.CNT_WORK]):.0f} (at most "
        f"{n_active * spec.iters_per_call})")
    if float(c_k[K.CNT_WORK]) > n_active * spec.iters_per_call:
        raise AssertionError("the prefix launch ran slots past the prefix")
    compare(f"prefix launch ({n_active} slots)", c_k, h_k, c_p, h_p,
            gen_rtol=1e-5)
    return c_k, c_p


def repack_against_plain(name, inputs, max_calls=UNEVEN_CALLS, first=None,
                         **opts):
    """propagate_fused of `inputs` with its replayed stream
    (allow_uniform_replay) and the repack options `opts`, every launch of
    its call loop also run by the plain version from the same state, the
    same n_active and the same stream: the path's gates (generated = the
    steps' photons, abandoned 0, dropped 0, histogram sum = hit weight),
    the launches' summed counters and histograms kernel against plain
    (phase 2's tolerances, the main path's generated-count allowance: the
    plain version restarts from the kernel's state at every launch), and
    every launch over a prefix leaving the slots past it unchanged.  The
    first launch starts from the initial state whatever the options, so a
    dict `first` shared by runs of the same inputs keeps its plain result
    for the next run.  Returns (the launches [(n_active, alive after)],
    the result, max abs error)."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    medium, geo, spectra, cfg, steps, uni = inputs
    n = int(steps.x.shape[0])
    inner = K.run_fused_iterations
    acc = dict(hist=None, c_k=0.0, c_p=0.0, launches=[])

    def both(state, steps_p, tables, spec, **kw):
        before = state.clone()
        out = inner(state, steps_p, tables, spec, **kw)
        if kw["call_no"] == 0 and first is not None and first:
            acc["hist"], c_p = first["hist"].clone(), first["c"]
        else:
            _, acc["hist"], c_p = K.run_fused_iterations_plain(
                before, steps_p, tables, spec, **dict(kw, hist=acc["hist"]))
            if kw["call_no"] == 0 and first is not None:
                first.update(hist=acc["hist"].clone(), c=c_p)
        n_act = kw.get("n_active") or n
        if n_act < n and not torch.equal(out[0][:, n_act:],
                                         before[:, n_act:]):
            raise AssertionError(f"{name}: a prefix launch changed a slot "
                                 "past it")
        acc["c_k"] = acc["c_k"] + out[2]
        acc["c_p"] = acc["c_p"] + c_p
        acc["launches"].append((n_act, out[2][K.CNT_ALIVE]))
        return out

    photons = float(steps.num_photons.sum())
    K.run_fused_iterations = both
    try:
        res, tot = K.propagate_fused(
            steps, medium, geo, spectra, 5, cfg,
            iters_per_call=int(uni.shape[0]), max_calls=max_calls,
            uniforms=uni, allow_uniform_replay=True, **opts)
    finally:
        K.run_fused_iterations = inner
    launches = [(a, float(b)) for a, b in acc["launches"]]
    hsum = float(res.hist.double().sum())
    log(f"  {name}: {len(launches)} launches (n_active, alive after): "
        + ", ".join(f"({a}, {b:.0f})" for a, b in launches)
        + f"; generated {float(tot[K.CNT_GEN]):.0f} (steps' photons "
        f"{photons:.0f}), abandoned {float(tot[K.CNT_ALIVE]):.0f}, dropped "
        f"{float(tot[K.CNT_DROPPED]):.0f}, hist sum {hsum:.6g}, weight "
        f"{float(tot[K.CNT_WSUM]):.6g}")
    if float(tot[K.CNT_GEN]) != photons:
        raise AssertionError(f"{name}: generated != the steps' photons")
    if float(tot[K.CNT_ALIVE]) != 0 or float(tot[K.CNT_DROPPED]) != 0:
        raise AssertionError(f"{name}: photons abandoned or dropped")
    if abs(hsum / float(tot[K.CNT_WSUM]) - 1.0) > 1e-4:
        raise AssertionError(f"{name}: histogram sum differs from the hit "
                             "weight")
    err = compare(name + ", launches summed", acc["c_k"],
                  res.hist.reshape(-1), acc["c_p"], acc["hist"].reshape(-1),
                  gen_rtol=1e-5)
    return launches, res, err


def phase14a(device):
    """The call loop's repack against the plain version on the uneven
    workload at N_SLOTS: repack off, on, and on with balance; and one
    launch over a prefix.  Returns the largest max abs error."""
    from clsim_tpu_torch.propagate import kernel as K
    inputs = uneven_inputs(device)
    # the prefix launch on the stream's first 32 iterations (the plain
    # version's time at full width is ~12 ms an iteration)
    prefix_launch_check(inputs[:5] + (inputs[5][:32].contiguous(),),
                        N_SLOTS // 2 + 3 * K.BLOCK)
    err, runs, first = 0.0, {}, {}
    for mode, opts in LOOP_MODES:
        launches, res, e = repack_against_plain(
            f"uneven queues, repack {mode}", inputs, first=first, **opts)
        runs[mode] = (launches, res.n_iterations)
        err = max(err, e)
    if not any(a < N_SLOTS for a, _ in runs["repack"][0]):
        raise AssertionError("repack never launched over a prefix")
    log("  iterations to drain: " + ", ".join(
        f"{m} {it} ({len(ls)} launches)" for m, (ls, it) in runs.items()))
    return err


@contextlib.contextmanager
def loop_account():
    """Within the block, time each kernel launch (run_fused_iterations) and
    each repack (repack_slots, where the package has it) between CUDA
    events, keeping each launch's n_active, iterations and counters; the
    yielded dict holds, once the block has ended (one synchronize),
    'launches' [{ms, n_active, iters, alive, work, live_share, and
    repack_ms where a repack ran just before the launch}] and 'repacks'
    [ms]."""
    import torch
    from clsim_tpu_torch.propagate import kernel as K
    inner_l = K.run_fused_iterations
    inner_r = getattr(K, "repack_slots", None)
    raw, out = dict(launches=[], repacks=[]), {}

    def events():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        return e

    def launch(state, steps_p, tables, spec, **kw):
        e = events()
        r = inner_l(state, steps_p, tables, spec, **kw)
        e[1].record()
        raw["launches"].append((e, kw.get("n_active") or spec.n_slots,
                                spec.iters_per_call, r[2]))
        return r

    def repack(*a, **kw):
        e = events()
        r = inner_r(*a, **kw)
        e[1].record()
        raw["repacks"].append((e, len(raw["launches"])))
        return r

    K.run_fused_iterations = launch
    if inner_r is not None:
        K.repack_slots = repack
    try:
        yield out
    finally:
        K.run_fused_iterations = inner_l
        if inner_r is not None:
            K.repack_slots = inner_r
    torch.cuda.synchronize()
    out["launches"] = [dict(
        ms=e[0].elapsed_time(e[1]), n_active=na, iters=T,
        alive=float(c[K.CNT_ALIVE]), work=float(c[K.CNT_WORK]),
        live_share=float(c[K.CNT_WORK]) / (na * T))
        for e, na, T, c in raw["launches"]]
    out["repacks"] = [e[0].elapsed_time(e[1]) for e, _ in raw["repacks"]]
    for (e, before), ms in zip(raw["repacks"], out["repacks"]):
        if before < len(out["launches"]):
            out["launches"][before]["repack_ms"] = ms


def loop_workloads(device):
    """14b's workloads: [(name, Simulation, sources, seed)]: phase 3's
    cascade on hex61 and 8b's standard-DOM flash on ic86."""
    sim, cascade = main_path_sim(device)
    fsim = flasher_sim(device)
    return [("phase 3 cascade", sim, [cascade], 11),
            ("8b flash", fsim, flash(fsim.geometry, STD_DOM), 21)]


def loop_cases(sim, sources, seed, reps=LOOP_REPS, modes=LOOP_MODES):
    """Simulation.simulate of `sources` at each LOOP_IPC x repack mode
    (sim.fused_opts), `reps` times each: {case: {simulate, kernel_ms (the
    launches' summed ms), repack_ms (summed), walls, launches (the last
    run's, loop_account)}}, medians over the runs."""
    out = {}
    quiet(sim.simulate, sources, seed=seed)
    for ipc in LOOP_IPC:
        for mode, opts in modes:
            sim.fused_opts = dict(iters_per_call=ipc, **opts)
            walls, kms, rms = [], [], []
            for _ in range(reps):
                with loop_account() as acc:
                    res, wall = timed(lambda: quiet(sim.simulate, sources,
                                                    seed=seed))
                walls.append(wall)
                kms.append(sum(x["ms"] for x in acc["launches"]))
                rms.append(sum(acc["repacks"]))
                if res.diagnostics["abandoned"] != 0:
                    raise AssertionError(f"ipc {ipc} {mode}: abandoned")
            out[f"{ipc} {mode}"] = dict(
                simulate=float(np.median(walls)), walls=walls,
                kernel_ms=float(np.median(kms)),
                repack_ms=float(np.median(rms)), launches=acc["launches"],
                repacks=acc["repacks"],
                generated=float(res.n_generated), hits=float(res.n_hits))
    sim.fused_opts = {}
    return out


def fmt_launches14(c):
    """Each launch of a loop_account run, the repack before it beside it."""
    return ", ".join(
        (f"[repack {x['repack_ms']:.4f} ms = "
         f"{x['repack_ms'] / x['ms']:.3f} of the launch] "
         if "repack_ms" in x else "")
        + f"{x['ms']:.4f} ms ({x['n_active']} slots x {x['iters']} it, "
        f"alive after {x['alive']:.0f}, live share {x['live_share']:.4f})"
        for x in c["launches"])


def phase14b(device, card):
    """The tail, measured: 14b's workloads at each LOOP_IPC with repack
    off, on and on + balance; each launch's ms, n_active, alive after it
    and live share (live slot-iterations over n_active x iterations), each
    repack's ms, and each case's kernel ms and simulate s (medians of
    LOOP_REPS).  The kernel must launch on each path."""
    from clsim_tpu_torch.propagate import kernel as K
    for name, sim, sources, seed in loop_workloads(device):
        reset_counts()
        cases = loop_cases(sim, sources, seed)
        if sum(K.MODE_LAUNCHES.values()) <= 0:
            raise AssertionError(f"{name}: the kernel was not launched")
        gen = {c["generated"] for c in cases.values()}
        if len(gen) != 1:
            raise AssertionError(f"{name}: generated counts differ by case")
        for case, c in cases.items():
            log(f"  {name}, iters_per_call {case}: kernel {c['kernel_ms']:.4f}"
                f" ms, repacks {c['repack_ms']:.4f} ms, simulate "
                f"{c['simulate']:.4f} s (medians of {LOOP_REPS}); hits "
                f"{c['hits']:.0f}; last run's launches: " + fmt_launches14(c))
    log(f"  (14b on {card})")


def pipeline_events(device, fsim):
    """14c's streams: 8e's four events PIPE_COPIES times on the flasher
    Simulation (the k-th batch draws from SeedSequence([seed, k]) and the
    conversions from the one generator, so the copies are distinct
    events), and PIPE_CASCADES of phase 3's cascades on hex61."""
    from clsim_tpu_torch.sources.flasher_extras import standard_candle_pulses
    msim, cascade = main_path_sim(device)
    events = [[cascade], flash(fsim.geometry, STD_DOM), [],
              standard_candle_pulses(1, photons_per_pulse=SC_PHOTONS,
                                     spectrum_index=LED_INDEX[405])]
    return [("8e's events x4", fsim, events * PIPE_COPIES),
            ("phase 3 cascades", msim, [[cascade]] * PIPE_CASCADES)]


def run_pipeline(sim, events, depth, seed=13):
    """EventPipeline(sim, depth).process(events): (results, process's
    wall, RunStatistics)."""
    from clsim_tpu_torch.parallel.pipeline import EventPipeline
    pipe = EventPipeline(sim, max_in_flight=depth)
    results, wall = timed(lambda: quiet(pipe.process, events, seed=seed))
    return results, wall, pipe.stats.as_dict()


def phase14c(device, fsim, card):
    """EventPipeline at max_in_flight 1 and at the default depth on 14c's
    two streams: events/s, photons/s, DeviceUtilization (<= 1) and the
    wall split; the two runs equal in every event's generated count, hits
    and per-particle counts, histograms within L1 1e-6 of the total."""
    from clsim_tpu_torch.propagate import kernel as K
    out = {}
    for name, sim, events in pipeline_events(device, fsim):
        runs = {}
        quiet(sim.simulate, events[0] or events[1], seed=1)   # warm-up
        for depth in PIPE_DEPTHS:
            reset_counts()
            results, wall, d = run_pipeline(sim, events, depth)
            if sum(K.MODE_LAUNCHES.values()) <= 0:
                raise AssertionError(f"{name}: the kernel was not launched")
            gen = sum(r.n_generated for r in results)
            util = d["DeviceUtilization"]
            log(f"  {name}, max_in_flight {depth}: {len(events)} events in "
                f"{wall:.4f} s = {len(events) / wall:.6g} events/s, "
                f"{gen / wall:.6g} photons/s; DeviceUtilization {util:.6g} "
                f"(device spans' union {d['TotalDeviceTime'] * 1e-9:.4f} s "
                f"over process's {d['TotalHostTime'] * 1e-9:.4f} s from its "
                f"start to the last harvest; "
                f"{wall - d['TotalHostTime'] * 1e-9:.4f} s after it); "
                f"{d['NumKernelCalls']:.0f} batches, launches "
                f"{dict(K.MODE_LAUNCHES)}")
            if not 0.0 < util <= 1.0:
                raise AssertionError(f"{name}: DeviceUtilization {util}")
            if d["TotalNumHitsDropped"] or d["TotalNumPhotonsAbandoned"]:
                raise AssertionError(f"{name}: hits dropped or photons "
                                     "abandoned")
            runs[depth] = results
            out[(name, depth)] = dict(wall=wall, util=util,
                                      events_s=len(events) / wall)
        a, b = (runs[d] for d in PIPE_DEPTHS)
        worst = 0.0
        for ra, rb in zip(a, b):
            if (ra.event_id, ra.n_generated, ra.n_hits, ra.per_particle) != (
                    rb.event_id, rb.n_generated, rb.n_hits, rb.per_particle):
                raise AssertionError(f"{name}: event {ra.event_id} differs "
                                     "between the two depths")
            tot = float(np.abs(ra.hist).sum())
            l1 = float(np.abs(ra.hist.astype(np.float64)
                              - rb.hist.astype(np.float64)).sum())
            if l1 > 1e-6 * tot + 1e-9:
                raise AssertionError(f"{name}: event {ra.event_id} histogram"
                                     f" L1 {l1} of {tot}")
            worst = max(worst, l1 / tot if tot else 0.0)
        log(f"  {name}: the {len(a)} events equal at both depths (generated,"
            f" hits, per-particle counts), histogram L1 at most {worst:.3g} "
            "of the event's total")
    log(f"  (14c on {card})")
    return out


def loop_turn_worker(root):
    """One turn of --loop-turns: import the package at `root`, build its
    kernels, then run loop_cases on 14b's workloads and 7b's ic86 cascade
    (the repack modes only where the package's propagate_fused takes
    `repack`; an older checkout runs its own loop as "off"); print one
    line 'LOOP {json}'."""
    sys.path.insert(0, os.path.abspath(root))
    import inspect
    import torch
    from clsim_tpu_torch import _build
    from clsim_tpu_torch.api import Simulation
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.types import PropagationConfig
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    has_repack = "repack" in inspect.signature(K.propagate_fused).parameters
    modes = LOOP_MODES if has_repack else (("off", {}),)
    ice, _ = seeded_ice(171, -855.0, 10.0, device)
    sim86 = quiet(Simulation, medium=ice, geometry=ic86(device),
                  config=PropagationConfig(n_slots=N_SLOTS))
    work = loop_workloads(device)
    work.append(("7b ic86 cascade", sim86, work[0][2], 11))
    out = dict(root=root, repack=has_repack, build_s=build_s, cases={})
    for name, sim, sources, seed in work:
        out["cases"][name] = loop_cases(sim, sources, seed, modes=modes)
    print("LOOP " + json.dumps(out), flush=True)


def loop_turns(turns, json_path=None):
    """--loop-turns LABEL:ROOT ...: loop_turn_worker for each turn in the
    order given (parent, this, this, parent), printing each turn's cases
    (each launch on a body's first turn), then for every case each body's
    turns, its spread ((max - min) / mean of its turns) and its median."""
    def report(r, label, root, first, card):
        log(f"turn {label} ({root}), build {r['build_s']:.1f} s, repack "
            f"{r['repack']}")
        for name, cases in r["cases"].items():
            for case, c in cases.items():
                log(f"  {label} {name}, iters_per_call {case}: simulate "
                    f"{c['simulate']:.4f} s, kernel {c['kernel_ms']:.4f} ms,"
                    f" repacks {c['repack_ms']:.4f} ms"
                    + (": " + fmt_launches14(c) if first else ""))

    results = run_turns("--loop-worker", "LOOP ", turns, json_path, report)
    table = {}
    for r in results:
        for name, cases in r["cases"].items():
            for case, c in cases.items():
                row = table.setdefault((name, case), {}).setdefault(
                    r["label"], [])
                row.append((c["simulate"], c["kernel_ms"]))
    for (name, case), bodies in table.items():
        parts = []
        for label, vals in bodies.items():
            for j, unit in ((0, "s"), (1, "ms")):
                v = [x[j] for x in vals]
                spread = (max(v) - min(v)) / np.mean(v) if len(v) > 1 else 0.0
                parts.append(f"{label} {'simulate' if j == 0 else 'kernel'} "
                             + " / ".join(f"{x:.4f}" for x in v)
                             + f" {unit} (median {np.median(v):.4f}, spread "
                             f"{spread:.3f})")
        log(f"{name}, iters_per_call {case}: " + "; ".join(parts))
    return results


def mesh_only(n_ranks):
    """--mesh N: build, then phase 12b with N ranks, one a card when there
    are N cards (NCCL), else sharing them (gloo)."""
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    log(card)
    from clsim_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 1: built in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.device_count()} cards")
    log(f"phase 12b with {n_ranks} ranks")
    t0 = time.perf_counter()
    phase12b(torch.device("cuda", 0), card.replace("\n", "; "), n_ranks)
    log(f"  phase 12b with {n_ranks} ranks passed in "
        f"{time.perf_counter() - t0:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script runs only on a GPU")
    argv = sys.argv[1:]
    if argv[:1] == ["--k1-worker"]:
        return k1_turn_worker(argv[1])
    if argv[:1] == ["--tab-worker"]:
        return tab_turn_worker(argv[1])
    if argv[:1] == ["--split-worker"]:
        return host_split_worker(argv[1])
    if argv[:1] == ["--loop-worker"]:
        return loop_turn_worker(argv[1])
    if argv[:1] == ["--cell-worker"]:
        return cell_turn_worker(argv[1])
    if argv[:1] == ["--mesh-worker"]:
        return mesh_worker(int(argv[1]), int(argv[2]), int(argv[3]), argv[4])
    if argv[:1] == ["--mesh"]:
        return mesh_only(int(argv[1]))
    if argv[:1] == ["--oracle-matrix"]:
        return oracle_matrix_only()
    if argv[:1] in (["--turns"], ["--host-split"], ["--tab-turns"],
                    ["--loop-turns"], ["--cell-turns"]):
        turns = argv[1:]
        json_path = None
        if "--json" in turns:
            i = turns.index("--json")
            json_path, turns = turns[i + 1], turns[:i] + turns[i + 2:]
        {"--turns": k1_turns, "--host-split": host_split_turns,
         "--tab-turns": tab_turns, "--loop-turns": loop_turns,
         "--cell-turns": cell_turns}[argv[0]](turns, json_path)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from clsim_tpu_torch import _build
    log("phase 1: build")
    t0 = time.perf_counter()
    _build.load()
    log(f"  built {_build.BUILD_INFO['path']} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in k1_ptxas_lines(_build.BUILD_INFO["log"]):
        log("  " + line)
    for k, d in tab_ptxas(_build.BUILD_INFO["log"]).items():
        log(f"  {k}: {d}")

    res = {}
    log("phase 2: kernel against plain version")
    res["2"] = phase2(device)
    log("phase 3: main path (Simulation.simulate, hex61, 100 TeV cascade)")
    res["3"] = phase3(device)
    log("phase 4: bench workload")
    phase4(device, sweep="--sweep" in argv)
    log("phase 5a: record mode against plain version")
    res["5a"] = phase5a(device)
    log("phase 5b: SAVE_ALL with a record buffer that fills")
    phase5b(device)
    log("phase 5c: main path with records (Simulation.simulate_hits)")
    res["5c"], *hits_run = phase5c(device)
    log("phase 5d: simulate_photons -> npz -> simulate_hits_from_photons")
    phase5d(*hits_run)
    log("phase 6a: threefry stream (card / CPU bits, threefry / stream-fed "
        "kernel, kernel / plain)")
    res["6a"] = phase6a(device)
    log("phase 6b: the B6 deposit modes against their plain version")
    res["6b"] = phase6b(device)
    log("phase 6c: the ice fit (IceFit, forward='fused') at full width")
    res["6c"] = phase6c(device)
    log("phase 7a: the B3 and B7 instantiations against their plain "
        "version")
    res["7a"] = phase7a(device)
    modes = {k: v["mode"] for k, v in res["7a"].items()}
    launches7 = {}
    log("phase 7b: the full IceCube detector at its default configuration "
        "(Simulation.simulate, ic86, 100 TeV cascade)")
    launches7.update(phase7b(device, modes))
    log("phase 7c: surveyed positions with records (jittered ic86, "
        "simulate_hits)")
    launches7.update(phase7c(device, modes))
    log("phase 7d: a sea-water telescope (KM3NeT/ARCA block in Antares "
        "water)")
    launches7.update(phase7d(device, modes))
    log("phase 7e: a photonics-table ice (hex61)")
    launches7.update(phase7e(device, modes))

    t8 = time.perf_counter()

    def lap(name):
        log(f"  phase {name} done at {time.perf_counter() - t8:.1f} s into "
            "phase 8")

    log("phase 8a: flasher spectra (K1·B4) and the deposit modes on the "
        "global plans and media (K1·B3/B7 × B6/B8b) against their plain "
        "version")
    res["8a"] = phase8a(device)
    lap("8a")
    modes8 = {k: v["mode"] for k, v in res["8a"].items()}
    launches8 = collections.Counter()
    sim = flasher_sim(device)
    flash_mode = modes8["propagate[flasher,global]"]
    log("phase 8b: a standard-DOM flash on ic86 (Simulation.simulate)")
    launches8.update(phase8_flash(device, f"standard-DOM flash {STD_DOM}",
                                  sim, flash(sim.geometry, STD_DOM),
                                  flash_mode))
    lap("8b")
    log("phase 8c: a color-DOM flash on ic86, all 12 LEDs")
    launches8.update(phase8_flash(device, f"color-DOM flash {COLOR_DOM}",
                                  sim, flash(sim.geometry, COLOR_DOM,
                                             mask=0xFFF), flash_mode))
    lap("8c")
    log("phase 8d: simulate_hits of the standard-DOM flash")
    launches8.update(phase8d(device,
                             modes8["propagate[flasher,records,global]"]))
    lap("8d")
    log("phase 8e: EventPipeline (cascade, flash, empty event, Standard "
        "Candle 1) and the flasher golden")
    launches8.update(phase8e_pipeline(device, sim, flash_mode))
    launches8.update(golden_run(device, "config3_flasher"))
    lap("8e")
    log("phase 8f: the flasher ice fit on ic86 (IceFit, forward='fused')")
    res["8f"], n = phase8f(device)
    launches8.update(n)
    lap("8f")
    log("phase 8g: the deposit modes on the global plans and media through "
        "Simulation.simulate of the standard-DOM flash")
    launches8.update(phase8g(device, modes8))
    lap("8g")

    t9 = time.perf_counter()
    log("phase 9: the probe kernels (P1-P15 as H1-H4) against their plain "
        "versions, and the main-path kernel's account")
    res["9"] = phase9(device, res["2"],
                      res["8a"]["propagate[expected,global]"]["hits"])
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    t10 = time.perf_counter()
    log("phase 10a: particles to goldens through the kernel "
        "(util.golden.run_config)")
    golden_run(device, "config1_cascade")
    log("  config2_muon_spice: the photon count is held, the histogram only "
        "printed: its golden was frozen with spice_lea, which the "
        "repository does not hold (the 171-layer fallback ice runs here)")
    golden_run(device, "config2_muon_spice", hold_hist=False)
    log("phase 10b: the BASELINE matrix, the kernel (Philox) against the "
        "float64 oracle")
    t10b = time.perf_counter()
    phase10b(device)
    log(f"  phase 10b took {time.perf_counter() - t10b:.1f} s")
    log("phase 10c: a detailed-propagator cascade with a beta spread")
    phase10c(device)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()

    def lap11(name):
        log(f"  phase {name} done at {time.perf_counter() - t11:.1f} s into "
            "phase 11")

    log("phase 11a: the tabulator at full size on its kernel (65,536 slots "
        "x 32 photons, the default spherical table on the card)")
    res["11a"] = phase11a(device, card)
    lap11("11a")
    log("phase 11b: the analytic radial referee (scattering off)")
    phase11b(device)
    lap11("11b")
    log("phase 11c: the kernel's tables against the plain version's on "
        "the card and on the CPU")
    phase11c(device)
    lap11("11c")
    log("phase 11d: scatter-history rings through the engine on the card")
    phase11d(device)
    lap11("11d")

    t12 = time.perf_counter()
    log("phase 12a: the main path over a mesh of one rank on NCCL "
        "(Simulation(mesh=global_photon_mesh()), hex61, 100 TeV cascade)")
    phase12a(device, card)
    log("phase 12b: two ranks on gloo sharing the card (the main path's "
        "slot slices and one IceFit step)")
    phase12b(device, card)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    t13 = time.perf_counter()

    def lap13(name):
        log(f"  phase {name} done at {time.perf_counter() - t13:.1f} s into "
            "phase 13")

    log("phase 13a: threefry with every detect mode and with records "
        "(main-path config and ic86) against the stream-fed kernel and the "
        "plain version")
    res["13a"] = phase13a(device)
    lap13("13a")
    log("phase 13a path: phase 3's cascade through propagate_fused("
        "threefry_key=) in each mode, hex61 and ic86")
    launches13 = collections.Counter(phase13a_path(device, res["13a"]))
    lap13("13a path")
    log("phase 13b: the goldens in their own threefry stream through the "
        "kernel")
    launches13.update(phase13b(device))
    lap13("13b")
    log("phase 13c: the fit with the hole-ice angular polynomial (11 "
        "coefficients)")
    res["13c"], n = phase13c(device)
    launches13c = collections.Counter(n)
    lap13("13c")
    log("phase 13d: the closed-form ice with the Antares scattering angle "
        "(MED_CLOSED_SCAT)")
    res["13d"], n = phase13d(device)
    launches13.update(n)
    lap13("13d")
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    t14 = time.perf_counter()

    def lap14(name):
        log(f"  phase {name} done at {time.perf_counter() - t14:.1f} s into "
            "phase 14")

    log("phase 14a: the call loop's repack and balance against the plain "
        "version (uneven queues, 262,144 slots, a replayed stream)")
    phase14a(device)
    lap14("14a")
    log("phase 14b: the tail of the call loop (phase 3's cascade, 8b's "
        "flash; repack off, on, with balance)")
    phase14b(device, card)
    lap14("14b")
    log("phase 14c: EventPipeline, host and device overlapped against the "
        "synchronous loop")
    phase14c(device, sim, card)
    lap14("14c")
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    at = "clsim_tpu/propagate/kernel.py:2427"

    def entry(name, launches, err, ms, plain_ms, bound):
        # every instantiation's body is the kernel template
        return {"name": name, "route": "cuda",
                "source": "clsim_tpu_torch/csrc/propagate.cuh",
                "replaces": at, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}

    from clsim_tpu_torch.probes import REPLACES
    p2, p5, e6, t6 = res["2"], res["5a"], res["6b"], res["6a"]
    t11 = res["11a"]
    launches_e, launches_t = res["6c"]
    log(f"kernel times on {card}")
    print(json.dumps({"kernels": [
        entry("propagate", res["3"], p2["err"], p2["ms"], p2["plain_ms"],
              p2["bound"]),
        entry("propagate[records]", res["5c"], p5["err"], p5["ms"],
              p5["plain_ms"], p5["bound"]),
        entry("propagate[expected]", launches_e, e6["err"], e6["ms"],
              e6["plain_ms"], e6["bound"]),
        entry("propagate[threefry]", launches_t, t6["err"], t6["ms"],
              t6["plain_ms"], t6["bound"])]
        + [entry(name, launches7[r["mode"]], r["err"], r["ms"],
                 r["plain_ms"], r["bound"])
           for name, r in res["7a"].items() if r["mode"] in launches7]
        + [entry(name, launches8[r["mode"]], r["err"], r["ms"],
                 r["plain_ms"], r["bound"])
           for name, r in list(res["8a"].items())
           + [("propagate[threefry,global]", res["8f"])]
           if name in PATH8]
        + [{"name": f"probe[{k}]", "route": "cuda",
            "source": "clsim_tpu_torch/csrc/probes.cu",
            "replaces": REPLACES[k], "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
           for k, r in res["9"].items()]
        + [{"name": "tabulate", "route": "cuda",
            "source": "clsim_tpu_torch/csrc/tabulate.cu",
            "replaces": TAB_REPLACES, "launches": t11["launches"],
            "max_abs_err": t11["err"], "ms": t11["ms"],
            "plain_ms": t11["plain_ms"], "bound_ms": t11["bound"][0],
            "bound_by": t11["bound"][1], "library_ms": None}]
        + [entry(name, launches13[r["mode"]], r["err"], r["ms"],
                 r["plain_ms"], r["bound"])
           for name, r in list(res["13a"].items())
           + list(res["13d"].items())]
        + [entry("propagate[threefry,hole-ice]",
                 launches13c[res["13c"]["mode"]], res["13c"]["err"],
                 res["13c"]["ms"], res["13c"]["plain_ms"],
                 res["13c"]["bound"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
