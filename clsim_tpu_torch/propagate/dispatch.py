"""Backend dispatch: the CUDA propagation kernel for CUDA tensors, the torch
engine for CPU tensors (PyTorch counterpart of clsim_tpu.propagate.dispatch).

On a CUDA device, "auto" takes the kernel when the configuration is
supported and otherwise raises with the reason: a GPU run never quietly
drops to the engine.  The kernel serves every configuration the JAX
kernel serves: every collision plan and medium (the closed-form ice with
the Liu/HG mixture or a tabulated scattering angle, tabulated media) with
every deposit mode (stopping and non-stopping detect, the fixed
absorption horizon, the expected estimator with an angular polynomial of
any length), each with Philox, an external stream or in-kernel threefry,
photon records with stopping detect, and flasher steps over stacked
spectra with a uniform or non-uniform bias grid.  What it refuses
(backend_reason): scatter-history rings, records with another deposit
mode and a one-point bias grid (as the JAX package does), and the
kernel's static limits on SubPlans, test rounds, DOM candidates and tilt
distances (register arrays of its collision loops), which no geometry or
ice the repository builds reaches.

One rule sends a CUDA run to the engine on the card: scatter-history rings
(save_photons with photon_history_entries > 0).  They ride on the engine
only, in the JAX package too, whose kernel refuses them
(clsim_tpu/propagate/kernel.py:1833), so "auto" runs a ring configuration
through the engine on the tensors' device.  Without save_photons there are
no rings and photon_history_entries is ignored, so the kernel serves the
run.  Every other configuration the kernel refuses still raises there.
backend="engine" asks for the engine explicitly; backend="fused" runs the
fused call loop on any device (on CPU tensors the wrapper runs the
kernel's plain version).
"""

from __future__ import annotations

from typing import Optional

from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops.spectrum import SpectrumTable
from ..types import PropagationConfig, StepBatch
from .engine import PropagationResult, propagate
from .kernel import (fused_spec, fused_supported, propagate_fused,
                     spec_unsupported)


def backend_reason(medium: MediumProperties, spectra: SpectrumTable,
                   cfg: PropagationConfig, geo: DetectorGeometry,
                   n_slots: int) -> Optional[str]:
    """None if the CUDA kernel will serve this request, else why not: the
    configuration checks of fused_supported, then the kernel's own gate
    (spec_unsupported) on the plan and tables this request builds."""
    reason = fused_supported(medium, spectra, cfg)
    if reason:
        return reason
    spec, _ = fused_spec(medium, geo, spectra, cfg, n_slots, 1)
    return spec_unsupported(spec)


# Iterations per kernel launch.  A drained thread leaves its loop, so a long
# launch costs nothing once its slot is empty; between launches the host
# reads the alive count (a sync).  On the bench workload (262,144 slots x 200
# photons, H100 80GB HBM3 at 700 W) 256, 1024, 4096 and 16384 gave 1.01-1.04,
# 0.98-1.01, 1.09-1.11 and 1.09-1.10 e9 photons/s (two runs each, PERF.md):
# one launch that covers a slot's whole workload is best.  With the call
# loop's repack between launches (each launch after one over the live
# prefix), chip_smoke.py --loop-turns on the H100 at 700 W found no choice
# faster on all three of phase 3's cascade, 8b's flash and 7b's ic86
# cascade by more than the turns' spread: kernel medians at 256 / 4096
# iterations 10.57 / 10.69 ms, 103.95 / 104.89 ms (balance, off by
# default, 98.02 at 256) and 11.96 / 12.11 ms (spread up to 2.9%), and
# simulate's walls within their 1-37% spread (PERF.md).
#
# Record mode (config.save_photons) takes the same 4096 iterations per
# launch, and kernel.REC_CAPACITY (2**21 records, 185 MB) as the record
# buffer of each launch, cut to the run's photon count: a launch whose
# buffer fills stalls the threads that have a record left and is followed
# by another launch, so the capacity trades memory against launches and
# never loses a record.  The main path's 100 TeV cascade (1.8e7 photons on
# hex61) makes 21,191 hit records (H100 80GB HBM3), one launch with room to
# spare; SAVE_ALL at prescale 1 records every photon and takes about one
# launch per 2**21 of them.
ITERS_PER_CALL = 4096


def check_diagnostics(res: PropagationResult, raise_on_loss: bool = False):
    """Validate a fused run's counters (syncs): warn -- or raise -- when
    photons were abandoned (max_calls exhausted before the workload drained)
    or hits dropped.  Returns the diagnostics dict (None on the engine
    path, which can neither drop nor abandon)."""
    diag = res.diagnostics
    if diag is None:
        return None
    problems = []
    if diag["dropped"] > 0:
        problems.append(f"{diag['dropped']:.0f} hits dropped")
    if diag["abandoned"] > 0:
        problems.append(f"{diag['abandoned']:.0f} photons abandoned "
                        "(max_calls exhausted before draining)")
    if problems:
        msg = "fused propagation lost data: " + "; ".join(problems)
        if raise_on_loss:
            raise RuntimeError(msg)
        import warnings
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return diag


def propagate_auto(steps: StepBatch, medium: MediumProperties,
                   geo: DetectorGeometry, spectra: SpectrumTable,
                   seed: int, cfg: PropagationConfig,
                   backend: str = "auto",
                   **fused_opts) -> PropagationResult:
    """propagate() with backend selection by the tensors' device: "auto"
    runs the engine on CPU tensors and for scatter-history rings, and the
    kernel otherwise.

    `backend`: "auto", "engine", or "fused".  Extra kwargs go to
    propagate_fused."""
    if backend not in ("auto", "engine", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    # engine only, on any device; rings exist only in records
    rings = cfg.save_photons and cfg.photon_history_entries > 0
    if backend == "engine" or (backend == "auto" and (
            steps.x.device.type == "cpu" or rings)):
        return propagate(steps, medium, geo, spectra, seed, cfg)
    fused_opts.setdefault("iters_per_call", ITERS_PER_CALL)
    res, _ = propagate_fused(steps, medium, geo, spectra, seed, cfg,
                             **fused_opts)
    return res
