"""Device-time measurement helpers.

PyTorch counterpart of clsim_tpu.util.profiling.  The pipeline's
completion-gap estimate (parallel/pipeline.py) equals device time only when
the launch queue is saturated.  This module provides the cross-check: a
torch.profiler trace around a call (CPU and CUDA activities, written as a
Chrome trace), and a timing of back-to-back calls between CUDA events.

Both need the card unless the caller asks for the CPU: `trace` records
only CPU activity where no CUDA device exists, and
profile_device_time(device="cpu") times wall clock and says so in its
result ("clock": "wall" instead of "cuda_events").
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around the block, with CPU and (where a CUDA device
    exists) CUDA activities; writes a Chrome trace to logdir/trace.json
    (view it in chrome://tracing or Perfetto) and yields the profiler,
    whose events() and key_averages() the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def profile_device_time(fn: Callable[[], object], reps: int = 5,
                        warmup: int = 1, device="cuda") -> dict:
    """Time a call on the card: `warmup` calls, then one call timed alone
    (first_call_s, wall clock ending in torch.cuda.synchronize()), then
    reps - 1 calls back to back between two CUDA events, ending in
    torch.cuda.synchronize(): device_time_s is their event span divided by
    reps - 1 (the CL_PROFILING_COMMAND_START/END role,
    I3CLSimStepToPhotonConverterOpenCL.cxx:1092-1135).  With reps == 1 it
    is the first call's event span.  The span equals device time only when
    fn leaves the queue saturated (queue_saturated = reps > 1, as in the
    JAX package): a fn that syncs the host inside leaves gaps in it.

    device="cpu" times wall clock with time.perf_counter instead and
    reports "clock": "wall"; otherwise a CUDA device is required."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("profile_device_time needs a CUDA device; pass "
                           "device='cpu' to time wall clock")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    e0 = event() if cuda else None
    fn()
    e1 = event() if cuda else None
    sync()
    first = time.perf_counter() - t0
    first_dev = e0.elapsed_time(e1) * 1e-3 if cuda else first
    if reps > 1:
        t1 = time.perf_counter()
        e2 = event() if cuda else None
        for _ in range(reps - 1):
            fn()
        e3 = event() if cuda else None
        sync()
        span = (e2.elapsed_time(e3) * 1e-3 if cuda
                else time.perf_counter() - t1)
        per_call = span / (reps - 1)
    else:
        per_call = first_dev
    return {
        "device_time_s": per_call,
        "first_call_s": first,
        "queue_saturated": reps > 1,
        "clock": "cuda_events" if cuda else "wall",
    }
