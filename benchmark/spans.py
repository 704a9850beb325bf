"""The program's own spans and counters of a traced window, for the readers
under metrics/ that read them.

EventPipeline.process records spans and counters while a torch.profiler
runs on its calling thread (clsim_tpu_torch.util.profiling.RECORDER keeps
them until the next recording starts), so the harness's `--trace 1` window,
and only it, leaves them behind.  A program older than its spans has no
RECORDER: `recorded()` is then None and every reader returns None.

Spans (name: thread, where): event (feeder, one per event: conversion,
assignment, its batches' copies and hand-over), convert and assign (under
event), queue_wait (harvester, waiting for the feeder's next batch), batch
(harvester, one per slot batch: propagate_auto, read-back), plan and
repack (the call loop, under batch), wait (a host read of a device value,
with its site).  Counters: photons (per event), waits (per site), launches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def recorded() -> Optional[Tuple[List[dict], List[dict]]]:
    """(spans, counters) of the program's recorder, or None where the
    program keeps none."""
    try:
        from clsim_tpu_torch.util import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None:
        return None
    return rec.spans(), rec.counters()


def seconds(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-9


def total_s(spans: List[dict], name: str) -> float:
    return sum(seconds(s) for s in spans if s["name"] == name)


def has(spans: List[dict], name: str) -> bool:
    return any(s["name"] == name for s in spans)


def batches(spans: List[dict]) -> int:
    return sum(1 for s in spans if s["name"] == "batch")


def counted(counters: List[dict], name: str) -> float:
    return sum(c["n"] for c in counters if c["name"] == name)


def per_photon_ns(rec, name: str) -> Optional[float]:
    """The summed seconds of the `name` spans over the photons counted, in
    nanoseconds a photon; None without such spans or photons."""
    if rec is None:
        return None
    spans, counters = rec
    photons = counted(counters, "photons")
    if not has(spans, name) or photons <= 0:
        return None
    return total_s(spans, name) / photons * 1e9


def per_batch_ms(rec, name: str) -> Optional[float]:
    """The summed seconds of the `name` spans over the batch spans, in
    milliseconds a batch; None without batches or such spans."""
    if rec is None:
        return None
    spans, _ = rec
    n = batches(spans)
    if not n or not has(spans, name):
        return None
    return total_s(spans, name) / n * 1e3


def outer_waits_s(spans: List[dict]) -> float:
    """The summed seconds of the wait spans under a batch span that no
    other wait span encloses."""
    by_id = {s["id"]: s for s in spans}
    total = 0.0
    for s in spans:
        if s["name"] != "wait":
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] not in ("wait", "batch"):
            up = by_id.get(up["parent"])
        if up is not None and up["name"] == "batch":
            total += seconds(s)
    return total
