"""The device's timeline from torch.profiler: busy time as the union of
the CUDA kernel and memory-copy intervals, the operations that took most
device time, and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

from typing import List, Sequence, Tuple

TOP = 10


def profiler(on_card: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals_us) -> float:
    return sum(e - s for s, e in union(intervals_us)) * 1e-6


def idle_share(busy_s: float, window_s: float) -> float:
    """1 - busy / window, in percent."""
    return 100.0 * (1.0 - busy_s / window_s)


def gaps(merged, window_us: float):
    """(start, end) of each idle stretch of [0, window_us] between the
    merged busy intervals."""
    out, t = [], 0.0
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window_us > t:
        out.append((t, window_us))
    return out


def name_gap(gap, host_events) -> str:
    """The host operation that overlaps the gap most, or 'host'."""
    best, name = 0.0, "host (no profiled operation)"
    for s, e, n in host_events:
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > best:
            best, name = ov, n
    return name


def summarize(prof, window_s: float) -> dict:
    """busy_s, the device operations (kernels and copies) by summed
    seconds, the longest idle gaps, each kernel's summed seconds and the
    number of kernel launches."""
    import torch
    dev, host = [], []
    for e in prof.events():
        rng = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((rng.start, rng.end, e.name))
        else:
            host.append((rng.start, rng.end, e.name))
    merged = union([(s, e) for s, e, _ in dev])
    busy = busy_seconds(merged)
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    launches = sum(1 for _, _, n in dev
                   if not n.startswith(("Memcpy", "Memset")))
    if merged:
        t0 = min(s for s, _ in merged + [(h[0], h[1]) for h in host])
    else:
        t0 = min((h[0] for h in host), default=0.0)
    shifted = [(s - t0, e - t0) for s, e in merged]
    host_shifted = [(s - t0, e - t0, n) for s, e, n in host]
    idle = sorted(gaps(shifted, window_s * 1e6),
                  key=lambda g: g[0] - g[1])[:TOP]
    return dict(
        busy_s=busy,
        kernel_s=by_name,
        launches=launches,
        device_ops=[[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[name_gap(g, host_shifted)[:160], (g[1] - g[0]) * 1e-6]
                   for g in idle])
