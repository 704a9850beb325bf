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

Spans and counters of the program's own work (the event pipeline, the call
loop) are kept here too, in one process-wide Recorder, RECORDER:
`span(name, event=, batch=)` is a context manager that records a name, a
start and an end, the thread, the enclosing span on that thread (its
parent, whose identifiers it inherits) and the identifiers: the event's id
and the pipeline's batch index; `wait(site)` is the span of a host read of
a device value (a sync on CUDA) and counts it under "waits"; `count(name,
n, event=)` adds to a counter. While recording is off (the default), `span`
and `wait` return the shared NO_SPAN after one flag test and `count`
returns at once. Recording is on inside `recording()`, which `trace()`
enters, and inside `follow_profiler()`, which EventPipeline.process enters:
on while a torch.profiler runs on the calling thread, so that a profiled
window gets the spans of every thread the pipeline starts (torch.profiler
sees no operator of a thread started inside it). Spans are stamped in epoch
nanoseconds, the clock torch.profiler stamps its events with (its
trace_start_ns() plus an event's microsecond offset), so spans and kernels
of one profiled run compare directly.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

_ON = False          # recording; tested once at every span, wait and count
_CARRY = False       # the last follow_profiler session ended under a profiler


class _NoSpan:
    """The span handed out while recording is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, event=None, batch=None):
        pass


NO_SPAN = _NoSpan()


def _epoch_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a few
    brackets of perf_counter_ns around time_ns."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _launch_total() -> int:
    """Kernel launches so far: propagate.kernel.MODE_LAUNCHES, the port's
    one launch counter."""
    from ..propagate.kernel import MODE_LAUNCHES
    return sum(MODE_LAUNCHES.values())


class _Thread(threading.local):
    """A thread's open spans and its name and native id."""

    def __init__(self):
        self.stack = []
        self.name = threading.current_thread().name
        self.tid = threading.get_native_id()


class _Span:
    """An open span; on exit its record, a flat tuple of strings, ints and
    None (name, id, parent, start, end, thread name, native id, event,
    batch, site), which the garbage collector stops tracking."""
    __slots__ = ("rec", "gen", "name", "event", "batch", "site", "id",
                 "parent", "start")

    def __init__(self, rec: "Recorder", name: str, event, batch, site):
        self.rec, self.gen = rec, rec.generation
        self.name, self.event, self.batch, self.site = (name, event, batch,
                                                        site)

    def __enter__(self):
        stack = self.rec._thread.stack
        up = stack[-1] if stack and stack[-1].gen == self.gen else None
        self.parent = None
        if up is not None:
            self.parent = up.id
            if self.event is None:
                self.event = up.event
            if self.batch is None:
                self.batch = up.batch
            if self.site is None:
                self.site = up.site
        self.id = next(self.rec._ids)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def set(self, event=None, batch=None):
        """Add identifiers known only inside the span (a queue's item)."""
        if event is not None:
            self.event = event
        if batch is not None:
            self.batch = batch

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        th = rec._thread
        th.stack.pop()
        if rec.generation == self.gen:
            rec._spans.append((self.name, self.id, self.parent, self.start,
                               end, th.name, th.tid, self.event, self.batch,
                               self.site))
        return False


class Recorder:
    """The spans and counters of one recording session, in memory; read
    them back with spans() and counters().  A session starts cleared."""

    def __init__(self):
        self._thread = _Thread()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.generation = 0
        self.clear()

    def clear(self):
        self.generation += 1
        self._spans: List[tuple] = []
        self._counts: Dict[tuple, float] = {}
        self.launches = 0
        self.offset_ns = _epoch_offset_ns()

    def _add(self, key: tuple, n):
        """Add n to the counter key = (name, ((id, value), ...))"""
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """The finished spans (all, or those called `name`) as dicts: name,
        id, parent (the enclosing span's id or None), start_ns and end_ns
        (epoch nanoseconds), thread (its name), tid (its native id) and
        the identifiers."""
        off = self.offset_ns
        out = []
        for n, i, up, t0, t1, th, tid, ev, k, site in self._spans:
            if name is not None and n != name:
                continue
            d = dict(name=n, id=i, parent=up, start_ns=t0 + off,
                     end_ns=t1 + off, thread=th, tid=tid)
            for key, v in (("event", ev), ("batch", k), ("site", site)):
                if v is not None:
                    d[key] = v
            out.append(d)
        return out

    def counters(self) -> List[dict]:
        """Each counter as a dict: name, n and its identifiers; "launches"
        is the kernel launches (kernel.MODE_LAUNCHES) while recording."""
        out = [dict(ids, name=name, n=n)
               for (name, ids), n in self._counts.items()]
        return out + [dict(name="launches", n=self.launches)]

    def total(self, name: str, **match) -> float:
        """The sum of the counters called `name` whose identifiers include
        `match`."""
        return sum(c["n"] for c in self.counters() if c["name"] == name
                   and all(c.get(k) == v for k, v in match.items()))


RECORDER = Recorder()


def span(name: str, event=None, batch=None):
    """A span named `name` with the identifiers given (the event's id, the
    pipeline's batch index) and the enclosing span's while recording is
    on; the shared NO_SPAN otherwise."""
    if not _ON:
        return NO_SPAN
    return _Span(RECORDER, name, event, batch, None)


def wait(site: str, n: int = 1):
    """The span of a host read of a device value at `site` (a sync on
    CUDA tensors), named "wait", and `n` reads added to the "waits"
    counter of that site."""
    if not _ON:
        return NO_SPAN
    RECORDER._add(("waits", (("site", site),)), n)
    return _Span(RECORDER, "wait", None, None, site)


def count(name: str, n=1, event=None):
    """Add n to the counter `name` (of the event `event`, if given) while
    recording is on."""
    if _ON:
        RECORDER._add((name, () if event is None else (("event", event),)),
                      n)


def recording_on() -> bool:
    """Whether spans and counters are being recorded."""
    return _ON


def _start(clear: bool):
    global _ON
    if clear:
        RECORDER.clear()
    RECORDER._launch0 = _launch_total()
    _ON = True


def _stop():
    global _ON
    _ON = False
    RECORDER.launches += _launch_total() - RECORDER._launch0


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, from a cleared recorder;
    yields RECORDER, which keeps them after the block."""
    global _CARRY
    _start(clear=True)
    try:
        yield RECORDER
    finally:
        _stop()
        _CARRY = False


@contextlib.contextmanager
def follow_profiler():
    """Record inside the block if a torch.profiler runs on the calling
    thread and nothing records yet (checked once, on entry).  Blocks under
    one profiler session add to one recording: the recorder is cleared
    when such a block begins after one that ended with no profiler running,
    or after recording(), and kept otherwise; a block with no profiler
    records nothing and keeps what was recorded.  torch exposes no identity
    of a profiler session, so two sessions with no such block between them
    are not told apart: the second adds to the first's recording unless
    the caller clears it (RECORDER.clear()) in between."""
    global _CARRY
    if _ON or not torch.autograd._profiler_enabled():
        if not _ON:
            _CARRY = False
        yield
        return
    _start(clear=not _CARRY)
    try:
        yield
    finally:
        _stop()
        _CARRY = torch.autograd._profiler_enabled()


def _chrome_span_events(spans: List[dict], base_ns: int = 0) -> List[dict]:
    """The spans as Chrome trace events: one "X" event each (ts and dur in
    microseconds after base_ns, the trace's baseTimeNanoseconds), on a
    track of their own per thread, named by thread_name metadata."""
    pid = os.getpid()
    tracks = {}
    out = []
    for s in spans:
        tid = tracks.setdefault(s["tid"], (
            f"spans {s['thread']}", 1_000_000_000 + len(tracks)))[1]
        args = {k: v for k, v in s.items() if k not in (
            "name", "start_ns", "end_ns", "thread", "tid")}
        out.append(dict(ph="X", cat="clsim_span", name=s["name"], pid=pid,
                        tid=tid, ts=(s["start_ns"] - base_ns) / 1e3,
                        dur=(s["end_ns"] - s["start_ns"]) / 1e3, args=args))
    out += [dict(ph="M", name="thread_name", pid=pid, tid=tid,
                 args=dict(name=label)) for label, tid in tracks.values()]
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around the block, with CPU and (where a CUDA device
    exists) CUDA activities, and the program's spans recorded
    (recording()); writes a Chrome trace to logdir/trace.json (view it in
    chrome://tracing or Perfetto) with the spans beside the kernels, and
    yields the profiler, whose events() and key_averages() the caller may
    read after the block (RECORDER keeps the spans)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with recording() as rec, profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_span_events(
        rec.spans(), int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)


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
