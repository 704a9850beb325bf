"""Where the card's idle time goes in a stream cell of the benchmark, by the
program's own spans (clsim_tpu_torch.util.profiling), and what recording
them costs.

    python scripts/torch_idle_split.py <cell> [<cell> ...] [--seed N]
        [--cost-runs R] [--json PATH]

For each cell of BENCHMARK.json (a stream cell: benchmark/drivers/stream.py)
it builds the cell and warms it up as the benchmark does, then:

1. runs one call under util/profiling.trace(), which records the spans and
   the profiler's CUDA activity on one clock, and prints
   * the card's idle time in the call (the call's wall less the union of
     the CUDA kernel and copy intervals), split by the harvester thread's
     innermost span at each idle instant (queue_wait, plan, repack, each
     wait by site, each span's self time) and, apart, by the feeder's;
   * the share of the call that the harvester's root spans (batch,
     queue_wait) and the feeder's event spans cover;
   * the wait sites with their reads a batch, the batches and launches,
     the spans a batch;
   * the clock check: every propagate_kernel interval against the batch
     span that launched it (the kernel must start after the span starts)
     and against the alive read that follows its launch (the read must end
     after the kernel ends);
2. times the recorder's own cost on the host: nanoseconds a span and a
   wait span with recording on, and a span with recording off (the flag
   test), over 200,000 of each with the garbage collector running;
3. with --cost-runs R > 0, times R windows of 20 s with recording off and
   R with recording on (util/profiling.recording(), no profiler), in turns
   off, on, on, off, ..., as photons a second (the benchmark's
   photons_per_s).

It needs a CUDA device (the benchmark has no CPU path); run it on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.trace import gaps, union  # noqa: E402

HARVESTER = "EventPipeline-harvester"


def build(cell: str, seed: int, device: str, spec=None, roots=()):
    """The cell's stream driver, set up (world, pipeline, warm-up)."""
    from benchmark import harness
    spec = spec or harness.load_spec()
    w = harness.cell_of(spec, cell)
    roots = [*roots, harness.HERE]
    conf = json.loads(harness.find("configs", w["config"], ".json",
                                   roots).read_text())
    tr = json.loads(harness.find("traffic", w["traffic"], ".json",
                                 roots).read_text())
    ctx = harness.Context(cell=w, config=conf, traffic=tr, seed=seed,
                          device=device, roots=roots)
    d = harness.load_module("drivers", tr["driver"], roots).Driver(ctx)
    d.set_up()
    return d


def clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def idle_intervals(busy, lo, hi):
    """The idle stretches of [lo, hi] between the busy intervals."""
    merged = union([(s - lo, e - lo) for s, e in clip(busy, lo, hi)])
    return [(s + lo, e + lo) for s, e in gaps(merged, hi - lo)]


def label(s: dict) -> str:
    return f"wait:{s['site']}" if s["name"] == "wait" else s["name"]


def innermost(spans):
    """[(start, end, path)] of one thread's properly nested spans: each
    instant under the innermost span, path the names from the root
    ('batch/plan/wait:to_numpy')."""
    kids = defaultdict(list)
    ids = {s["id"] for s in spans}
    roots = []
    for s in spans:
        (kids[s["parent"]] if s["parent"] in ids else roots).append(s)
    out = []

    def walk(s, path):
        p = f"{path}/{label(s)}" if path else label(s)
        t = s["start_ns"]
        for c in sorted(kids[s["id"]], key=lambda c: c["start_ns"]):
            if c["start_ns"] > t:
                out.append((t, c["start_ns"], p))
            walk(c, p)
            t = max(t, c["end_ns"])
        if s["end_ns"] > t:
            out.append((t, s["end_ns"], p))

    for r in roots:
        walk(r, "")
    return out


def split(idle, segments):
    """Seconds of the idle intervals under each segment's path ('(none)'
    where no span of the thread is open)."""
    by = defaultdict(float)
    covered = 0.0
    for a, b in idle:
        for s, e, p in segments:
            ov = min(b, e) - max(a, s)
            if ov > 0:
                by[p] += ov * 1e-9
                covered += ov * 1e-9
    total = sum(b - a for a, b in idle) * 1e-9
    by["(none)"] += total - covered
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def traced_call(d, logdir: Path) -> dict:
    import torch
    from clsim_tpu_torch.util import profiling as P
    with P.trace(str(logdir)) as prof:
        w0 = time.perf_counter_ns()
        d.call(0)
        torch.cuda.synchronize()
        w1 = time.perf_counter_ns()
    rec = P.RECORDER
    lo, hi = w0 + rec.offset_ns, w1 + rec.offset_ns
    base = prof.profiler.kineto_results.trace_start_ns()
    dev, kernels = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            iv = (base + e.time_range.start * 1e3,
                  base + e.time_range.end * 1e3)
            dev.append(iv)
            if "propagate_kernel" in e.name:
                kernels.append(iv)
    idle = idle_intervals(dev, lo, hi)
    spans = rec.spans()
    harv = [s for s in spans if s["thread"] == HARVESTER]
    feed = [s for s in spans if s["thread"] != HARVESTER]
    batches = sorted((s for s in harv if s["name"] == "batch"),
                     key=lambda s: s["start_ns"])
    window = (hi - lo) * 1e-9
    idle_s = sum(b - a for a, b in idle) * 1e-9

    def cover(ss, names):
        iv = union([(s["start_ns"], s["end_ns"]) for s in ss
                    if s["name"] in names and s["parent"] is None])
        return sum(e - s for s, e in clip(iv, lo, hi)) * 1e-9 / window

    # the clock: kernels in launch order against the alive reads in order
    by_id = {s["id"]: s for s in spans}
    alive = sorted((s for s in harv if s["name"] == "wait"
                    and s["site"] == "alive"), key=lambda s: s["start_ns"])
    kernels.sort()
    start_viol = end_viol = float("-inf")
    if len(alive) == len(kernels):
        for (ks, ke), w in zip(kernels, alive):
            b = w
            while b["parent"] is not None:
                b = by_id[b["parent"]]
            start_viol = max(start_viol, (b["start_ns"] - ks) * 1e-3)
            end_viol = max(end_viol, (ke - w["end_ns"]) * 1e-3)
    n = len(batches)
    sites = defaultdict(float)
    for c in rec.counters():
        if c["name"] == "waits":
            sites[c["site"]] += c["n"]
    durs = defaultdict(float)
    for s in spans:
        durs[label(s)] += (s["end_ns"] - s["start_ns"]) * 1e-9
    return dict(
        window_s=window, busy_s=window - idle_s, idle_s=idle_s,
        idle_share=100.0 * idle_s / window, batches=n,
        launches=rec.total("launches"), kernels=len(kernels),
        spans_per_batch=len(spans) / n if n else None,
        alive_reads=len(alive), photons=rec.total("photons"),
        idle_ms_per_batch=idle_s / n * 1e3 if n else None,
        idle_by_harvester=split(idle, innermost(harv)),
        idle_by_feeder=split(idle, innermost(feed)),
        harvester_root_cover=cover(harv, ("batch", "queue_wait")),
        feeder_event_cover=cover(feed, ("event",)),
        span_s=dict(sorted(durs.items(), key=lambda kv: -kv[1])),
        waits_per_batch={k: v / n for k, v in sorted(
            sites.items(), key=lambda kv: -kv[1])} if n else {},
        kernel_starts_before_batch_us=start_viol,
        kernel_ends_after_alive_read_us=end_viol)


COST_SECONDS = 20.0


def span_ns(n: int = 200_000) -> dict:
    """The recorder's host cost: nanoseconds a `span` and a `wait` with
    recording on, and a `span` with it off, each the best of 3 loops of n,
    the garbage collector running."""
    from clsim_tpu_torch.util import profiling as P

    def loop(make):
        best = None
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with make():
                    pass
            dt = (time.perf_counter_ns() - t0) / n
            best = dt if best is None else min(best, dt)
        return best

    off = loop(lambda: P.span("x", event=1))
    with P.recording():
        with P.span("outer", event=1, batch=2):
            on = loop(lambda: P.span("x"))
            on_wait = loop(lambda: P.wait("site"))
    return dict(span_off_ns=off, span_on_ns=on, wait_on_ns=on_wait)


def cost(d, runs: int) -> dict:
    """photons a second over windows of COST_SECONDS, `runs` with recording
    off and `runs` on (under recording()), in turns off, on, on, off, ..."""
    import contextlib
    import torch
    from clsim_tpu_torch.util import profiling as P
    modes = {"off": contextlib.nullcontext, "on": P.recording}
    names = list(modes)
    out = {k: [] for k in names}
    for r in range(runs):
        for mode in (names if r % 2 == 0 else names[::-1]):
            ph0 = d.photons
            t0 = time.perf_counter()
            calls = 0
            while True:
                with modes[mode]():
                    d.call(calls)
                calls += 1
                if time.perf_counter() - t0 >= COST_SECONDS:
                    break
            torch.cuda.synchronize()
            out[mode].append((d.photons - ph0) / (time.perf_counter() - t0))
            print(f"  cost {mode}: {out[mode][-1]:.6e} photons/s "
                  f"({calls} calls)", flush=True)
    return {k: dict(runs=v, median=statistics.median(v))
            for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--cost-runs", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--logdir", default=str(ROOT / "build" / "trace"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    report = dict(device=torch.cuda.get_device_name(0), host=span_ns())
    print(json.dumps(report), flush=True)
    for i, cell in enumerate(args.cells):
        d = build(cell, args.seed + i, "cuda")
        r = traced_call(d, Path(args.logdir) / cell)
        print(f"== {cell}")
        print(json.dumps(r, indent=1), flush=True)
        if args.cost_runs:
            r["cost"] = cost(d, args.cost_runs)
        report[cell] = r
        d.release()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
