"""The benchmark harness: one run of one cell of BENCHMARK.json.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration and a traffic mix; the harness finds each by
name in files of their own:

    configs/<config>.json     the configuration's numbers (world.py reads them)
    traffic/<traffic>.json    the traffic mix's parameters; its "driver" names
                              drivers/<driver>.py and its "source" (where it
                              has one) sources/<source>.py
    metrics/<metric>.py       one reader per per-layer metric: read(data)
                              returns the metric's value, or None when the
                              run has nothing it reads

A driver module has `Driver(ctx)` with set_up(), call(i) (the window's
i-th call), counts() -> (attempted, failed), end_to_end(window, calls) ->
{metric: value}, layer_data(summary, window, calls) -> the readers' dict,
release() (frees the program's state) and check() -> [(name, value,
limit)].  The harness owns the clock, the window, the profiler, the
memory reading, the import guard and the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "clsim_tpu")


def forbidden_modules(modules: Sequence[str]) -> List[str]:
    """The modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: clsim_tpu_torch is not clsim_tpu."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_spec(path: Optional[Path] = None) -> dict:
    return json.loads(Path(path or HERE.parent / "BENCHMARK.json").read_text())


def find(kind: str, name: str, suffix: str, roots: Sequence[Path]) -> Path:
    """The file <root>/<kind>/<name><suffix> of the first root that has
    it."""
    for root in roots:
        p = Path(root) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                            f"{[str(r) for r in roots]}")


def load_module(kind: str, name: str, roots: Sequence[Path]):
    """Import <root>/<kind>/<name>.py by its path (names may hold '-' and
    '.')."""
    path = find(kind, name, ".py", roots)
    mod_name = f"benchmark_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seed, the device and the search roots."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    roots: Sequence[Path]

    def source(self):
        return load_module("sources", self.traffic["source"], self.roots)


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, section: str, cell: str, e2e: Sequence[str]):
    """The metrics of `section` that `cell` reports: those that list it
    under "workloads"; per-layer metrics without the key go to every cell
    that reports the metric they move."""
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def run_cell(argv: Sequence[str], t_start: float, *, spec: dict = None,
             roots: Sequence[Path] = (), device: str = None,
             patch: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object.  `device` other than
    None skips the look for a card (the tests drive the CPU with it);
    `patch(ctx, driver)` may break the timed path underneath (the
    tests' faults)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(list(argv))
    spec = spec or load_spec()
    roots = [*roots, HERE]
    cell = cell_of(spec, args.workload)
    import torch
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark measures the "
                             "card and has no CPU path")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA "
                             f"devices, {torch.cuda.device_count()} found")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    config = json.loads(find("configs", cell["config"], ".json",
                             roots).read_text())
    traffic = json.loads(find("traffic", cell["traffic"], ".json",
                              roots).read_text())
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                  device=device, roots=roots)
    driver = load_module("drivers", traffic["driver"], roots).Driver(ctx)
    if patch is not None:
        patch(ctx, driver)
    driver.set_up()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start

    from . import trace as T
    prof = T.profiler(on_card) if args.trace else None
    max_calls = traffic.get("trace_calls") if args.trace else None
    calls = 0
    if prof is not None:
        prof.__enter__()
    try:
        w0 = time.perf_counter()
        ends = []
        while True:
            driver.call(calls)
            calls += 1
            elapsed = time.perf_counter() - w0
            ends.append(elapsed)
            if elapsed >= args.seconds or (max_calls and calls >= max_calls):
                break
        sync()
        window = time.perf_counter() - w0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if on_card else 0}

    e2e_names = [m["name"] for m in metrics_for(spec, "end_to_end",
                                                args.workload, ())]
    metrics, breakdown = {}, None
    if args.trace:
        summary = T.summarize(prof, window)
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = window
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        data = driver.layer_data(summary, window, calls)
        for m in metrics_for(spec, "per_layer", args.workload, e2e_names):
            reader = load_module("metrics", m["name"], roots)
            v = reader.read(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = driver.end_to_end(window, calls)
        values["setup_s"] = setup_s
        for m in metrics_for(spec, "end_to_end", args.workload, ()):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    attempted, failed = driver.counts()
    driver.release()
    c0 = time.perf_counter()
    checks = driver.check()
    print(f"timing setup_s {setup_s:.3f} window_s {window:.3f} calls "
          f"{calls} check_s {time.perf_counter() - c0:.3f} call_s " + " ".join(
              f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)),
          file=sys.stderr)
    found = forbidden_modules(list(sys.modules))
    if found:
        raise SystemExit("modules of JAX or of the JAX package were "
                         f"imported: {found}")
    checks = [(name, float(v), float(lim)) for name, v, lim in checks]
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": float(v), "limit": float(lim)}
                     for name, v, lim in checks}
    return out


def main(argv: Sequence[str], t_start: float) -> int:
    out = run_cell(argv, t_start)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
