"""A toy of the benchmark's cells for its CPU tests: the same configurations
and traffic mixes with a small detector and ice, small events and few
photons, written as new files under a directory of their own that the
harness searches before its own (`write_toy(root)`), so that adding them
edits nothing that exists."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness import HERE, load_spec

DETECTOR = dict(strings=7, string_spacing_m=50.0, doms_per_string=10,
                dom_spacing_m=12.0, z_top_m=50.0, deepcore_strings=0,
                dom_oversize=15.0)
# clear ice (a tenth of SPICE's scattering) keeps the CPU's runs short
ICE = dict(n_layers=20, z_start_m=-200.0, layer_height_m=20.0,
           bands=[dict(depth_m=[1000.0, 3000.0], be400=[0.002, 0.005],
                       a_dust400=[0.004, 0.010])])

CELLS = {
    "toy-ice.toy-cascades": ("toy-ice", "toy-cascades", "cascades-40tev",
                             dict(energy_gev=2000.0, vertex_r_max_m=40.0,
                                  vertex_z_max_m=40.0, events_per_call=1,
                                  warmup_events=1, check_events=1,
                                  check_photons=65536,
                                  host_sample_events=1, trace_calls=1)),
    "toy-ice.toy-flashes": ("toy-ice", "toy-flashes", "flashes",
                            dict(photons_at_max_brightness=8e6,
                                 events_per_call=1, check_events=1,
                                 check_photons=65536, host_sample_events=1,
                                 trace_calls=1)),
}
# e2e metric of each toy cell, as its full-size sibling reports it
SIBLING = {"toy-ice.toy-cascades": "ic86-production.cascades-40tev",
           "toy-ice.toy-flashes": "ic86-production.flashes"}


def _config(name: str, base: str, prop: dict) -> dict:
    c = json.loads((HERE / "configs" / f"{base}.json").read_text())
    c["name"] = name
    c["detector"].update(DETECTOR)
    c["ice"].update(ICE)
    c["propagation"].update(prop)
    return c


def write_toy(root: Path) -> dict:
    """Write the toy's configs and traffic under `root`; returns the spec
    (BENCHMARK.json with the toy cells added to its workloads and
    metrics)."""
    root = Path(root)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "traffic").mkdir(parents=True, exist_ok=True)
    confs = {"toy-ice": _config("toy-ice", "ic86-production",
                                dict(n_slots=8192))}
    # small cascade steps: the toy's few photons then make many steps, as
    # a full-size event's do, so its cells are not ruled by a few steps
    confs["toy-ice"]["photons_per_step"] = 10
    for name, c in confs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    spec = load_spec()
    for cell, (conf, traffic, base, upd) in CELLS.items():
        t = json.loads((HERE / "traffic" / f"{base}.json").read_text())
        t.update(upd)
        (root / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
        spec["workloads"].append(dict(name=cell, config=conf,
                                      traffic=traffic, chips=1, why="toy"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if SIBLING[cell] in m.get("workloads", ()):
                m["workloads"].append(cell)
    return spec
