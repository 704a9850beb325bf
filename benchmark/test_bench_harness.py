"""CPU tests of the benchmark's harness: the import guard, the traffic's
repeatability, the rate and idle-share arithmetic, K1's work count, and a
toy cell added from new files only.

    python -m pytest benchmark/test_bench_harness.py -q
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, roofline, toy, trace  # noqa: E402


def test_forbidden_names_compare_top_level_whole():
    mods = ["clsim_tpu_torch", "clsim_tpu_torch.api", "clsim_tpu",
            "clsim_tpu.engine", "jaxlib.xla_client", "jax", "flax.linen",
            "jaxtyping", "numpy", "clsim_tpu_extra"]
    assert harness.forbidden_modules(mods) == [
        "clsim_tpu", "clsim_tpu.engine", "flax.linen", "jax",
        "jaxlib.xla_client"]


def test_benchmark_and_program_import_no_jax():
    """Everything a run imports, imported in a fresh process, pulls in no
    module of JAX or of the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness as H, benchmark.world, benchmark.control\n"
        "import benchmark.drivers.stream\n"
        "import benchmark.reference.frozen.propagate.engine\n"
        "import clsim_tpu_torch.api, clsim_tpu_torch.parallel.pipeline\n"
        "print(H.forbidden_modules(list(sys.modules)))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.stream_check, "
        "benchmark.reference.lowp\n"
        "import benchmark.reference.frozen.sources.ppc\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('clsim_tpu_torch', 'clsim_tpu', 'jax')))\n"
        % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("traffic", ["cascades-40tev", "flashes"])
def test_traffic_repeats_for_a_seed(traffic):
    spec = harness.load_spec()
    cell = next(w for w in spec["workloads"] if w["traffic"] == traffic)
    conf = json.loads((harness.HERE / "configs" /
                       f"{cell['config']}.json").read_text())
    tr = json.loads((harness.HERE / "traffic" / f"{traffic}.json")
                    .read_text())
    src = harness.load_module("sources", tr["source"], [harness.HERE])
    a, b = src.pool(tr, conf), src.pool(tr, conf)
    assert a == b and len(a) == tr["events_per_call"]
    assert len({json.dumps(d, sort_keys=True) for d in a}) == len(a)
    from benchmark.drivers.stream import Driver
    orders = []
    for seed in (2 ** 40 + 7, 2 ** 40 + 7, 5):
        ctx = SimpleNamespace(traffic=tr, config=conf, seed=seed,
                              source=lambda: src)
        d = Driver(ctx)
        orders.append([d.rng.permutation(len(a)).tolist()
                       for _ in range(3)])
    assert orders[0] == orders[1] and orders[0] != orders[2]


def test_configuration_keeps_ic86_and_spice_scales():
    """The detector has IC86's 86 strings and 5,160 DOMs (each DeepCore
    string's upper ten DOMs under a string id of their own, at the same
    x, y), and each ice layer's b400 is the geometric coefficient of a
    be400 inside its depth band's range."""
    from benchmark.world import layer_depths, raw_detector, raw_ice
    conf = json.loads((harness.HERE / "configs" / "ic86-production.json")
                      .read_text())
    det, ice = conf["detector"], conf["ice"]
    sids, oids, xs, ys, zs = raw_detector(det)
    assert len(sids) == 5160
    places = {(round(x, 3), round(y, 3)) for x, y in zip(xs, ys)}
    assert len(places) == 86 and len(set(sids.tolist())) == 94
    dc = sids >= det["strings"]
    assert dc.sum() == 8 * 60 and (zs[dc] > 100.0).sum() == 80
    raw = raw_ice(ice)
    be = raw["b400"] * (1.0 - ice["mean_cos"])
    depth = layer_depths(ice)
    for b in ice["bands"]:
        m = (depth >= b["depth_m"][0]) & (depth < b["depth_m"][1])
        lo, hi = b["be400"]
        assert m.any()
        assert (be[m] >= lo - 1e-6).all() and (be[m] <= hi + 1e-6).all()
    assert raw["delta_tau"][np.argmin(abs(depth - 1730.0))] == \
        pytest.approx(0.0, abs=0.2)
    assert raw_ice(ice)["b400"].tolist() == raw["b400"].tolist()


def test_bfloat16_keeps_whole_numbers():
    """The control rounds arithmetic to bfloat16 and leaves the whole
    numbers (the engine's float indices) as they are."""
    import torch
    from benchmark.reference.lowp import Bfloat16
    x = torch.tensor([5159.0, 301.0, 1.1, 1001.3])
    with Bfloat16():
        y = x * 1.0
        z = x / 7.0
    assert y[:2].tolist() == [5159.0, 301.0]
    assert y[2].item() == torch.tensor(1.1).to(torch.bfloat16).item()
    assert y[3].item() == 1000.0
    assert z.tolist() == [737.0, 43.0, *z[2:].tolist()]
    assert z[2].item() == (torch.tensor(1.1) / 7).to(torch.bfloat16).item()


def test_placement_is_blind_to_one_heavy_cell():
    """A cell that a hit above the weight cap made far too heavy moves
    neither number much; a shift of every cell moves the median, and a
    cell left short reads in lowest_z."""
    from benchmark.reference import stream_check as SC
    rng = np.random.default_rng(4)
    z = rng.standard_normal(40)
    ev = lambda v: [{"gen": 0.0, "hits": 0.0,
                     "cells": {f"c{i}": x for i, x in enumerate(v)}}]
    shift, lowest = SC.placement(ev(z))
    assert shift < 0.5 and 1.0 < lowest < 3.5
    heavy = z.copy()
    heavy[np.argmax(z)] = 300.0
    assert SC.placement(ev(heavy)) == (pytest.approx(shift, abs=0.1),
                                       lowest)
    assert SC.placement(ev(z + 3.0))[0] > 2.5
    short = z.copy()
    short[0] = -40.0
    assert SC.placement(ev(short))[1] == 40.0
    assert SC.placement(ev([])) == (math.inf, math.inf)


def test_union_gaps_and_idle_share_with_a_stall():
    # busy 0-2, 1-3 (overlap), 3-4 (touching), then a 5 us stall, 9-10
    iv = [(1.0, 3.0), (0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]
    merged = trace.union(iv)
    assert merged == [(0.0, 4.0), (9.0, 10.0)]
    assert trace.busy_seconds(iv) == pytest.approx(5e-6)
    assert trace.gaps(merged, 12.0) == [(4.0, 9.0), (10.0, 12.0)]
    assert trace.idle_share(5e-6, 12e-6) == pytest.approx(100 * 7 / 12)


def test_summarize_reads_a_profile():
    import torch
    CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(s, e, name, dev):
        return SimpleNamespace(time_range=SimpleNamespace(start=s, end=e),
                               name=name, device_type=dev)
    evs = [ev(0, 100, "propagate_kernel<...>", CUDA),
           ev(100, 150, "Memcpy DtoH", CUDA),
           ev(400, 500, "propagate_kernel<...>", CUDA),
           ev(140, 420, "aten::copy_", CPU), ev(0, 1000, "process", CPU)]
    s = trace.summarize(SimpleNamespace(events=lambda: evs), 1000e-6)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["launches"] == 2
    assert s["kernel_s"]["propagate_kernel<...>"] == pytest.approx(200e-6)
    assert s["device_ops"][0] == ["propagate_kernel<...>",
                                  pytest.approx(200e-6)]
    # the stall 150-400 is named by the copy that overlaps it most; the
    # tail 500-1000 by the span around the call
    assert s["idle_gaps"][0] == ["process", pytest.approx(500e-6)]
    assert s["idle_gaps"][1] == ["aten::copy_", pytest.approx(250e-6)]


def test_photons_per_s_is_all_photons_over_the_window():
    from benchmark.drivers.stream import Driver
    d = Driver.__new__(Driver)
    d.photons = 3.0e9
    assert d.end_to_end(12.5, 7) == {"photons_per_s": 2.4e8}


def _toy_driver(tmp_path, cell, backend):
    import torch
    spec = toy.write_toy(tmp_path)
    roots = [tmp_path, harness.HERE]
    w = harness.cell_of(spec, cell)
    conf = json.loads(harness.find("configs", w["config"], ".json",
                                   roots).read_text())
    tr = json.loads(harness.find("traffic", w["traffic"], ".json",
                                 roots).read_text())
    ctx = harness.Context(cell=w, config=conf, traffic=tr, seed=77,
                          device="cpu", roots=roots)
    from benchmark.drivers.stream import Driver
    d = Driver(ctx)
    from benchmark.world import program_world
    world = program_world(conf, "cpu")
    world.sim.backend = backend
    d.world = world
    from clsim_tpu_torch.parallel.pipeline import EventPipeline
    from benchmark.world import PROGRAM
    d.sources = [d.src.sources(PROGRAM, world, x) for x in d.pool]
    d.pipe = EventPipeline(world.sim, max_in_flight=1)
    d.call(0)
    torch.manual_seed(0)
    return conf, d


def test_k1_work_is_the_same_whatever_backend_propagated(tmp_path):
    """K1's operations and bytes count the cell's inputs (photons, batches),
    not what the propagating code did: the engine and the kernel's plain
    version give the same count."""
    out = []
    for backend in ("engine", "fused"):
        conf, d = _toy_driver(tmp_path / backend, "toy-ice.toy-cascades",
                              backend)
        batches = d.pipe.stats.as_dict()["NumKernelCalls"]
        out.append(roofline.k1_work(conf, d.world, d.photons, batches))
    assert out[0] == out[1]
    ops, nbytes, _ = out[0]
    assert ops > 0 and nbytes > 0


def test_roofline_bound_is_a_lower_bound_of_the_work():
    conf = json.loads((harness.HERE / "configs" / "ic86-production.json")
                      .read_text())
    from benchmark.world import REFERENCE, reference_world
    w = reference_world(conf, "cpu")
    sp = [(np.asarray(w.spectra.x[i]), np.asarray(w.spectra.beta[i]))
          for i in range(w.spectra.x.shape[0])]
    s = roofline.scatters_lower_bound(conf, sp)
    assert 0.0 < s < 50.0
    assert roofline.least_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_a_toy_cell_from_new_files_only(tmp_path):
    """A cell, its configuration, its traffic and a per-layer metric added
    as new files under another root are found by name, and the run's
    result line carries the new metric."""
    spec = toy.write_toy(tmp_path)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "toy_photons.py").write_text(
        "def read(data):\n    return data.get('photons')\n")
    spec["per_layer"].append(dict(
        name="toy_photons", unit="photons", better="higher",
        source="program_counter", layer="device", moves="photons_per_s",
        workloads=["toy-ice.toy-cascades"]))
    argv = ["--workload", "toy-ice.toy-cascades", "--seed", str(2 ** 33 + 1),
            "--seconds", "0.1"]
    out = harness.run_cell(argv + ["--trace", "1"], time.perf_counter(),
                           spec=spec, roots=[tmp_path], device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["toy_photons"]["value"] > 0
    assert "photons_per_s" not in out["metrics"]
    out = harness.run_cell(argv + ["--trace", "0"], time.perf_counter(),
                           spec=spec, roots=[tmp_path], device="cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"photons_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
