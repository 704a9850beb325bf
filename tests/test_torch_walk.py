"""The layer-walk count (CNT_WALK) of the kernel's plain version, the
parameter block's reciprocals and its size.  The CUDA kernel counts its walk
steps the same way; tests/test_torch_cuda.py holds the two against each
other on the card."""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from clsim_tpu_torch.medium.properties import make_homogeneous_ice
from clsim_tpu_torch.propagate import engine as E
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")


def plain_run(inputs, T):
    """One launch of the plain version on the inputs' stream; returns the
    counters."""
    medium, geo, spectra, cfg, steps, uni = inputs
    n = int(steps.x.shape[0])
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    return KT.run_fused_iterations(KT.init_state(steps), KT.pack_steps(steps),
                                   tables, spec, uniforms=uni[:T])[2]


def test_one_layer_walks_one_step_a_slot_iteration():
    """In a one-layer medium every walk ends at its first step (the layer is
    the edge both ways): CNT_WALK equals CNT_WORK."""
    medium, geo, spectra, cfg, steps, uni = chip_smoke.small_workload(
        512, 8, False, False, CPU)
    one = make_homogeneous_ice(n_layers=1, z_start=-1000.0,
                               layer_height=2000.0, device=CPU)
    cnt = plain_run((one, geo, spectra, cfg, steps, uni), 8)
    assert float(cnt[KT.CNT_WORK]) > 1000
    assert float(cnt[KT.CNT_WALK]) == float(cnt[KT.CNT_WORK])
    assert float(cnt[KT.CNT_WARPS]) == float(cnt[KT.CNT_SPAWN_WARPS]) == 0.0


@pytest.mark.parametrize("K,steps_expected", [(16, 10), (6, 7), (4, 5)])
def test_near_vertical_photon_crosses_known_layers(K, steps_expected):
    """A photon at z = 0 going up 3 degrees off vertical in 10 m layers
    (boundaries at 5, 15, ... m) with budgets that outlast the 90 m cap
    crosses the 9 boundaries below 90 m: 10 walk steps, at most K + 1.  An
    inactive lane beside it counts none."""
    medium, _ = chip_smoke.seeded_ice(171, -855.0, 10.0, CPU)
    cfg = dataclasses.replace(chip_smoke.small_workload(8, 1, False, False,
                                                        CPU)[3],
                              max_segment_m=90.0, max_layer_steps=K)
    th = np.deg2rad(3.0)
    f = lambda a, b: torch.tensor([a, b], dtype=torch.float32)
    st = E.SlotState(
        photons_left=f(0, 0), in_flight=f(1, 0), x=f(0, 0), y=f(0, 0),
        z=f(0, 0), t=f(0, 0), dx=f(np.sin(th), np.sin(th)), dy=f(0, 0),
        dz=f(np.cos(th), np.cos(th)), w0=f(1, 1), inv_gv=f(5, 5),
        abs_left=f(1e6, 1e6), gs=f(1, 1), pa=f(0, 0), qa=f(1e-6, 1e-6),
        ra=f(0, 0))
    budget = f(1e6, 1e6)
    tally = {}
    out = E._segment_distances(st, medium, cfg, budget, budget, tally=tally,
                               active=st.in_flight > 0.5)
    assert int(tally["walk"]) == steps_expected
    assert float(out[0][0]) == 90.0            # capped at max_segment_m
    ref = E._segment_distances(st, medium, cfg, budget, budget)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_walk_tally_leaves_the_plain_version_unchanged():
    """engine._iteration with the tally on gives the state, histogram and
    counters of a run with it off, bit for bit, on the main path's
    configuration (hex61, 171 layers of 10 m, 90 m segments)."""
    n, T = 512, 6
    medium, _ = chip_smoke.seeded_ice(171, -855.0, 10.0, CPU)
    _, geo, spectra, _, steps = chip_smoke.bench_workload(n, 200, CPU)
    cfg = PropagationConfig(n_slots=n, pancake_factor=5.0)
    uni = torch.as_tensor(np.random.default_rng(11).random(
        (T, 8, n)).astype(np.float32))
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    collide = lambda s, d, a: KT._check_collisions_subplan(s, tables, spec, d,
                                                           a)

    def run(tally):
        st, acc = E._init_state(steps), E._init_acc(geo.n_doms, cfg, CPU)
        for i in range(T):
            st, acc, _, _ = E._iteration(i, st, acc, steps, medium, None,
                                         spectra, cfg, uniforms=uni,
                                         collide=collide, tally=tally)
        return st, acc

    tally = {}
    (st_on, acc_on), (st_off, acc_off) = run(tally), run(None)
    for a, b in zip(list(st_on) + list(acc_on)[:5],
                    list(st_off) + list(acc_off)[:5]):
        assert torch.equal(a, b)
    work = float(acc_on.n_work)
    assert work < float(tally["walk"]) <= (cfg.max_layer_steps + 1) * work
    assert set(tally) == {"walk"}       # no water scatters in ice


def test_params_fill_reciprocals():
    """_params fills each reciprocal field with float32(1 / x) of its
    field's float32 value (the anisotropy's with the float32 square k_i^2),
    B2 as the float32 sum, the Liu exponent as float32 (1 - g) / (1 + g)."""
    medium, geo, spectra, cfg, steps, _ = chip_smoke.small_workload(
        64, 2, True, True, CPU)
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, 64, 2)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    p = KT._params(spec, tables, True, 0, 0)
    f = np.float32
    sq = lambda k: f(k) * f(k)
    of = dict(inv_layer_h=p.layer_h, inv_tilt_dz=p.tilt_dz, an_il1=sq(p.an_k1), an_il2=sq(p.an_k2),
              an_il3=sq(p.an_kz), an_ik1=p.an_k1, an_ik2=p.an_k2,
              an_ikz=p.an_kz)
    for name, x in of.items():
        assert f(x) != 0.0, name
        assert getattr(p, name) == float(f(1.0 / np.float64(f(x)))), name
    assert p.an_b2 == float(f(f(p.an_il1) + f(p.an_il2)) + f(p.an_il3))
    g = f(p.mean_cos)
    assert p.liu_beta == float((f(1.0) - g) / (f(1.0) + g))


def header_struct_bytes(src, name):
    """Bytes of `struct name` in csrc/propagate.cuh, from its declarations:
    every scalar 4 bytes, arrays sized by the header's #defines, nested
    PlanParams by their own declarations."""
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n", src)}
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    total = 0
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(unsigned int|int|float|PlanParams)\s+(.*)", decl,
                     re.S)
        size = (header_struct_bytes(src, "PlanParams")
                if m.group(1) == "PlanParams" else 4)
        for item in m.group(2).split(","):
            a = re.match(r"\s*\w+\s*(?:\[(\w+)\])?", item)
            n = a.group(1)
            total += size * (1 if n is None else defines.get(n) or int(n))
    return total


def test_params_size_matches_the_header():
    src = (Path(KT.__file__).resolve().parents[1] / "csrc"
           / "propagate.cuh").read_text()
    assert ctypes.sizeof(KT._Plan) == header_struct_bytes(src, "PlanParams")
    assert ctypes.sizeof(KT._Params) == header_struct_bytes(src, "Params")
