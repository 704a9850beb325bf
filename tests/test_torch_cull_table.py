"""The card's cull table of the global plans (kernel.card_cull_table): one
list per fine cell and azimuth sector, read through the program's reader
(kernel.card_lists), holds every string that the kernel's static-cap cull
can pass from that cell and sector, in float32 as the kernel computes it,
with and without fused multiply-adds; the lists ascend by string index,
carry the JAX package's values and fit their budget; the fallback is the
JAX package's lists; the plain version's candidates are the lengths of
the lists it reads; and the call loop records the cull's two counters at
a wait it already had.  On IC86 as the benchmark
builds it, as the JAX package's bench.py builds it, and surveyed (the
general plan).

    python -m pytest tests/test_torch_cull_table.py -q
"""

import json
import types
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import chip_smoke

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig
from clsim_tpu_torch.util import profiling as P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
F32 = np.float32


def _benchmark_ic86():
    from benchmark.world import make_config, make_geometry, PROGRAM
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "ic86-production.json").read_text())
    return (make_geometry(PROGRAM, conf["detector"], "cpu"),
            make_config(PROGRAM, conf["propagation"]))


def _jax_ic86():
    geo_j = bench.icecube86_geometry()
    return (C.geometry_from_numpy(C.numpy_tree(geo_j), device="cpu"),
            PropagationConfig())


def _surveyed_ic86():
    return chip_smoke.ic86(CPU, chip_smoke.JITTER_M), PropagationConfig()


GEOMETRIES = {"benchmark": _benchmark_ic86, "jax-bench": _jax_ic86,
              "surveyed": _surveyed_ic86}
_PLANS = {}


def plan(name):
    """(spec's geometry fields, the JAX package's cell table, the general plan's
    half-widths or None, the card's rows and parameters), built once."""
    if name not in _PLANS:
        geo, cfg = GEOMETRIES[name]()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fields, cell_tab = KT.geometry_fields(geo, cfg, 1024, 16, False)
        spec = types.SimpleNamespace(**fields)
        half = (None if fields["affine_doms"]
                else KT.general_window(geo, cfg)[0])
        rows, sc = KT.card_cull_table(spec, cell_tab, half)
        _PLANS[name] = spec, cell_tab, half, rows, sc
    return _PLANS[name]


def jax_strings(spec, cell_tab):
    """Per string (sx, sy, maxr2) of the JAX package's table, and per
    coarse cell its list of string indices."""
    K, nc = spec.K_cand, spec.n_cull_cells
    blk = cell_tab[:10 * K, :nc].reshape(10, K, nc)
    sidx = blk[9].astype(np.int64)
    n = int(sidx.max()) + 1
    per = np.zeros((n, 3), F32)
    kk, cc = np.nonzero(sidx >= 0)
    per[sidx[kk, cc]] = blk[:3, kk, cc].T
    lists = [sidx[:, c][sidx[:, c] >= 0] for c in range(nc)]
    return per, lists


def lists_of(rows, sc):
    """The card's (offset, count) pairs and its cull entries."""
    hdr = rows[sc["c_hdr"]:sc["c_ent"]].view(np.int32).reshape(-1, 2)
    return hdr, rows[sc["c_ent"]:]


def culled(per, x, y, dx, dy, seg, fma):
    """(photon, string) pairs that pass the kernel's static-cap cull
    (csrc/propagate.cuh: the 2-D point-to-segment distance against maxr2),
    over every string, in float32; `fma` contracts a * b + c as the card's
    compiler may (one rounding)."""
    def mad(a, b, c):
        if fma:
            return (a.astype(np.float64) * b + c).astype(F32)
        return a * b + c
    dxy2 = dx * dx + dy * dy
    inv = F32(1.0) / np.maximum(dxy2, F32(1e-20))
    rx = per[None, :, 0] - x[:, None]
    ry = per[None, :, 1] - y[:, None]
    bd2 = mad(rx, dx[:, None], ry * dy[:, None])
    t2d = np.clip(bd2 * inv[:, None], F32(0.0), F32(seg))
    cx = mad(-dx[:, None], t2d, rx)
    cy = mad(-dy[:, None], t2d, ry)
    d2 = mad(cx, cx, cy * cy)
    return np.nonzero((d2 <= per[None, :, 2]) & (dxy2 > 0.0)[:, None])


def samples(kind, per, sc, m, seg, rng, n=20000):
    """Photon positions and 2-D directions (float32): `random` uniform over
    the grid and isotropic; `cell-edges` near strings, on the fine cells'
    edges and one float32 step either side of them; `sector-edges` near
    strings with directions on the sectors' boundaries (the axes, dx = 0,
    dy = 0, the octant diagonals |dx| = |dy|) and one float32 step off
    them; `reach-edges` with a horizontal direction along a sector boundary
    and the capped segment's far end within a string's cull radius."""
    if kind == "random":
        w = sc["c_nx"] / sc["c_inv_cell"], sc["c_ny"] / sc["c_inv_cell"]
        x = sc["c_x0"] + w[0] * rng.random(n)
        y = sc["c_y0"] + w[1] * rng.random(n)
    elif kind == "reach-edges":
        # the segment's far end grazes a string's disc, pointing along a
        # sector boundary (or one float32 step off it): the region's far
        # corners
        s = rng.integers(0, per.shape[0], n)
        phi = (rng.integers(0, 4 * max(m, 1), n) * np.pi / (2 * max(m, 1))
               + rng.choice([0.0, 1e-7, -1e-7], n))
        u = np.stack([np.cos(phi), np.sin(phi)])
        lat = np.sqrt(per[s, 2]) * rng.uniform(-0.999, 0.999, n)
        back = seg * rng.uniform(0.99, 0.9999, n)
        x = per[s, 0] - back * u[0] - lat * u[1]
        y = per[s, 1] - back * u[1] + lat * u[0]
        return (x.astype(F32), y.astype(F32), u[0].astype(F32),
                u[1].astype(F32))
    else:
        s = rng.integers(0, per.shape[0], n)
        x = per[s, 0] + rng.normal(0.0, 50.0, n)
        y = per[s, 1] + rng.normal(0.0, 50.0, n)
    st = np.sqrt(1.0 - rng.uniform(-1.0, 1.0, n) ** 2)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    if kind == "sector-edges":
        k = rng.integers(0, 8 * max(m, 1), n)
        phi = k * np.pi / (4 * max(m, 1))
    x, y = x.astype(F32), y.astype(F32)
    dx, dy = (st * np.cos(phi)).astype(F32), (st * np.sin(phi)).astype(F32)
    if kind == "cell-edges":
        h = F32(1.0) / F32(sc["c_inv_cell"])
        for a, o in ((x, sc["c_x0"]), (y, sc["c_y0"])):
            on = rng.random(n) < 0.7
            edge = (F32(o) + np.round((a - F32(o)) / h) * h).astype(F32)
            a[on] = edge[on]
        step = rng.integers(-1, 2, n)
        x = np.where(step == 0, x, np.nextafter(
            x, np.where(step > 0, np.inf, -np.inf).astype(F32))).astype(F32)
    if kind == "sector-edges":
        pick = rng.integers(0, 6, n)
        diag = np.abs(dx) * np.sign(dy)
        dy = np.where(pick == 1, diag, dy).astype(F32)       # |dy| = |dx|
        dx = np.where(pick == 2, F32(0.0), dx).astype(F32)
        dy = np.where(pick == 3, F32(0.0), dy).astype(F32)
        dx = np.where(pick == 4, -F32(0.0), dx).astype(F32)
        ulps = rng.choice([-1, 1], n)
        off = pick == 5
        dy[off] = np.array([np.nextafter(v, v + np.sign(u) * np.inf)
                            for v, u in zip(dy[off], ulps[off])],
                           F32)
    return x, y, dx, dy


@pytest.mark.parametrize("kind", ["random", "cell-edges", "sector-edges",
                                  "reach-edges"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_card_lists_hold_every_string_the_cull_passes(name, kind):
    spec, cell_tab, _, rows, sc = plan(name)
    per, jlists = jax_strings(spec, cell_tab)
    rng = np.random.default_rng(zlib.crc32(f"{name} {kind}".encode()))
    x, y, dx, dy = samples(kind, per, sc, sc["c_qmul"],
                           spec.cfg.max_segment_m, rng)
    ent, cnt = KT.card_lists(torch.from_numpy(rows), sc,
                             *map(torch.from_numpy, (x, y, dx, dy)))
    ent, cnt = ent.numpy(), cnt.numpy()
    # past its count a list's entries pass no cull
    past = np.arange(ent.shape[1]) >= cnt[:, None]
    assert np.all(ent[..., 2][past] == -1.0) and cnt.max() <= sc["max_list"]
    jx = np.clip(np.floor((x - F32(spec.cell_x0)) * F32(spec.inv_cell)), 0,
                 spec.cell_nx - 1).astype(np.int64)
    jy = np.clip(np.floor((y - F32(spec.cell_y0)) * F32(spec.inv_cell)), 0,
                 spec.cell_ny - 1).astype(np.int64)
    seg = spec.cfg.max_segment_m
    n_pass = 0
    for fma in (False, True):
        ph, st = culled(per, x, y, dx, dy, seg, fma)
        n_pass += ph.size
        for p, s in zip(ph, st):
            assert s in ent[p, :cnt[p], 3].astype(np.int64), (p, s)
            assert s in jlists[jx[p] * spec.cell_ny + jy[p]], (p, s)
    assert n_pass > 50
    # the card loads a small share of what the coarse lists load
    card = cnt.mean()
    coarse = np.mean([len(jlists[c]) for c in jx * spec.cell_ny + jy])
    assert card < coarse / 5


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_card_lists_ascend_carry_the_jax_values_and_fit(name):
    spec, cell_tab, half, rows, sc = plan(name)
    hdr, ent = lists_of(rows, sc)
    assert rows.dtype == np.float32 and rows.nbytes <= KT.CULL_TABLE_BUDGET
    assert sc["c_sectors"] == 4 * sc["c_qmul"] > 0
    assert sc["c_inv_cell"] > spec.inv_cell       # finer than the JAX cell
    n_lists = sc["c_nx"] * sc["c_ny"] * sc["c_sectors"]
    assert hdr.shape[0] >= n_lists and hdr[n_lists:, 1].sum() == 0
    assert hdr[:n_lists, 1].sum() == ent.shape[0]
    assert hdr[:n_lists, 1].max() == sc["max_list"]
    for o, n in hdr[:n_lists]:
        s = ent[o:o + n, 3].astype(np.int64)
        assert np.all(np.diff(s) > 0)
    # every value the kernel reads equals the JAX package's table's for
    # the same string: the cull entry, the z extent and ladder, the DOM
    # offset, 1 / dz and the z-window's half-width
    K, nc = spec.K_cand, spec.n_cull_cells
    blk = cell_tab[:10 * K, :nc].reshape(10, K, nc)
    n_str = sc["c_lad"]
    for k, c in zip(*np.nonzero(blk[9] >= 0)):
        v = blk[:, k, c]
        s = int(v[9])
        np.testing.assert_array_equal(rows[s], v[4:8])
        np.testing.assert_array_equal(rows[n_str + s], [
            v[8], v[3], F32(1.0 / np.float64(v[7])),
            0.0 if half is None else half[s]])
        mine = ent[ent[:, 3] == s, :3]
        assert mine.shape[0] > 0
        np.testing.assert_array_equal(mine, np.broadcast_to(v[:3],
                                                            mine.shape))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_card_table_past_its_budget_is_the_jax_lists(name):
    spec, cell_tab, half, _, _ = plan(name)
    rows, sc = KT.card_cull_table(spec, cell_tab, half, budget=0)
    _, jlists = jax_strings(spec, cell_tab)
    hdr, ent = lists_of(rows, sc)
    assert (sc["c_qmul"], sc["c_m"], sc["c_sectors"]) == (0, 1, 1)
    assert sc["c_inv_cell"] == float(F32(spec.inv_cell))
    assert (sc["c_nx"], sc["c_ny"]) == (spec.cell_nx, spec.cell_ny)
    for c in range(spec.cell_nx * spec.cell_ny):
        o, n = hdr[c]
        np.testing.assert_array_equal(ent[o:o + n, 3], jlists[c])
    # one sector: every direction reads sector 0
    d = torch.tensor([1.0, -1.0, 0.0, 0.5])
    assert not KT.cull_sector(d, d.flip(0), sc).any()


def test_sector_rule_by_comparisons():
    """The kernel's sectors on exact boundaries: quadrants by the signs
    (-0 counts as not negative), thresholds tan(k pi / 2m) exceeded
    strictly, the axes and the diagonals in the lower sector."""
    sc = KT.sector_scalars(4)
    t = lambda *v: torch.tensor(v, dtype=torch.float32)
    ang = torch.arange(16, dtype=torch.float64) * np.pi / 8 + np.pi / 16
    got = KT.cull_sector(ang.cos().float(), ang.sin().float(), sc)
    want = [0, 1, 2, 3, 7, 6, 5, 4, 12, 13, 14, 15, 11, 10, 9, 8]
    assert got.tolist() == want
    axes = KT.cull_sector(t(1, 0, -1, 0, -0.0, 0), t(0, 1, 0, -1, 1, -0.0),
                          sc)
    assert axes.tolist() == [0, 3, 4, 11, 3, 0]
    diag = KT.cull_sector(t(1, -1), t(1, 1), KT.sector_scalars(1))
    assert diag.tolist() == [0, 1]


def _stream_inputs(geo, n=1024, steps_per=8):
    medium, _ = chip_smoke.seeded_ice(171, -855.0, 10.0, CPU)
    spectra = chip_smoke.medium_spectra(medium, geo, CPU)
    _, _, _, _, steps = chip_smoke.bench_workload(n, steps_per, CPU)
    return medium, spectra, steps, PropagationConfig(n_slots=n)


@pytest.mark.parametrize("plan_kind", ["global", "subplans"])
def test_call_loop_records_the_cull_counters_at_an_existing_wait(plan_kind):
    """propagate_fused (the plain version on the CPU), recording: the
    global plans add the run's CNT_CAND and CNT_WORK to the counters
    k1_candidates and k1_slot_iterations, read at the "totals" wait; the
    waits are those the call loop had (check, alive a call, totals); the
    SubPlans record neither counter."""
    geo = (chip_smoke.ic86(CPU) if plan_kind == "global"
           else chip_smoke.hex61(CPU))
    medium, spectra, steps, cfg = _stream_inputs(geo)
    run = lambda: KT.propagate_fused(steps, medium, geo, spectra, 5, cfg,
                                     iters_per_call=8, max_calls=3)
    KT.clear_plans()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run()                                      # plans; then reused
        with P.recording() as rec:
            res, totals = run()
    calls = res.n_iterations // 8
    waits = {c["site"]: c["n"] for c in rec.counters()
             if c["name"] == "waits"}
    assert waits == {"check": 1, "alive": calls, "totals": 1}
    assert rec.total("plan_reuse") == 1
    cand, work = rec.total("k1_candidates"), rec.total("k1_slot_iterations")
    if plan_kind == "global":
        assert cand == float(totals[KT.CNT_CAND]) > 0
        assert work == float(totals[KT.CNT_WORK]) > 0
    else:
        assert not any(c["name"].startswith("k1_") for c in rec.counters())


@pytest.mark.parametrize("name", ["benchmark", "surveyed"])
def test_plain_candidates_are_the_lengths_of_the_lists_read(name,
                                                            monkeypatch):
    """A launch of the plain version counts as CNT_CAND the summed counts
    of the lists its live slot-iterations read (active, not vertical), as
    the kernel counts them: on the benchmark's IC86 stand-in (the affine
    plan) and on IC86 surveyed (the general plan)."""
    geo, _ = GEOMETRIES[name]()
    medium, spectra, steps, cfg = _stream_inputs(geo)
    spec, cell_tab = chip_smoke.quiet(KT.fused_spec, medium, geo, spectra,
                                      cfg, 1024, 16)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    read = []
    inner = KT._check_collisions_global

    def spy(state, tables, spec, d_prop, active, tally=None):
        live = active & (state.dx * state.dx + state.dy * state.dy > 0.0)
        _, cnt = KT.card_lists(tables.cells, tables.scalars, state.x,
                               state.y, state.dx, state.dy)
        read.append(int(cnt[live].sum()))
        return inner(state, tables, spec, d_prop, active, tally)
    monkeypatch.setattr(KT, "_check_collisions_global", spy)
    _, _, c = KT.run_fused_iterations(KT.init_state(steps),
                                      KT.pack_steps(steps), tables, spec)
    assert len(read) == 16
    assert float(c[KT.CNT_CAND]) == sum(read) > 0
    assert float(c[KT.CNT_CULL]) > 0
