"""The z-window over the general plan's DOM rows (kernel.general_window):
the windowed collision test of the kernel's plain version against a
brute-force test of every DOM row of every string, bit for bit; the host's
window half-widths and n_win on a crafted geometry; the plain version's
count of the rows it tests (CNT_ROWS) on a crafted segment.  The CUDA
kernel tests the same rows (tests/test_torch_cuda.py holds its CNT_ROWS
against the plain version's on the card)."""

import numpy as np
import pytest
import torch

import chip_smoke
from clsim_tpu_torch.geometry import build_geometry
from clsim_tpu_torch.propagate import engine as E
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
OVERSIZE = 5.0


def ladders(step_sign, amp, seed=3):
    """Three strings 40 m apart, ragged (60, 45 and 30 DOMs at 17, 7 and
    17 m), numbered downwards (step_sign -1, as IceCube) or upwards; every
    DOM's z moved by a seeded uniform draw of up to `amp` metres on the 17 m
    ladders (amp * 7 / 17 on the 7 m one, so that no spheres overlap; with
    amp 0 one DOM is moved 0.5 m in x, so the general plan serves it with
    residuals z of 0)."""
    rng = np.random.default_rng(seed)
    sids, oids, xs, ys, zs = [], [], [], [], []
    for s, (nd, dz, z0) in enumerate(((60, 17.0, 500.0), (45, 7.0, 150.0),
                                      (30, 17.0, 300.0))):
        for d in range(nd):
            sids.append(s)
            oids.append(d)
            xs.append(40.0 * s)
            ys.append(5.0 * s)
            zs.append(z0 + step_sign * (d * dz - (nd - 1) * dz / 2.0)
                      + amp * dz / 17.0 * rng.uniform(-1.0, 1.0))
    xs, ys, zs = (np.asarray(a) for a in (xs, ys, zs))
    if not amp:
        xs[0] += 0.5
    return build_geometry(sids, oids, xs, ys, zs, oversize=OVERSIZE,
                          device=CPU)


def spec_and_tables(geo, pancake, n_slots):
    medium, _ = chip_smoke.seeded_ice(171, -855.0, 10.0, CPU)
    spectra = chip_smoke.medium_spectra(medium, geo, CPU)
    cfg = PropagationConfig(n_slots=n_slots, pancake_factor=pancake,
                            strings_per_photon=4)
    spec, cell_tab = chip_smoke.quiet(KT.fused_spec, medium, geo, spectra,
                                      cfg, n_slots, 1)
    assert KT.kernel_coll(spec) == KT.COLL_GENERAL
    return spec, KT.build_tables(spec, medium, geo, spectra, cell_tab)


def photons(geo, n, kind, seed=5):
    """n photon segments aimed near DOMs: isotropic, near-vertical (|dz| >
    0.999) or near-horizontal (|dz| < 0.02) directions, each from up to
    100 m before a point within 1.5 r of a DOM's centre, a quarter started
    inside a DOM's sphere, a quarter at the 90 m cap and the rest of random
    length.  Returns (SlotState, d_prop)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([geo.dom_x.numpy(), geo.dom_y.numpy(),
                    geo.dom_z.numpy()], 1)
    r = geo.collision_radius
    if kind == "isotropic":
        cz = rng.uniform(-1.0, 1.0, n)
    elif kind == "vertical":
        cz = rng.choice([-1.0, 1.0], n) * rng.uniform(0.999, 0.99999, n)
    else:
        cz = rng.uniform(-0.02, 0.02, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sz = np.sqrt(1.0 - cz ** 2)
    d = np.stack([sz * np.cos(phi), sz * np.sin(phi), cz], 1)
    at = pos[rng.integers(0, len(pos), n)]
    inside = np.arange(n) % 4 == 0
    near = at + rng.uniform(-1.5, 1.5, (n, 3)) * r
    back = np.where(inside, 0.0, rng.uniform(0.0, 100.0, n))
    p = np.where(inside[:, None], at + rng.uniform(-0.5, 0.5, (n, 3)) * r,
                 near - d * back[:, None])
    length = np.where(np.arange(n) % 4 == 1, 90.0, rng.uniform(0.0, 90.0, n))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    one, zero = torch.ones(n), torch.zeros(n)
    st = E.SlotState(photons_left=zero, in_flight=one, x=f(p[:, 0]),
                     y=f(p[:, 1]), z=f(p[:, 2]), t=zero, dx=f(d[:, 0]),
                     dy=f(d[:, 1]), dz=f(d[:, 2]), w0=one, inv_gv=one,
                     abs_left=one, gs=one, pa=zero, qa=one, ra=zero)
    return st, f(length)


def every_row(st, tables, d_prop, inv_pancake, r2):
    """Brute force: the ray-sphere test of every valid DOM row of every
    string (the kernel's arithmetic, in its order), the nearest entry in
    [0, d_prop) wins, ties keep the first row.  Returns (hit, distance,
    DOM)."""
    rel, strings = tables.rel, tables.strings          # (S, M, 4), (S, 4)
    S, M, _ = rel.shape
    m = torch.arange(M, dtype=torch.float32)
    x, y, z = (a[:, None, None] for a in (st.x, st.y, st.z))
    dx, dy, dz = (a[:, None, None] for a in (st.dx, st.dy, st.dz))
    sf = strings[None, :, None, :]
    ox = sf[..., 0] + rel[None, ..., 0] - x
    oy = sf[..., 1] + rel[None, ..., 1] - y
    oz = sf[..., 2] + sf[..., 3] * m + rel[None, ..., 2] - z
    dr2 = ox * ox + oy * oy + oz * oz
    urdot = ox * dx + oy * dy + oz * dz
    discr = urdot * urdot - dr2 + r2
    smin1 = urdot - torch.sqrt(torch.clamp(discr, min=0.0)) * inv_pancake
    ok = ((rel[None, ..., 3] > 0.5) & (discr >= 0.0) & (smin1 >= 0.0)
          & (smin1 < d_prop[:, None, None]))
    flat = torch.where(ok, smin1, torch.full_like(smin1, E.BIG)).reshape(
        len(d_prop), -1)
    best, k = torch.min(flat, dim=1)
    hit = best < d_prop
    first = torch.as_tensor(np.cumsum([0] + [
        int((rel[s, :, 3] > 0.5).sum()) for s in range(S - 1)]))
    dom = first[k // M] + k % M
    return hit, torch.where(hit, best, d_prop), torch.where(hit, dom, 0)


@pytest.mark.parametrize("step_sign", [-1.0, 1.0])
@pytest.mark.parametrize("pancake", [1.0, 5.0])
@pytest.mark.parametrize("kind", ["isotropic", "vertical", "horizontal"])
@pytest.mark.parametrize("amp", [0.0, 0.4, 3.0])
def test_windowed_rows_equal_every_row(step_sign, pancake, kind, amp):
    """The plain version's windowed general test (the rows the kernel
    tests) finds the same hits, entry distances and DOMs, bit for bit, as
    the test of every row, on ragged strings numbered either way, with z
    residuals from 0 to 3 m (amp), pancake factor 1 and 5, photons inside
    DOMs and segments at the 90 m cap; and it tests fewer rows."""
    geo = ladders(step_sign, amp)
    n = 4096
    spec, tables = spec_and_tables(geo, pancake, n)
    assert spec.n_win < tables.rel.shape[1]
    st, d_prop = photons(geo, n, kind)
    active = torch.ones(n, dtype=torch.bool)
    tally = {}
    hit, dist, dom = KT._check_collisions_global(st, tables, spec, d_prop,
                                                 active, tally)
    sc = tables.scalars
    hit_b, dist_b, dom_b = every_row(st, tables, d_prop, sc["inv_pancake"],
                                     sc["r2"])
    assert int(hit_b.sum()) > 20
    assert torch.equal(hit, hit_b)
    assert torch.equal(dist, dist_b)
    assert torch.equal(torch.where(hit, dom, 0), dom_b)
    assert 0 < tally["rows"] < tally["tested"] * spec.n_win


def test_window_half_widths_and_n_win():
    """general_window on a crafted geometry: the half-width of a string is
    (r + 1 m + its largest |residual z|) / |dz| ladder rows, a string of
    one DOM keeps every row (BIG), n_win is the most rows a 90 m segment's
    window holds (the densest ladder's) and pancake_factor < 1 turns the
    window off."""
    zs = [100.0 - 17.0 * d for d in range(10)]
    zs[3] += 0.6                                     # residual up to ~0.6 m
    sids = [0] * 10 + [1] * 20 + [2]
    oids = list(range(10)) + list(range(20)) + [0]
    xs = [0.0] * 10 + [60.0] * 20 + [120.0]
    zz = zs + [50.0 + 7.0 * d for d in range(20)] + [0.0]
    geo = build_geometry(sids, oids, xs, [0.0] * 31, zz, oversize=OVERSIZE,
                         device=CPU)
    r = geo.collision_radius
    rel = geo.string_dom_rel.numpy()
    rz0 = np.abs(rel[0, :10, 2]).max()
    assert 0.4 < rz0 < 0.6
    half, n_win = KT.general_window(geo, PropagationConfig())
    dz0 = abs(float(geo.string_features[0, 5]))
    np.testing.assert_allclose(half[0], (r + 1.0 + rz0) / dz0, rtol=1e-6)
    np.testing.assert_allclose(half[1], (r + 1.0) / 7.0, rtol=1e-4)
    assert half[2] == np.float32(E.BIG)
    assert n_win == int(np.floor(90.0 / 7.0 + 2.0 * half[1])) + 2 == 15
    half_p, n_win_p = KT.general_window(
        geo, PropagationConfig(pancake_factor=0.5))
    assert (half_p == np.float32(E.BIG)).all() and n_win_p == 20


def test_plain_rows_on_a_known_window():
    """One photon 0.3 m off a 17 m ladder's axis (numbered downwards from
    z = 500), at z = 100 going down (dz = -0.6) over 50 m: its z-range
    [70, 100] is ladder rows 23.53-25.29, widened by (r + 1) / 17 rows, so
    the window holds rows 24 and 25: CNT_ROWS 2 for its one tested
    string."""
    zs = [500.0 - 17.0 * d for d in range(60)]
    xs = [0.0] * 60
    xs[59] = 0.5                  # off the ladder in x only: general, rz 0
    geo = build_geometry([0] * 60, list(range(60)), xs, [0.0] * 60, zs,
                         oversize=OVERSIZE, device=CPU)
    spec, tables = spec_and_tables(geo, 1.0, 1)
    f = lambda v: torch.tensor([v], dtype=torch.float32)
    st = E.SlotState(photons_left=f(0), in_flight=f(1), x=f(0.3), y=f(0.0),
                     z=f(100.0), t=f(0), dx=f(0.8), dy=f(0.0), dz=f(-0.6),
                     w0=f(1), inv_gv=f(1), abs_left=f(1), gs=f(1), pa=f(0),
                     qa=f(1), ra=f(0))
    tally = {}
    KT._check_collisions_global(st, tables, spec, f(50.0),
                                torch.ones(1, dtype=torch.bool), tally)
    assert int(tally["tested"]) == 1
    assert int(tally["rows"]) == 2


def test_window_keeps_the_plain_runs_hits():
    """A launch of the plain version on jittered ic86 (the general plan)
    gives the same histogram and counts as the same launch with the window
    turned off (every row tested), and counts fewer rows."""
    medium, _ = chip_smoke.seeded_ice(171, -855.0, 10.0, CPU)
    geo = chip_smoke.ic86(CPU, chip_smoke.JITTER_M)
    spectra = chip_smoke.medium_spectra(medium, geo, CPU)
    n, T = 2048, 8
    _, _, _, _, steps = chip_smoke.bench_workload(n, 200, CPU)
    cfg = PropagationConfig(n_slots=n, pancake_factor=5.0)
    uni = torch.as_tensor(np.random.default_rng(9).random(
        (T, 8, n)).astype(np.float32))
    spec, cell_tab = chip_smoke.quiet(KT.fused_spec, medium, geo, spectra,
                                      cfg, n, T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    M = tables.rel.shape[1]
    rows, n_str = tables.cells.clone(), tables.scalars["c_lad"]
    rows[n_str:2 * n_str, 3] = E.BIG         # every half-width: no window
    off = tables._replace(cells=rows)
    runs = [KT.run_fused_iterations(KT.init_state(steps),
                                    KT.pack_steps(steps), t, s, uniforms=uni)
            for t, s in ((tables, spec), (off, spec._replace(n_win=M)))]
    (_, h_w, c_w), (_, h_a, c_a) = runs
    assert torch.equal(h_w, h_a)
    for k in (KT.CNT_GEN, KT.CNT_HITS, KT.CNT_WSUM, KT.CNT_TESTED):
        assert float(c_w[k]) == float(c_a[k])
    assert float(c_w[KT.CNT_HITS]) > 0
    assert 0 < float(c_w[KT.CNT_ROWS]) < float(c_a[KT.CNT_ROWS]) / 4
