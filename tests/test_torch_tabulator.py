"""The port's tabulator (clsim_tpu_torch.tabulator) against clsim_tpu's on
the same inputs: the axes' integers and edges, the coordinate functions, one
propagation chunk entry by entry, whole tables on the same seed in the three
configurations of tests/test_tabulator.py (:37, :106, :165; shrunk to 64
slots, a 10 m segment cap and axes of 4-12 bins), the FITS bytes, and the
analytic radial referee (validate/table_referee.py) at a small size.

Tolerances: equal integers for the axes; coordinates within 1e-4 (abs) /
1e-5 (rel); table L1 <= 2e-3 of the total with equal n_photons and
header.  The measured L1 of each configuration is printed (-s)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import _beam_steps, _spectra

from clsim_tpu.hits.acceptance import dom_angular_sensitivity as ang_j
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.propagate import engine as EJ
from clsim_tpu.tabulator import axes as AXJ
from clsim_tpu.tabulator import fits as FJ
from clsim_tpu.tabulator import table as TJ
from clsim_tpu.types import PropagationConfig as CfgJ
from clsim_tpu.types import StepBatch as StepsJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.hits.acceptance import dom_angular_sensitivity as ang_t
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.ops import rng as R
from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                          stack_spectra)
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.tabulator import axes as AXT
from clsim_tpu_torch.tabulator import fits as FT
from clsim_tpu_torch.tabulator import table as TT
from clsim_tpu_torch.types import PropagationConfig as CfgT
from clsim_tpu_torch.types import StepBatch as StepsT
from clsim_tpu_torch.validate import table_referee as REF

torch.set_num_threads(1)

L1_TOL = 2e-3
SLOTS = 64
SEG = 10.0          # max_segment_m: 12 sub-steps a segment


def axes_pair(kind, specs):
    """The same axes in both packages from (min, max, n_bins, power)."""
    cls = {"spherical": "SphericalAxes", "cylindrical": "CylindricalAxes"}
    return (getattr(AXJ, cls[kind])([AXJ.Axis(*s) for s in specs]),
            getattr(AXT, cls[kind])([AXT.Axis(*s) for s in specs]))


SPH = [(0.0, 200.0, 12, 2), (0.0, 180.0, 6, 1), (-1.0, 1.0, 10, 1),
       (0.0, 2000.0, 12, 2)]
CYL = [(0.0, 200.0, 12, 2), (0.0, np.pi, 6, 1), (-200.0, 200.0, 10, 1),
       (0.0, 2000.0, 12, 2)]
IMP = [(0.0, 200.0, 10, 2), (0.0, 180.0, 4, 1), (-1.0, 1.0, 6, 1),
       (0.0, 2000.0, 10, 2), (-1.0, 1.0, 8, 1)]
# tests/test_tabulator.py's three tables, shrunk: (axes kind, specs,
# photons per slot, seed, step batches); the spherical one in two batches
# of 2 photons a slot, so that batch 1's key fold_in(key, 1) is held too
CONFIGS = {"spherical": ("spherical", SPH, 2, 5, 2),
           "cylindrical": ("cylindrical", CYL, 4, 5, 1),
           "impact": ("spherical", IMP, 4, 7, 1)}


def source_pair():
    args = (0.0, 0.0, 0.0, 0.0, np.pi / 2, np.pi)     # along +x
    return TJ.make_reference_source(*args), TT.make_reference_source(
        *args, device="cpu")


def inputs(photons, seg=SEG):
    medium = ice_j(b400=0.005, a_dust400=0.01)
    cfg = CfgJ(n_slots=SLOTS, max_segment_m=seg, max_layer_steps=6)
    steps = _beam_steps(SLOTS, photons, direction=(1.0, 0.0, 0.0))
    port = (C.medium_from_numpy(C.numpy_tree(medium), device="cpu"),
            C.spectra_from_numpy(C.numpy_tree(_spectra()), device="cpu"),
            C.steps_from_numpy(C.numpy_tree(steps), device="cpu"),
            CfgT(**dataclasses.asdict(cfg)))
    return (medium, _spectra(), steps, cfg), port


# --- axes ------------------------------------------------------------------

AXES_CASES = {"spherical": lambda m: m.default_spherical_axes(),
              "cylindrical": lambda m: m.default_cylindrical_axes(),
              "spherical_impact": lambda m: m.default_spherical_axes(
                  n_impact=20),
              "cylindrical_impact": lambda m: m.default_cylindrical_axes(
                  n_impact=12)}


def seeded_values(axis, rng, n=20000):
    """Values across and beyond the axis, its float32 edges and their
    neighbours, huge values and subnormals."""
    span = axis.max - axis.min
    v = rng.uniform(axis.min - 0.1 * span, axis.max + 0.1 * span,
                    n).astype(np.float32)
    e = axis.bin_edges().astype(np.float32)
    return np.concatenate([
        v, e, np.nextafter(e, np.float32(np.inf)),
        np.nextafter(e, np.float32(-np.inf)),
        np.float32([1e30, -1e30, 1e-45, -1e-45, -3e-38, 0.0, -0.0])])


@pytest.mark.parametrize("case", sorted(AXES_CASES))
def test_axes_integers_and_edges_match(case):
    aj, at = AXES_CASES[case](AXJ), AXES_CASES[case](AXT)
    assert at.shape == aj.shape and at.strides == aj.strides
    assert at.n_bins == aj.n_bins and at.kind == aj.kind
    rng = np.random.default_rng(11)
    for a_j, a_t in zip(aj.axes, at.axes):
        np.testing.assert_array_equal(a_t.bin_edges(), a_j.bin_edges())
        v = seeded_values(a_j, rng)
        np.testing.assert_array_equal(
            a_t.bin_index(torch.as_tensor(v)).numpy(),
            np.asarray(a_j.bin_index(jnp.asarray(v))), err_msg=str(a_j))
    np.testing.assert_array_equal(at.bin_volumes(), aj.bin_volumes())
    coords = [seeded_values(a, rng)[:20000] for a in aj.axes]
    for c in coords:
        rng.shuffle(c)
    flat_j = np.asarray(aj.flat_index([jnp.asarray(c) for c in coords]))
    flat_t = at.flat_index([torch.as_tensor(c) for c in coords]).numpy()
    np.testing.assert_array_equal(flat_t, flat_j)
    assert flat_t.min() >= 0 and flat_t.max() < at.n_bins
    np.testing.assert_array_equal(
        at.out_of_bounds([torch.as_tensor(c) for c in coords]).numpy(),
        np.asarray(aj.out_of_bounds([jnp.asarray(c) for c in coords])))


# --- coordinates -----------------------------------------------------------

@pytest.mark.parametrize("kind,impact", [("spherical", False),
                                         ("spherical", True),
                                         ("cylindrical", False),
                                         ("cylindrical", True)])
def test_coordinates_match(kind, impact):
    r = np.random.default_rng(23)
    p = r.uniform(-300, 300, (4, 5000)).astype(np.float32)
    p[:3, :3] = np.float32([[3.0], [-2.0], [1.0]])   # at the source itself
    d = r.standard_normal((3, 5000))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    u = r.random((2, 5000)).astype(np.float32)
    src_j = TJ.make_reference_source(3.0, -2.0, 1.0, 5.0, 1.1, 0.4)
    src_t = TT.make_reference_source(3.0, -2.0, 1.0, 5.0, 1.1, 0.4,
                                     device="cpu")
    for f in ("pos", "time", "dir", "perp"):
        np.testing.assert_array_equal(getattr(src_t, f).numpy(),
                                      np.asarray(getattr(src_j, f)))
    dirp_j = dirp_t = None
    if impact:
        dirp_j = TJ._impact_direction(*map(jnp.asarray, d), *map(
            jnp.asarray, u))
        dirp_t = TT._impact_direction(*map(torch.as_tensor, d), *map(
            torch.as_tensor, u))
        for a, b in zip(dirp_t, dirp_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    pj, pt = list(map(jnp.asarray, p)), list(map(torch.as_tensor, p))
    if kind == "spherical":
        cj = TJ._spherical_coords(*pj, src_j, jnp.float32(4.42), dirp_j)
        ct = TT._spherical_coords(*pt, src_t, 4.42, dirp_t)
    else:
        cj = TJ._cylindrical_coords(*pj, src_j, jnp.float32(4.42),
                                    jnp.float32(0.85), dirp_j)
        ct = TT._cylindrical_coords(*pt, src_t, 4.42, 0.85, dirp_t)
    assert len(ct) == len(cj) == 4 + impact
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


# --- random numbers --------------------------------------------------------

def test_batched_threefry_matches_jax_random():
    """The tabulator's chunk draws: fold_in of a range of iterations, the
    (9, N) blocks and the impact keys folded by 0x1A7B, as jax.random."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    kt = R.fold_in(R.base_key(5), 2)
    assert kt.tolist() == np.asarray(key).tolist()
    keys = R.fold_in(kt, torch.arange(32, 36))
    blocks = R.uniforms(keys, (50,), 9)
    for j, i in enumerate(range(32, 36)):
        kj = jax.random.fold_in(key, i)
        assert keys[j].tolist() == np.asarray(kj).tolist()
        np.testing.assert_array_equal(
            blocks[j].numpy(), np.asarray(jax.random.uniform(kj, (9, 50))))
        sub = R.fold_in(keys[j], TT.IMPACT_SALT)
        sj = jax.random.fold_in(kj, 0x1A7B)
        assert sub.tolist() == np.asarray(sj).tolist()
        ui = R.uniforms(R.fold_in(sub, torch.arange(3)), (50,), 2)
        for m in range(3):
            np.testing.assert_array_equal(ui[m].numpy(), np.asarray(
                jax.random.uniform(jax.random.fold_in(sj, m), (2, 50))))


# --- one chunk, entry by entry ---------------------------------------------

def test_chunk_matches_jax_chunk():
    """Two 16-iteration chunks of the spherical configuration through the
    JAX package's raw chunk and the port's: the comb's bins and weights,
    the state and, under the fixed horizon, the depth so far: the JAX
    state's abs_lens_initial - abs_lens_left against the port's
    horizon - abs_left (its SlotState keeps no initial budget)."""
    (medium, spectra, steps, cfg), (mt, st, stp, cfgt) = inputs(4)
    aj, at = axes_pair("spherical", SPH)
    src_j, src_t = source_pair()
    cfg = dataclasses.replace(cfg, fixed_abs_lens=46.0,
                              stop_on_detection=False)
    cfgt = dataclasses.replace(cfgt, fixed_abs_lens=46.0,
                               stop_on_detection=False)
    chunk_j = TJ._make_tabulate_chunk(medium, spectra, src_j, ang_j(), cfg,
                                      aj, 1.0, jnp.float32(4.42),
                                      jnp.float32(0.85))
    chunk_t = TT._make_tabulate_chunk(mt, st, src_t, ang_t(device="cpu"),
                                      cfgt, at, 1.0, 4.42, 0.85)
    kj = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    kt = R.fold_in(R.base_key(5), 0)
    sj = EJ._init_state(StepsJ(*[jnp.asarray(f) for f in steps]))
    st_t = ET._init_state(stp)
    rj, rt = jnp.zeros(SLOTS, jnp.float32), torch.zeros(SLOTS)
    b = StepsJ(*[jnp.asarray(f) for f in steps])
    moved = 0
    for c in range(2):
        sj, rj, ij, wj, aj_ = chunk_j.raw(b, kj, sj, rj, jnp.int32(16 * c))
        st_t, rt, it, wt, at_ = chunk_t(stp, kt, st_t, rt, 16 * c)
        ij, wj = np.asarray(ij), np.asarray(wj)
        assert it.shape == ij.shape and wt.shape == wj.shape
        assert int(at_) == int(aj_)
        same = it.numpy() == ij
        moved += int((~same).sum())
        np.testing.assert_allclose(wt.numpy(), wj, atol=1e-5, rtol=1e-4)
        assert (wj != 0).sum() > 1000
        np.testing.assert_allclose(
            TT.E.horizon(cfgt) - st_t.abs_left.numpy(),
            np.asarray(sj.abs_lens_initial - sj.abs_lens_left), atol=1e-5)
        np.testing.assert_array_equal(st_t.in_flight.numpy() > 0.5,
                                      np.asarray(sj.in_flight))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
        for f in ("x", "y", "z", "dx", "dy", "dz"):
            np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                       np.asarray(getattr(sj, f)),
                                       atol=2e-3, rtol=1e-4, err_msg=f)
    # float rounding moves a handful of entries across a bin edge
    assert moved <= 1e-3 * it.numel() * 2, moved



def test_capped_batch_is_the_first_chunks_of_tabulate():
    """_table_plan is tabulate's iteration: a batch run to its end through
    it fills tabulate's raw table bit for bit, and max_iterations cuts the
    same run after its first launches (a prefix of its deposits)."""
    _, (mt, st, stp, cfgt) = inputs(2)
    _, at = axes_pair("spherical", SPH)
    _, src = source_pair()
    tally = {}
    TT.tabulate([stp], mt, st, src, seed=3, axes=at, cfg=cfgt, tally=tally)
    plan, n_group, n_phase = TT._table_plan(mt, st, src, at, None, cfgt,
                                            1.0, 46.0)
    key = R.fold_in(R.base_key(3), 0)
    full = torch.zeros(at.n_bins, dtype=torch.float64)
    assert TT._tabulate_batch(plan, stp, key, full) == tally["iterations"]
    assert torch.equal(full, tally["raw"])
    cut = torch.zeros(at.n_bins, dtype=torch.float64)
    assert TT._tabulate_batch(plan, stp, key, cut,
                              max_iterations=TT.CHUNK_ITERS) \
        == TT.CHUNK_ITERS < tally["iterations"]
    assert 0 < float(cut.sum()) < float(full.sum())
    assert bool((cut <= full + 1e-9).all())
    assert 1.0 < n_phase and 1.0 < n_group

# --- whole tables on the same seed -----------------------------------------

@pytest.fixture(scope="module", params=sorted(CONFIGS))
def tables(request):
    """(name, JAX table, port table, port tally) of one configuration."""
    kind, specs, photons, seed, batches = CONFIGS[request.param]
    (medium, spectra, steps, cfg), (mt, st, stp, cfgt) = inputs(photons)
    aj, at = axes_pair(kind, specs)
    src_j, src_t = source_pair()
    tj = TJ.tabulate([steps] * batches, medium, spectra, src_j, seed=seed,
                     axes=aj, cfg=cfg)
    tally = {}
    tt = TT.tabulate([stp] * batches, mt, st, src_t, seed=seed, axes=at,
                     cfg=cfgt, tally=tally)
    return request.param, tj, tt, tally


def test_tabulate_matches_jax_tabulate(tables):
    name, tj, tt, tally = tables
    assert tt.values.shape == tj.values.shape
    kind, specs, photons, seed, batches = CONFIGS[name]
    assert tt.n_photons == tj.n_photons == SLOTS * photons * batches
    assert tt.header.keys() == tj.header.keys()
    for k, v in tj.header.items():
        assert tt.header[k] == v, k
    vj, vt = np.asarray(tj.values, np.float64), tt.values
    l1 = np.abs(vt - vj).sum() / np.abs(vj).sum()
    print(f"{name}: table L1 {l1:.3e} of the total")
    assert l1 <= L1_TOL
    # every comb weight landed in the table, in as many syncs as chunks
    raw = tally["raw"]
    assert raw.dtype == torch.float64 and raw.device.type == "cpu"
    np.testing.assert_allclose(float(raw.sum()), float(tally["weight"]),
                               rtol=1e-12)
    assert tally["syncs"] * TT.CHUNK_ITERS == tally["iterations"]
    assert tally["iterations"] >= batches * TT.CHUNK_ITERS
    # each filled bin took at least one nonzero entry
    assert tally["entries"] >= int((raw != 0).sum()) > 0


def test_tabulate_physics(tables):
    """tests/test_tabulator.py's assertions on the port's tables."""
    name, _, tt, _ = tables
    vals = tt.values
    assert np.isfinite(vals).all() and vals.sum() > 0
    if name == "spherical":
        # direct light along the source axis, residual time near zero
        assert vals[:, :, -2, :].sum() > 10 * vals[:, :, 1, :].sum()
        t_profile = vals[1:-1, :, -2, 1:-1].sum(axis=(0, 1))
        assert t_profile.argmax() == 0
    elif name == "cylindrical":
        rho_profile = vals[1:-1, :, 1:-1, 1:-1].sum(axis=(1, 2, 3))
        assert rho_profile.argmax() < 5
        t_profile = vals[1:-1, :, 1:-1, 1:-1].sum(axis=(0, 1, 2))
        assert t_profile.argmax() <= 3
        assert t_profile[:5].sum() > 10 * t_profile[10:].sum()
    else:
        prof = vals[1:-1, :, 1:-1, 1:-1, 1:-1].sum(axis=(0, 1, 2, 3))
        centers = 0.5 * (np.linspace(-1, 1, 9)[:-1]
                         + np.linspace(-1, 1, 9)[1:])
        assert (prof * centers).sum() / prof.sum() > 0.4
        assert prof[-1] > prof[0]
        # the acceptance weight is absent with the 5th axis
        _, (mt, st, stp, cfgt) = inputs(CONFIGS[name][2])
        _, at4 = axes_pair("spherical", IMP[:4])
        t4 = TT.tabulate([stp], mt, st, source_pair()[1], seed=7, axes=at4,
                         cfg=cfgt)
        vol = at4.bin_volumes()
        area = np.pi * t4.header["dom_radius"] ** 2
        r4 = t4.values[1:-1, 1:-1, 1:-1] * (vol / area)[..., None]
        r5 = vals[1:-1, 1:-1, 1:-1] * (vol / area)[..., None, None]
        assert r5.sum() > 1.2 * r4.sum()


# --- files -----------------------------------------------------------------

def test_fits_bytes_equal_and_npz_round_trip(tmp_path):
    """A port table written by both packages' FITS writers: the same bytes;
    read back by the port; and its npz round trip."""
    _, (mt, st, stp, cfgt) = inputs(2)
    _, at = axes_pair("spherical", [(0, 100, 10, 2), (0, 180, 4, 1),
                                    (-1, 1, 5, 1), (0, 1000, 10, 2)])
    tt = TT.tabulate([stp], mt, st, source_pair()[1], seed=1, axes=at,
                     cfg=cfgt)
    FJ.save_table_fits(tt, str(tmp_path / "j.fits"))
    FT.save_table_fits(tt, str(tmp_path / "t.fits"))
    raw = (tmp_path / "t.fits").read_bytes()
    assert raw == (tmp_path / "j.fits").read_bytes()
    assert len(raw) % 2880 == 0 and raw[:6] == b"SIMPLE"
    errs = np.abs(tt.values).astype(np.float32)
    FJ.write_fits(str(tmp_path / "je.fits"), tt.values, [np.arange(3.0)],
                  {"a": 1, "b": 2.5}, errors=errs)
    FT.write_fits(str(tmp_path / "te.fits"), tt.values, [np.arange(3.0)],
                  {"a": 1, "b": 2.5}, errors=errs)
    assert (tmp_path / "te.fits").read_bytes() == \
        (tmp_path / "je.fits").read_bytes()
    vals, edges, header, errors = FT.read_fits(str(tmp_path / "t.fits"))
    np.testing.assert_array_equal(vals, tt.values.astype(np.float32))
    for e, a in zip(edges, tt.axes.axes):
        np.testing.assert_array_equal(e, a.bin_edges())
    assert header["n_photons"] == tt.header["n_photons"] and errors is None
    TT.save_table_npz(tt, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz") as z:
        np.testing.assert_array_equal(z["values"], tt.values)
        np.testing.assert_array_equal(z["edges_0"],
                                      tt.axes.axes[0].bin_edges())
        assert float(z["header_seed"]) == tt.header["seed"]


# --- the analytic radial referee -------------------------------------------

def isotropic_steps(n, photons, seed):
    """Isotropic 1 mm Cherenkov steps at the origin (scripts/
    bench_tabulator.py's workload), fresh directions per seed."""
    r = np.random.default_rng(seed)
    cz = r.uniform(-1, 1, n)
    sz = np.sqrt(1 - cz ** 2)
    phi = r.uniform(0, 2 * np.pi, n)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return StepsT(x=f(np.zeros(n)), y=f(np.zeros(n)), z=f(np.zeros(n)),
                  t=f(np.zeros(n)), dir_x=f(sz * np.cos(phi)),
                  dir_y=f(sz * np.sin(phi)), dir_z=f(cz),
                  length=f(np.full(n, 1e-3)), beta=f(np.ones(n)),
                  num_photons=torch.full((n,), photons, dtype=torch.int32),
                  weight=f(np.ones(n)),
                  identifier=torch.zeros(n, dtype=torch.int32),
                  source_type=torch.zeros(n, dtype=torch.int32))


def test_radial_shells_match_the_analytic_expectation():
    """Scattering off, isotropic emission: the unnormalized radial shells
    of 8 independent runs (fresh step directions and seed each) against
    validate/table_referee's float64 expectation, |z| < 5."""
    n, photons, runs = 256, 8, 8
    medium = ice_t(n_layers=171, z_start=-855.0, layer_height=10.0,
                   b400=1e-9, device="cpu")
    ref = make_cherenkov_spectrum(medium.ref_index, medium.min_wlen,
                                  medium.max_wlen)
    spectra = stack_spectra([ref], device="cpu")
    axes = AXT.SphericalAxes([AXT.Axis(0.0, 60.0, 30, 2),
                              AXT.Axis(0.0, 180.0, 4),
                              AXT.Axis(-1.0, 1.0, 4),
                              AXT.Axis(0.0, 7000.0, 4, 2)])
    cfg = CfgT(n_slots=n, max_segment_m=SEG, max_layer_steps=4)
    src = TT.make_reference_source(0.0, 0.0, 0.0, 0.0, np.pi / 2, 0.0,
                                   device="cpu")
    groups = [(6, 12), (12, 18), (18, 24), (24, 30)]
    shells = []
    for k in range(runs):
        tally = {}
        TT.tabulate([isotropic_steps(n, photons, 100 + k)], medium, spectra,
                    src, seed=k, axes=axes, cfg=cfg, tally=tally)
        shells.append(REF.radial_shells(tally["raw"], axes.shape, groups))
    edges = axes.axes[0].bin_edges()
    per_bin = REF.radial_expectation(medium, spectra,
                                     ang_t(device="cpu"), edges,
                                     n * photons)
    expected = np.array([per_bin[lo:hi].sum() for lo, hi in groups])
    z = REF.radial_z(shells, expected)
    print("radial z", z)
    assert np.all(np.abs(z) < 5.0), z
