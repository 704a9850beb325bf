"""The global collision plans (K1 B3) of the port against clsim_tpu: the plan
and cell table of IceCube with DeepCore (bench.py's layout) at the default
90 m segment cap, the kernel's table layouts rebuilt from the JAX package's
tables, the plain version against the JAX Pallas kernel in interpret mode on
four geometries that SubPlans refuse (tolerances of
tests/test_kernel.py::_compare), records on a surveyed geometry, the spec
gate, and the SubPlan fallback counter and warning."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import bench
import test_kernel as TK
from test_torch_engine import compare, port_inputs
from test_torch_records import REC_TOLS

from clsim_tpu.geometry import build_geometry as build_j
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.propagate import kernel as KJ
from clsim_tpu.types import PropagationConfig as CfgJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig as CfgT

torch.set_num_threads(1)


def quiet(fn, *a, **kw):
    """Call fn with the SubPlan fallback warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def rebuild(geo, xs=None, ys=None, zs=None):
    """A JAX-package geometry rebuilt from (moved) DOM positions."""
    return build_j(np.asarray(geo.dom_string_id), np.asarray(geo.dom_om_id),
                   np.asarray(geo.dom_x) if xs is None else xs,
                   np.asarray(geo.dom_y) if ys is None else ys,
                   np.asarray(geo.dom_z) if zs is None else zs,
                   oversize=geo.oversize)


def two_ladders(geo0):
    """tests/test_kernel.py::test_kernel_nonuniform_z_geometry's geometry:
    the workload's 7 strings, string 0 with a denser shifted ladder."""
    sx, sy = np.asarray(geo0.string_x), np.asarray(geo0.string_y)
    sids, oids, xs, ys, zs = [], [], [], [], []
    for si in range(len(sx)):
        nd, dz, z0 = (16, 10.0, 60.0) if si == 0 else (12, 15.0, 80.0)
        for d in range(nd):
            sids.append(si); oids.append(d); xs.append(float(sx[si]))
            ys.append(float(sy[si])); zs.append(z0 - d * dz)
    return build_j(sids, oids, xs, ys, zs, oversize=8.0)


def five_groups(geo0):
    """tests/test_kernel.py::test_subplan_fallback_warns_and_counts's five
    (z0, dz, nd) groups (> the 4-SubPlan budget)."""
    sids, oids, xs, ys, zs = [], [], [], [], []
    for si in range(5):
        for d in range(6 + si):
            sids.append(si); oids.append(d); xs.append(200.0 * si)
            ys.append(0.0); zs.append(50.0 + 5.0 * si - d * (10.0 + si))
    return build_j(sids, oids, xs, ys, zs, oversize=8.0)


def one_dom_moved(geo0):
    """tests/test_kernel.py::test_affine_plan_gates's geo2: one DOM residual
    0.5 m off the ladder."""
    rel = np.asarray(geo0.string_dom_rel).copy()
    rel[0, 0, 0] = 0.5
    return geo0._replace(string_dom_rel=rel)


def jittered(geo0, sigma=0.1, seed=11):
    """Every DOM moved by a seeded Gaussian of sigma in x, y and z: the
    surveyed positions of a real detector are never on an exact ladder."""
    j = np.random.default_rng(seed).normal(0.0, sigma, (3, geo0.n_doms))
    return rebuild(geo0, np.asarray(geo0.dom_x) + j[0],
                   np.asarray(geo0.dom_y) + j[1],
                   np.asarray(geo0.dom_z) + j[2])


GEOMETRIES = {"two_ladders": (two_ladders, KT.COLL_AFFINE),
              "five_groups": (five_groups, KT.COLL_AFFINE),
              "one_dom_moved": (one_dom_moved, KT.COLL_GENERAL),
              "jittered": (jittered, KT.COLL_GENERAL)}


def workload(name, seed=7, **cfg_kw):
    medium, geo0, spectra, cfg, steps, u = TK._workload(seed=seed)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    return medium, GEOMETRIES[name][0](geo0), spectra, cfg, steps, u


def port_spec(inputs):
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    spec, cell_tab = quiet(KT.fused_spec, medium, geo, spectra, cfg, TK.N,
                           TK.T)
    return spec, KT.build_tables(spec, medium, geo, spectra, cell_tab), (
        steps, u)


def test_plan_collision_ic86_matches_jax():
    """IceCube with DeepCore at the default configuration: SubPlans are
    refused (parity budget), and the global plan, its cell table and the
    spec's global fields equal the JAX package's."""
    geo_j = bench.icecube86_geometry()
    geo_t = C.geometry_from_numpy(C.numpy_tree(geo_j), device="cpu")
    cell_j, plan_j = quiet(KJ.plan_collision, geo_j, CfgJ())
    cell_t, plan_t = quiet(KT.plan_collision, geo_t, CfgT())
    np.testing.assert_array_equal(cell_j, cell_t)
    assert plan_j == plan_t and "sub_plans" not in plan_t
    medium_j = ice_j(n_layers=171, z_start=-855.0, layer_height=10.0)
    spectra_j = stack_spectra([make_cherenkov_spectrum(
        medium_j.ref_index, 265.0, 675.0)])
    spec_j = quiet(KJ._build_spec, medium_j, geo_j, spectra_j, CfgJ(), 1024,
                   16, 1, 32, 1024, 2, True, True, plan=plan_j)
    spec_t, _ = quiet(KT.fused_spec,
                      C.medium_from_numpy(C.numpy_tree(medium_j), "cpu"),
                      geo_t, C.spectra_from_numpy(C.numpy_tree(spectra_j),
                                                  "cpu"), CfgT(), 1024, 16)
    for f in ("affine_doms", "n_dom_cand", "K_cand", "n_cull_cells",
              "cell_x0", "cell_y0", "inv_cell", "cell_nx", "cell_ny",
              "n_string_rounds"):
        assert getattr(spec_t, f) == getattr(spec_j, f), f
    # the JAX package's uniform-z specialisation is not reached: the port's
    # per-candidate ladder serves every affine geometry
    assert spec_t.affine_doms and not spec_j.uniform_z
    assert KT.kernel_coll(spec_t) == KT.COLL_AFFINE
    assert KT.spec_unsupported(spec_t) is None


def test_global_table_layouts():
    """The global plan's tables rebuilt from the JAX package's: the card
    table's per-string rows (card_cull_table: (minz, maxz, z0, dzf), then
    (nd, dom offset, float32(1 / dzf), the string's z-window half-width))
    and every cull entry (sx, sy, maxr2) of a string equal to the values
    of each candidate of the JAX package's feature-major cell table, every
    string in some list; and the DOM residual and per-string tables equal
    to the rows the JAX package's _build_tables builds
    (kernel.py:2294-2306)."""
    medium, geo, spectra, cfg, steps, u = workload("jittered")
    spec, tables, _ = port_spec((medium, geo, spectra, cfg, steps, u))
    assert KT.kernel_coll(spec) == KT.COLL_GENERAL
    cell_j, plan_j = quiet(KJ.plan_collision, geo, cfg)
    K, nc = spec.K_cand, spec.n_cull_cells
    half, _ = KT.general_window(geo, spec.cfg)
    rows, sc = tables.cells.numpy(), tables.scalars
    n_str, ent = sc["c_lad"], rows[sc["c_ent"]:]
    blk = cell_j[:10 * K, :nc].reshape(10, K, nc)
    assert n_str == int(blk[9].max()) + 1
    for k, c in zip(*np.nonzero(blk[9] >= 0)):
        v = blk[:, k, c]
        s = int(v[9])
        np.testing.assert_array_equal(rows[s], v[4:8])
        np.testing.assert_array_equal(rows[n_str + s], [
            v[8], v[3], np.float32(1.0 / np.float64(v[7])), half[s]])
        mine = ent[ent[:, 3] == s, :3]
        assert mine.shape[0] > 0
        np.testing.assert_array_equal(mine, np.broadcast_to(v[:3],
                                                            mine.shape))
    spec_j = quiet(KJ._build_spec, medium, geo, spectra, cfg, TK.N, TK.T, 1,
                   32, 1024, 2, True, True, plan=plan_j)
    rel_j = np.asarray(quiet(KJ._build_tables, spec_j, medium, geo, spectra,
                             cfg)[-1])
    S, M, _ = np.asarray(geo.string_dom_rel).shape
    Mp = spec_j.Mpad
    rel_t, str_t = tables.rel.numpy(), tables.strings.numpy()
    assert rel_t.shape == (S, M, 4) and str_t.shape == (S, 4)
    for ch in range(4):
        np.testing.assert_array_equal(rel_t[:, :, ch],
                                      rel_j[ch * Mp:ch * Mp + M, :S].T)
        np.testing.assert_array_equal(str_t[:, ch], rel_j[4 * Mp + ch, :S])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_version_matches_jax_interpret_kernel(name):
    inputs = workload(name)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    spec, tables, (steps, u) = port_spec(inputs)
    assert not spec.sub_plans
    assert KT.kernel_coll(spec) == GEOMETRIES[name][1]
    assert KT.spec_unsupported(spec) is None
    res_j, tot_j = quiet(TK._run_kernel, steps_j, medium_j, geo_j, spectra_j,
                         cfg_j, u_j)
    state, hist, cnt = KT.run_fused_iterations(
        KT.init_state(steps), KT.pack_steps(steps), tables, spec, uniforms=u)
    compare(tot_j[KJ.CNT_GEN], tot_j[KJ.CNT_HITS], res_j.hist,
            cnt[KT.CNT_GEN], cnt[KT.CNT_HITS], hist)
    assert float(cnt[KT.CNT_DROPPED]) == 0.0
    np.testing.assert_allclose(float(hist.double().sum()),
                               float(cnt[KT.CNT_WSUM]), rtol=1e-5)
    # the bound's counts: candidates of the cells' lists >= cull passes >=
    # strings tested (at most n_string_rounds per live slot-iteration);
    # n_dom_cand DOMs a string on the affine path, its valid rows (<= M)
    # on the general one; no water scatters
    n = {k: float(cnt[getattr(KT, "CNT_" + k.upper())]) for k in KT.TALLIES}
    assert spec.K_cand * float(cnt[KT.CNT_WORK]) >= n["cand"] >= n["cull"] \
        >= n["tested"] > 0
    assert n["tested"] <= spec.n_string_rounds * float(cnt[KT.CNT_WORK])
    if spec.affine_doms:
        assert n["rows"] == spec.n_dom_cand * n["tested"]
    else:
        assert 0 < n["rows"] <= tables.rel.shape[1] * n["tested"]
    assert n["scat"] == n["rayleigh"] == 0


def test_plain_records_on_surveyed_geometry_match_jax():
    """The record mode on the jittered geometry (general path): the flat
    records equal the JAX kernel's record by record, sorted by (dom, time),
    within tests/test_kernel.py:523-529's tolerances."""
    inputs = workload("jittered", save_photons=True)
    medium, geo, spectra, cfg, steps, u = inputs
    res_j, _ = quiet(TK._run_kernel, steps, medium, geo, spectra, cfg, u)
    st, md, gt, sp, cf, ut = port_inputs(*inputs)
    res_t, tot_t = quiet(KT.propagate_fused, st, md, gt, sp, 0, cf,
                         iters_per_call=TK.T, max_calls=1, uniforms=ut)
    n = int(res_t.rec_count[0])
    assert n == int(res_j.rec_count[0]) == float(tot_t[KT.CNT_HITS]) > 20
    fj = {k: np.asarray(v)[0] for k, v in res_j.rec.items()}
    ft = {k: v[0].numpy() for k, v in res_t.rec.items()}
    oj = np.lexsort((fj["time"], fj["dom"]))
    ot = np.lexsort((ft["time"], ft["dom"]))
    for key, tol in REC_TOLS:
        np.testing.assert_allclose(ft[key][ot], fj[key][oj], atol=tol,
                                   rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("change,dep", [
    (dict(estimator="expected"), KT.DEP_EXPECTED),
    (dict(stop_on_detection=False), KT.DEP_PASS),
    (dict(fixed_abs_lens=8.0), KT.DEP_STOP | KT.MODE_FIXED)])
def test_spec_gate_refuses_deposit_modes_on_global_plans(change, dep):
    """The global plans serve every deposit mode (K1·B3/B7 × B6/B8b), each
    in its own instantiation of the general plan; what the gate refuses
    there is what it refuses everywhere: records with a B6 deposit mode
    (as the JAX package does, clsim_tpu/propagate/kernel.py:1830-1834)."""
    inputs = workload("jittered")
    spec, tables, (steps, u) = port_spec(inputs)
    assert KT.spec_unsupported(spec) is None
    rec = spec._replace(records=True)
    assert KT.spec_unsupported(rec) is None
    assert KT.kernel_mode(rec) == (KT.MODE_RECORDS
                                   | KT.COLL_GENERAL << KT.COLL_SHIFT)
    medium, geo, spectra, cfg, _, _ = inputs
    mode_spec, _, _ = port_spec((medium, geo, spectra,
                                 dataclasses.replace(cfg, **change),
                                 inputs[4], u))
    assert KT.spec_unsupported(mode_spec) is None
    assert KT.kernel_mode(mode_spec) == dep | KT.COLL_GENERAL << KT.COLL_SHIFT
    bad = mode_spec._replace(records=True)
    assert "records" in KT.spec_unsupported(bad)
    assert KT.spec_unsupported(mode_spec._replace(
        threefry=True, expected=False)) is None
    with pytest.raises(NotImplementedError, match="records"):
        KT._launch(KT.init_state(steps, True), KT.pack_steps(steps), tables,
                   bad, u, 0, 0, None)


def test_subplan_fallback_counts_and_warns_only_for_refused_splits():
    """Divergence from the JAX package (clsim_tpu/propagate/kernel.py:1956
    warns for every geometry without SubPlans): the port counts every
    fallback in SUBPLAN_FALLBACKS but warns only where a split was possible
    and a budget refused it on a geometry of >= 20 strings.  The 7-string
    two-ladder geometry (parity budget) and a surveyed geometry warn in the
    JAX package and not in the port; IceCube with DeepCore at the default
    configuration warns in both."""
    _, geo0, _, cfg_j, _, _ = TK._workload()
    cfg_t = CfgT(**dataclasses.asdict(cfg_j))
    ic86 = bench.icecube86_geometry()
    for geo_j, port_warns, budget in ((two_ladders(geo0), False, True),
                                      (jittered(geo0), False, False),
                                      (ic86, True, True)):
        cfg = cfg_j if geo_j is not ic86 else CfgJ()
        geo_t = C.geometry_from_numpy(C.numpy_tree(geo_j), device="cpu")
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            KJ.plan_collision(geo_j, cfg)
        before = KT.SUBPLAN_FALLBACKS["count"]
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            KT.plan_collision(geo_t, cfg_t if geo_j is not ic86 else CfgT())
        assert KT.SUBPLAN_FALLBACKS["count"] == before + 1
        assert KT.SUBPLAN_FALLBACKS["reason"] == KJ.SUBPLAN_FALLBACKS["reason"]
        said = lambda w: any("global collision plan" in str(x.message)
                             for x in w)
        assert said(wj)
        assert said(wt) == port_warns
        # the refusal's kind, not its wording, decides: a budget refused
        # the affine geometries, the surveyed one allows no split
        assert KT._subdet_plans(geo_t, cfg_t if geo_j is not ic86
                                else CfgT())[2] == budget
