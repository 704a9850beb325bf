"""Photon records in clsim_tpu_torch against clsim_tpu on the same inputs:
the engine's record rings against the JAX engine's (records mode, SAVE_ALL
absorption points, prescale; tests/test_engine.py:228, :335, :355), the
kernel's plain version's flat records against the JAX Pallas kernel in
interpret mode (tests/test_kernel.py:490-533, :578-624), and the record
buffer's stall rule.  Every comparison drives both packages with the same
(T, 8, N) uniform stream; tolerances are stated per test."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_kernel as TK
from test_engine import _beam_steps, _one_dom_geometry, _spectra
from test_torch_engine import port_inputs

from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.propagate import engine as EJ
from clsim_tpu.types import PropagationConfig

from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT

torch.set_num_threads(1)

# tests/test_kernel.py:523-529: (field, absolute tolerance), rtol 1e-3
REC_TOLS = [("dom", 1e-6), ("time", 1e-2), ("wavelength", 1e-2),
            ("weight", 1e-3), ("pos_x", 2e-2), ("pos_y", 2e-2),
            ("pos_z", 2e-2), ("start_x", 2e-2), ("start_time", 1e-2),
            ("num_scatters", 1e-6), ("dir_theta", 1e-3), ("dir_phi", 1e-3),
            ("group_velocity", 2e-4), ("cherenkov_dist", 0.1),
            ("dist_in_abs_lens", 2e-2), ("start_theta", 1e-3)]


def run_both_engines(inputs):
    """The JAX engine (jitted, uniforms=) and the port's engine on the same
    inputs and stream; returns (jax result, port result)."""
    medium, geo, spectra, cfg, steps, u = inputs
    res_j = EJ.propagate(steps, medium, geo, spectra,
                         jnp.asarray([0, 1], jnp.uint32), cfg,
                         uniforms=jnp.asarray(u))
    steps_t, medium_t, geo_t, spectra_t, cfg_t, u_t = port_inputs(*inputs)
    res_t = ET.propagate(steps_t, medium_t, geo_t, spectra_t, 0, cfg_t,
                         uniforms=u_t)
    return res_j, res_t


def assert_rings_match(res_j, res_t, cap):
    """Same records per slot (the shared stream makes the two engines take
    the same decisions), and ring entries within REC_TOLS, slot by slot."""
    cnt_j = np.asarray(res_j.rec_count)
    cnt_t = res_t.rec_count.numpy()
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert cnt_t.sum() > 20, "workload recorded too few photons"
    valid = np.arange(cap)[None, :] < np.minimum(cnt_t, cap)[:, None]
    for key, tol in REC_TOLS + [("identifier", 0.0), ("start_y", 2e-2),
                                ("start_z", 2e-2), ("start_phi", 1e-3)]:
        np.testing.assert_allclose(res_t.rec[key].numpy()[valid],
                                   np.asarray(res_j.rec[key])[valid],
                                   atol=tol, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("aniso,tilt", [(False, False), (True, True)])
def test_engine_rings_match_jax_engine(aniso, tilt):
    medium, geo, spectra, cfg, steps, u = TK._workload(aniso=aniso, tilt=tilt)
    cfg = dataclasses.replace(cfg, save_photons=True)
    res_j, res_t = run_both_engines((medium, geo, spectra, cfg, steps, u))
    assert float(res_t.n_hits) == float(res_j.n_hits)
    assert int(res_t.rec_count.sum()) == float(res_t.n_hits)
    assert_rings_match(res_j, res_t, cfg.photon_capacity_per_slot)


def test_engine_records_sit_on_the_dom_sphere():
    """tests/test_engine.py:228 on the shared stream: a pencil beam at one
    DOM, pancake 1, so each record sits on the (oversized) sphere."""
    n, T = 128, 48
    medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.01)
    geo = _one_dom_geometry(x=30.0, oversize=5.0)
    cfg = PropagationConfig(n_slots=n, save_photons=True,
                            photon_capacity_per_slot=128)
    u = np.random.default_rng(5).random((T, 8, n)).astype(np.float32)
    res_j, res_t = run_both_engines((medium, geo, _spectra(), cfg,
                                     _beam_steps(n, 16), u))
    cnt = res_t.rec_count.numpy()
    assert cnt.sum() == float(res_t.n_hits) > 20
    valid = np.arange(128)[None, :] < cnt[:, None]
    r = np.sqrt(sum(res_t.rec[k].numpy()[valid] ** 2
                    for k in ("pos_x", "pos_y", "pos_z")))
    np.testing.assert_allclose(r, geo.collision_radius, atol=1e-3)
    assert (res_t.rec["weight"].numpy()[valid] > 0).all()
    assert_rings_match(res_j, res_t, 128)


@pytest.mark.parametrize("prescale", [1.0, 0.25])
def test_engine_save_all_matches_jax_engine(prescale):
    """tests/test_engine.py:335 and :355 on the shared stream: SAVE_ALL
    records each photon at its absorption point (dom 0, no detector in
    reach); with prescale, about that share of them."""
    n, T, photons = 64, 96, 8
    medium = make_homogeneous_ice(b400=0.05, a_dust400=0.05)
    geo = _one_dom_geometry(x=5000.0)
    cfg = PropagationConfig(n_slots=n, save_photons=True,
                            save_all_photons=True, stop_on_detection=False,
                            save_all_prescale=prescale,
                            photon_capacity_per_slot=32)
    u = np.random.default_rng(6).random((T, 8, n)).astype(np.float32)
    res_j, res_t = run_both_engines((medium, geo, _spectra(), cfg,
                                     _beam_steps(n, photons, source_type=0),
                                     u))
    total = int(res_t.rec_count.sum())
    assert float(res_t.n_generated) == n * photons
    if prescale == 1.0:
        assert total == n * photons          # every photon, once
    else:
        assert total / (n * photons) == pytest.approx(prescale, abs=0.06)
    assert (res_t.rec["dom"] == 0).all()
    assert_rings_match(res_j, res_t, 32)


def plain_records(inputs):
    """The port's fused call loop (the plain version on CPU tensors) in
    parity mode: one call of TK.T iterations."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    return KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                              iters_per_call=TK.T, max_calls=1, uniforms=u)


def test_plain_records_match_jax_interpret_kernel():
    """tests/test_kernel.py:490-533: the flat record contract (one (1, R)
    row, rec_count [R]) equal to the JAX kernel's, record by record after
    sorting both by (dom, time), within REC_TOLS."""
    medium, geo, spectra, cfg, steps, u = TK._workload(aniso=True, tilt=True)
    cfg = dataclasses.replace(cfg, save_photons=True)
    res_j, tot_j = TK._run_kernel(steps, medium, geo, spectra, cfg, u)
    res_t, tot_t = plain_records((medium, geo, spectra, cfg, steps, u))
    n = int(res_t.rec_count[0])
    assert n == int(res_j.rec_count[0]) == float(tot_t[KT.CNT_HITS]) > 20
    assert float(tot_t[KT.CNT_QUEUED]) == n
    assert float(tot_t[KT.CNT_DROPPED]) == 0.0
    assert float(tot_t[KT.CNT_STALLED]) == 0.0
    assert set(res_t.rec) == set(res_j.rec)
    fj = {k: np.asarray(v)[0] for k, v in res_j.rec.items()}
    ft = {k: v[0].numpy() for k, v in res_t.rec.items()}
    oj = np.lexsort((fj["time"], fj["dom"]))
    ot = np.lexsort((ft["time"], ft["dom"]))
    for key, tol in REC_TOLS:
        np.testing.assert_allclose(ft[key][ot], fj[key][oj], atol=tol,
                                   rtol=1e-3, err_msg=key)


def test_plain_save_all_matches_jax_interpret_kernel():
    """tests/test_kernel.py:578-624: SAVE_ALL at prescale 0.5 (dom 0,
    weight 0) against the JAX kernel.  As there, >= 98% of the records
    sorted by (time, pos_x) must agree field by field: records with
    near-equal times sort differently in the two packages."""
    medium, geo, spectra, cfg, steps, u = TK._workload()
    cfg = dataclasses.replace(cfg, save_photons=True, save_all_photons=True,
                              save_all_prescale=0.5)
    res_j, _ = TK._run_kernel(steps, medium, geo, spectra, cfg, u)
    res_t, tot_t = plain_records((medium, geo, spectra, cfg, steps, u))
    n = int(res_t.rec_count[0])
    assert n == int(res_j.rec_count[0]) > 20
    fj = {k: np.asarray(v)[0] for k, v in res_j.rec.items()}
    ft = {k: v[0].numpy() for k, v in res_t.rec.items()}
    assert (ft["dom"] == 0).all() and (ft["weight"] == 0).all()
    oj = np.lexsort((fj["pos_x"], fj["time"]))
    ot = np.lexsort((ft["pos_x"], ft["time"]))
    for key, tol in [("time", 1e-2), ("pos_x", 3e-2), ("pos_y", 3e-2),
                     ("pos_z", 3e-2), ("wavelength", 1e-2),
                     ("num_scatters", 1e-6), ("dist_in_abs_lens", 2e-2)]:
        ok = np.abs(ft[key][ot] - fj[key][oj]) <= tol + 1e-3 * np.abs(
            fj[key][oj])
        assert ok.mean() > 0.98, (key, ok.mean())
    n_gen = float(tot_t[KT.CNT_GEN])
    assert 0.25 * n_gen < n < 0.75 * n_gen


def rebuilt_hist(res, cfg, n_doms):
    """index_add_ of the record weights at (dom, time bin)."""
    r = res.rec
    nb = cfg.hist_n_bins
    tb = torch.clamp((r["time"][0] - cfg.hist_t_min) / cfg.hist_dt, 0.0,
                     nb - 1).to(torch.int64)
    return torch.zeros(n_doms * nb, dtype=torch.float64).index_add_(
        0, r["dom"][0].to(torch.int64) * nb + tb, r["weight"][0].double())


def test_stall_rule_drains_without_loss():
    """A record buffer of 3 per launch: launches stall, the stalled records
    go first in the next launch, and every hit still has its record (the
    histogram rebuilt from the records is the propagated one)."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    cfg = dataclasses.replace(cfg, save_photons=True)
    res, tot = KT.propagate_fused(steps, medium, geo, spectra, 5, cfg,
                                  iters_per_call=16, max_calls=256,
                                  rec_capacity=3)
    n = int(res.rec_count[0])
    assert float(tot[KT.CNT_GEN]) == float(steps.num_photons.sum())
    assert float(tot[KT.CNT_ALIVE]) == 0.0
    assert float(tot[KT.CNT_STALLED]) >= 5
    assert n == float(tot[KT.CNT_HITS]) == float(tot[KT.CNT_QUEUED]) > 20
    assert float(tot[KT.CNT_DROPPED]) == 0.0
    np.testing.assert_allclose(
        rebuilt_hist(res, cfg, geo.n_doms).numpy(),
        res.hist.reshape(-1).double().numpy(), rtol=1e-6, atol=1e-6)


def test_pending_record_is_written_first():
    """One launch of capacity 1: the second hit stays pending in the state
    rows (flat index in `pend`, its record position in x/y/z) and is the
    first record of the next launch, unchanged."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    cfg = dataclasses.replace(cfg, save_photons=True)
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = KT.pack_steps(steps)
    state = KT.init_state(steps, records=True)
    assert state.shape == (KT.NSF + KT.NRSF, TK.N)
    full = KT.run_fused_iterations(state.clone(), steps_p, tables, spec,
                                   uniforms=u)[3]
    state, _, c1, r1 = KT.run_fused_iterations(state, steps_p, tables, spec,
                                               uniforms=u, rec_capacity=1)
    assert r1.shape[0] == 1 and float(c1[KT.CNT_STALLED]) == 1.0
    torch.testing.assert_close(r1[0], full[0])
    pend = state[KT.NSF + KT.REC_STATE_FIELDS.index("pend")]
    stalled = torch.nonzero(pend >= 0)[:, 0]
    assert stalled.numel() >= 1
    assert float(c1[KT.CNT_ALIVE]) >= stalled.numel()
    _, _, _, r2 = KT.run_fused_iterations(state, steps_p, tables, spec,
                                          uniforms=u, rec_capacity=1)
    # the lowest stalled slot's pending record, equal to that slot's first
    # record in the run with room for all
    slot = KT.REC_COLUMNS.index("slot")
    s0 = int(stalled[0])
    assert int(r2[0, slot]) == s0
    torch.testing.assert_close(r2[0], full[full[:, slot] == s0][0],
                               rtol=0.0, atol=0.0)


def test_records_from_rows_contract():
    """The derived fields of the flat contract, against the JAX call loop's
    numpy formulas (clsim_tpu/propagate/kernel.py:2687-2714)."""
    rng = np.random.default_rng(2)
    R, nb = 50, 64
    rows = rng.standard_normal((R, KT.NRC)).astype(np.float32)
    col = {k: i for i, k in enumerate(KT.REC_COLUMNS)}
    for a, b, c in (("dir_x", "dir_y", "dir_z"),
                    ("start_dx", "start_dy", "start_dz")):
        v = rows[:, [col[a], col[b], col[c]]]
        rows[:, [col[a], col[b], col[c]]] = v / np.linalg.norm(
            v, axis=1, keepdims=True)
    rows[:, col["inv_gv"]] = 4.0 + rng.random(R)
    rows[:, col["flat_idx"]] = rng.integers(0, 10 * nb, R)
    rec = {k: v[0].numpy() for k, v in KT.records_from_rows(
        torch.as_tensor(rows), nb).items()}
    assert set(rec) == set(ET.REC_FIELDS)
    f = {k: rows[:, i].astype(np.float64) for k, i in col.items()}
    np.testing.assert_allclose(rec["dir_theta"],
                               np.arccos(np.clip(f["dir_z"], -1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(
        rec["start_phi"],
        np.mod(np.arctan2(f["start_dy"], f["start_dx"]), 2 * np.pi),
        atol=1e-5)
    np.testing.assert_allclose(rec["group_velocity"], 1.0 / f["inv_gv"],
                               rtol=1e-6)
    np.testing.assert_allclose(
        rec["cherenkov_dist"], (f["time"] - f["start_time"]) / f["inv_gv"],
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rec["dom"], np.floor(f["flat_idx"] / nb))
    for k in ("pos_x", "time", "wavelength", "weight", "identifier",
              "num_scatters", "dist_in_abs_lens", "start_time"):
        np.testing.assert_array_equal(rec[k], rows[:, col[k]])


def test_record_spec_follows_the_config():
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    for change, rec_all in ((dict(save_photons=True), False),
                            (dict(save_photons=True, save_all_photons=True,
                                  save_all_prescale=0.5), True)):
        spec, _ = KT.fused_spec(medium, geo, spectra,
                                dataclasses.replace(cfg, **change), TK.N,
                                TK.T)
        assert spec.records and spec.rec_all == rec_all
        assert spec.rec_prescale == change.get("save_all_prescale", 1.0)
        assert KT.spec_unsupported(spec) is None
