"""The port's fused-kernel host side and plain version against clsim_tpu:
collision plans and cell tables, the plain version against the JAX Pallas
kernel in interpret mode on the same uniform stream (tolerances of
tests/test_kernel.py::_compare), the fused call loop, and the spec gate.
The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import test_kernel as TK

from clsim_tpu.geometry import hexagonal_geometry as hex_j
from clsim_tpu.propagate import kernel as KJ
from clsim_tpu.types import PropagationConfig as CfgJ

from clsim_tpu_torch.geometry import hexagonal_geometry as hex_t
from clsim_tpu_torch.propagate import kernel as KT
from clsim_tpu_torch.types import PropagationConfig as CfgT

from test_torch_engine import compare, port_inputs

torch.set_num_threads(1)

SMALL = dict(n_rings=1, string_spacing=60.0, doms_per_string=12,
             dom_spacing=15.0, z_top=80.0, oversize=8.0)
HEX61 = dict(n_rings=4, string_spacing=125.0, doms_per_string=60,
             dom_spacing=17.0, z_top=500.0, oversize=5.0)


@pytest.mark.parametrize("geo_kw,cfg_kw", [
    (SMALL, dict(max_segment_m=120.0, max_layer_steps=6)),
    (HEX61, dict(max_segment_m=35.0, max_layer_steps=4)),
    (HEX61, dict()),
])
def test_collision_plan_matches_jax(geo_kw, cfg_kw):
    cell_j, plan_j = KJ.plan_collision(hex_j(**geo_kw), CfgJ(**cfg_kw))
    cell_t, plan_t = KT.plan_collision(hex_t(device="cpu", **geo_kw), CfgT(**cfg_kw))
    np.testing.assert_array_equal(cell_j, cell_t)
    assert plan_j == plan_t
    assert len(plan_t["sub_plans"]) == 1


def test_gpu_cell_table_layout():
    """[cell][candidate][sx, sy, maxr2, dom_offset] per SubPlan, rebuilt
    from the JAX package's feature-major cell table."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    (p,), (cells,) = spec.sub_plans, tables.plan_cells
    assert cells.shape == (p.n_cells, p.K_cand, 4)
    for c in range(p.n_cells):
        for k in range(p.K_cand):
            np.testing.assert_array_equal(
                cells[c, k].numpy(),
                [cell_tab[p.row_off + f * p.K_cand + k, c] for f in range(4)])


@pytest.mark.parametrize("aniso,tilt", [(False, False), (True, True)])
def test_plain_version_matches_jax_interpret_kernel(aniso, tilt):
    inputs = TK._workload(aniso=aniso, tilt=tilt)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    res_j, tot_j = TK._run_kernel(steps_j, medium_j, geo_j, spectra_j,
                                  cfg_j, u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    state = KT.init_state(steps)
    state, hist, cnt = KT.run_fused_iterations(
        state, KT.pack_steps(steps), tables, spec, uniforms=u)
    compare(tot_j[KJ.CNT_GEN], tot_j[KJ.CNT_HITS], res_j.hist,
            cnt[KT.CNT_GEN], cnt[KT.CNT_HITS], hist)
    assert float(cnt[KT.CNT_DROPPED]) == 0.0
    assert float(cnt[KT.CNT_QUEUED]) == float(cnt[KT.CNT_HITS])
    np.testing.assert_allclose(float(hist.double().sum()),
                               float(cnt[KT.CNT_WSUM]), rtol=1e-5)
    # the slot state carries on: photons_left never grows, in_flight is 0/1
    left0 = steps.num_photons.to(torch.float32)
    assert bool((state[0] <= left0).all())
    assert set(state[1].unique().tolist()) <= {0.0, 1.0}


def test_fused_driver_drains_on_cpu():
    """The call loop on CPU tensors (the plain version per call): every
    photon is generated, nothing is abandoned, hist sums to the weight."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    res, totals = KT.propagate_fused(steps, medium, geo, spectra, 9, cfg,
                                     iters_per_call=16, max_calls=64)
    assert float(totals[KT.CNT_GEN]) == float(steps.num_photons.sum())
    assert float(totals[KT.CNT_ALIVE]) == 0.0
    assert float(totals[KT.CNT_HITS]) > 20
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(res.weight_hits), rtol=1e-5)
    assert res.n_iterations % 16 == 0


def test_abandoned_photons_are_reported():
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    _, totals = KT.propagate_fused(steps, medium, geo, spectra, 9, cfg,
                                   iters_per_call=2, max_calls=1)
    assert float(totals[KT.CNT_ALIVE]) > 0.0


@pytest.mark.parametrize("change,item", [
    (dict(records=True, fixed_abs=True), "B6"),
    (dict(records=True, expected=True), "B6"),
    (dict(n_bias=1), "bias grid"),
])
def test_cuda_wrapper_spec_gate_raises(change, item):
    """The CUDA wrapper checks the spec before anything else and never falls
    back to the plain version.  What it still refuses: records with the B6
    deposit modes (as the JAX package does) and a one-point bias grid (the
    JAX kernel cannot serve one either)."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    assert KT.spec_unsupported(spec) is None
    bad = spec._replace(**change)
    assert item in KT.spec_unsupported(bad)
    with pytest.raises(NotImplementedError, match=item):
        KT._launch(KT.init_state(steps), KT.pack_steps(steps), tables, bad,
                   u, 0, 0, None)


@pytest.mark.parametrize("change", [
    dict(medium_tables=True, scat_table=True, expected=True),
    dict(n_tables=2, bias_uniform=False),
    dict(sub_plans=(), stopping=False),
    dict(expected=True, ang_poly=(0.1,) * 11),
    dict(threefry=True),
    dict(scat_table=True),
])
def test_cuda_wrapper_spec_gate_serves_flashers_and_deposit_modes(change):
    """Served since the flasher slice: the expected estimator in a tabulated
    medium, stacked flasher spectra with a non-uniform bias grid (K1·B4),
    and non-stopping detect on the global plan (K1·B3/B7 × B6/B8b); since
    the slice that serves every configuration of the JAX kernel, an
    angular polynomial of any length (the default hole-ice model has 11
    coefficients), threefry draws in a detect mode, and the tabulated
    scattering angle in the closed-form ice (MED_CLOSED_SCAT)."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    spec, _ = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T)
    assert KT.spec_unsupported(spec._replace(**change)) is None


@pytest.mark.parametrize("change,refused", [
    (dict(save_photons=True, photon_history_entries=2), True),
    (dict(estimator="expected", expected_angular_poly=(0.1,) * 9), False)])
def test_propagate_fused_refuses_unported_configs(change, refused):
    """Scatter-history rings stay refused (the engine serves them); a
    nine-coefficient angular polynomial, once past the parameter block's
    limit, runs: the kernel reads its coefficients from a device table."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    run = lambda: KT.propagate_fused(steps, medium, geo, spectra, 0,
                                     dataclasses.replace(cfg, **change),
                                     iters_per_call=TK.T, max_calls=1,
                                     uniforms=u)
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run()
        return
    res, totals = run()
    assert float(res.n_generated) == float(totals[KT.CNT_GEN]) > 0
    assert float(res.n_hits) > 20 and float(res.weight_hits) > 0.0


def test_propagate_fused_ignores_history_entries_without_records():
    """photon_history_entries sizes the rings of photon records only: without
    save_photons the kernel serves the run, as the JAX kernel does
    (fused_supported gates it under save_photons), and its histogram is the
    one of the run with no rings asked for."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    assert not cfg.save_photons
    runs = [KT.propagate_fused(steps, medium, geo, spectra, 0,
                               dataclasses.replace(
                                   cfg, photon_history_entries=h),
                               iters_per_call=TK.T, max_calls=1,
                               uniforms=u)[0] for h in (0, 4)]
    assert float(runs[0].n_generated) > 0
    assert torch.equal(runs[0].hist, runs[1].hist)
    assert float(runs[0].n_hits) == float(runs[1].n_hits)

def test_dispatch_backends():
    from clsim_tpu_torch.propagate import dispatch as D
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    assert D.backend_reason(medium, spectra, cfg, geo, TK.N) is None
    # records run in the kernel's record mode; history rings do not
    rec = dataclasses.replace(cfg, save_photons=True)
    assert D.backend_reason(medium, spectra, rec, geo, TK.N) is None
    assert "history" in D.backend_reason(
        medium, spectra, dataclasses.replace(rec, photon_history_entries=2),
        geo, TK.N)
    with pytest.raises(ValueError, match="unknown backend"):
        D.propagate_auto(steps, medium, geo, spectra, 0, cfg, backend="tpu")
    # CPU tensors: "auto" is the engine (no counters), "fused" the call loop
    eng = D.propagate_auto(steps, medium, geo, spectra, 4, cfg)
    fus = D.propagate_auto(steps, medium, geo, spectra, 4, cfg,
                           backend="fused", iters_per_call=64)
    assert eng.diag_totals is None and fus.diag_totals is not None
    for r in (eng, fus):
        assert float(r.n_generated) == float(steps.num_photons.sum())
