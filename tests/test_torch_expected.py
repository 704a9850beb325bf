"""The expected estimator and its relatives in clsim_tpu_torch (the B6
deposit modes: expected with soft binning and the angular polynomial,
non-stopping detect, the fixed absorption horizon) against clsim_tpu, on
tests/test_kernel.py's workload (N = 2048, T = 16), with anisotropy and
tilt off and on:

  * the port's engine against the JAX engine on a shared (T, 8, N) stream,
    and in key mode against the jitted JAX engine drawing its own threefry;
  * the kernel's plain version (the fused call loop on CPU tensors) against
    the port's engine, on the shared stream and in threefry mode;
  * the kernel spec's B6 / B8b fields against the JAX package's.

Tolerances (tests/test_kernel.py::_compare): equal generated counts, hits
within max(2, 1%), histogram L1 <= 2e-3 of the total; the summed deposited
weight within rel 1e-4 (float32 sums in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_kernel as TK
from test_torch_engine import compare, port_inputs

from clsim_tpu.propagate import engine as EJ
from clsim_tpu.propagate import kernel as KJ
from clsim_tpu.propagate.diff import make_uniform_stream as stream_j
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.propagate import dispatch as D
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT

torch.set_num_threads(1)

KEY = (0x80000001, 77)
MODES = {
    "expected": dict(estimator="expected"),
    "expected_soft_ang_fixed": dict(estimator="expected", soft_binning=True,
                                    expected_angular_poly=(0.3, 0.6),
                                    fixed_abs_lens=8.0),
    "nonstopping": dict(stop_on_detection=False),
    "fixed_abs": dict(fixed_abs_lens=8.0),
}


def workload(mode, aniso):
    medium, geo, spectra, cfg, steps, u = TK._workload(aniso=aniso,
                                                       tilt=aniso)
    return medium, geo, spectra, dataclasses.replace(cfg, **MODES[mode]), \
        steps, u


def compare_res(ref, res):
    compare(ref.n_generated, ref.n_hits, ref.hist,
            res.n_generated, res.n_hits, res.hist)
    np.testing.assert_allclose(float(res.weight_hits),
                               float(ref.weight_hits), rtol=1e-4)


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine_shared_stream(mode, aniso):
    inputs = workload(mode, aniso)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    _, acc_j = TK._run_engine_with_uniforms(steps_j, medium_j, geo_j,
                                            spectra_j, cfg_j, u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    res = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
    compare_res(acc_j, res)
    if cfg.estimator == "expected":
        # survival weights: every deposit is below its photon's w0
        assert 0.0 < float(res.weight_hits) < float(res.n_hits) * 1.01


@pytest.mark.parametrize("mode", ["expected_soft_ang_fixed", "nonstopping"])
def test_engine_key_mode_matches_jax_engine(mode):
    """key= draws rng.uniforms(rng.iter_key(key, i), (N,), 8) at iteration
    i: the jitted JAX engine's own stream for the same key."""
    inputs = workload(mode, True)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, _ = inputs
    res_j = EJ.propagate(steps_j, medium_j, geo_j, spectra_j,
                         jnp.asarray(KEY, jnp.uint32), cfg_j,
                         max_iterations=TK.T)
    steps, medium, geo, spectra, cfg, _ = port_inputs(*inputs)
    res = ET.propagate(steps, medium, geo, spectra, 0, cfg,
                       max_iterations=TK.T, key=KEY)
    compare_res(res_j, res)
    with pytest.raises(ValueError, match="exclusive"):
        ET.propagate(steps, medium, geo, spectra, 0, cfg, key=KEY,
                     uniforms=torch.zeros((1, 8, TK.N)))


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_matches_engine(mode, aniso):
    steps, medium, geo, spectra, cfg, u = port_inputs(*workload(mode, aniso))
    ref = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
    res, totals = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                     iters_per_call=TK.T, max_calls=1,
                                     uniforms=u)
    compare_res(ref, res)
    assert float(totals[KT.CNT_DROPPED]) == 0.0
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(totals[KT.CNT_WSUM]), rtol=1e-5)


@pytest.mark.parametrize("mode", ["expected_soft_ang_fixed", "expected"])
def test_plain_version_threefry_matches_engine_key_mode(mode):
    """threefry_key: the kernel's plain version draws from the folded key
    table, the engine from the key; the same numbers, the same result."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(*workload(mode, True))
    ref = ET.propagate(steps, medium, geo, spectra, 0, cfg,
                       max_iterations=TK.T, key=KEY)
    res, _ = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                iters_per_call=TK.T, max_calls=1,
                                threefry_key=KEY)
    compare_res(ref, res)
    # and against the materialized stream of the same key
    u = rng.make_uniform_stream(KEY, TK.T, TK.N)
    res_u, _ = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                  iters_per_call=TK.T, max_calls=1,
                                  uniforms=u)
    assert torch.equal(res.hist, res_u.hist)
    for bad in (dict(uniforms=u), dict(max_calls=2)):
        with pytest.raises(ValueError):
            KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                               iters_per_call=TK.T, threefry_key=KEY,
                               **{"max_calls": 1, **bad})


@pytest.mark.parametrize("mode", ["nonstopping", "fixed_abs"])
def test_threefry_key_refused_in_detect_modes(mode):
    """In-kernel threefry serves the detect modes too, as the JAX kernel
    takes a key with any estimator: propagate_fused(threefry_key=) in a
    detect mode runs, the spec passes the gate, and the result is the
    engine's in key mode on the same key."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(*workload(mode, True))
    res, _ = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                iters_per_call=TK.T, max_calls=1,
                                threefry_key=KEY)
    ref = ET.propagate(steps, medium, geo, spectra, 0, cfg,
                       max_iterations=TK.T, key=KEY)
    compare_res(ref, res)
    spec, _ = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T,
                            threefry=True)
    assert KT.spec_unsupported(spec) is None


@pytest.mark.parametrize("threefry", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_fields_match_jax(mode, threefry):
    inputs = workload(mode, True)
    medium_j, geo_j, spectra_j, cfg_j, _, _ = inputs
    spec_j = KJ._build_spec(medium_j, geo_j, spectra_j, cfg_j, TK.N, TK.T,
                            1, 32, 1024, 2, not threefry, True,
                            threefry=threefry)
    _, medium, geo, spectra, cfg, _ = port_inputs(*inputs)
    spec, _ = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T,
                            threefry=threefry)
    for f in ("expected", "stopping", "fixed_abs", "soft", "horizon",
              "threefry"):
        assert getattr(spec, f) == getattr(spec_j, f), f
    assert spec.ang_poly == tuple(float(c) for c in spec_j.ang_poly)
    assert spec.pmt_axis == tuple(float(a) for a in spec_j.pmt_axis)
    assert KT.spec_unsupported(spec) is None
    assert D.backend_reason(medium, spectra, cfg, geo, TK.N) is None
    mode_bits = KT.kernel_mode(spec)
    assert bool(mode_bits & KT.MODE_THREEFRY) == threefry
    assert bool(mode_bits & KT.MODE_FIXED) == spec.fixed_abs


def test_dispatch_runs_expected_modes():
    """propagate_auto on CPU tensors: 'auto' is the engine, 'fused' the
    call loop on the plain version; both drain the workload."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(
        *workload("expected_soft_ang_fixed", False))
    eng = D.propagate_auto(steps, medium, geo, spectra, 3, cfg)
    fus = D.propagate_auto(steps, medium, geo, spectra, 3, cfg,
                           backend="fused", iters_per_call=64)
    for r in (eng, fus):
        assert float(r.n_generated) == float(steps.num_photons.sum())
        assert float(r.weight_hits) > 0.0
    assert fus.diagnostics["abandoned"] == 0.0


def test_threefry_gate_and_key_table_layout():
    """8 N must stay below 2**32 (one 32-bit counter per element of an
    iteration's block); the wrapper's key table is (2T,) int64."""
    steps, medium, geo, spectra, cfg, _ = port_inputs(
        *workload("expected", False))
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, TK.N, TK.T,
                                   threefry=True)
    assert "2**32" in KT.spec_unsupported(spec._replace(n_slots=2 ** 29))
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    with pytest.raises(ValueError, match="keys"):
        KT.run_fused_iterations(KT.init_state(steps), KT.pack_steps(steps),
                                tables, spec)
