"""clsim_tpu_torch's propagation engine against clsim_tpu's engine, driven
with the same (T, 8, N) uniform stream (tests/test_kernel.py's workload at
N = 2048, T = 16).  Tolerances of tests/test_kernel.py::_compare: equal
generated counts, hits within max(2, 1%), histogram L1 <= 2e-3 of the
total."""

import dataclasses

import numpy as np
import pytest
import torch

import test_kernel as TK

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(1)


def port_inputs(medium, geo, spectra, cfg, steps, uniforms):
    return (C.steps_from_numpy(C.numpy_tree(steps), device="cpu"),
            C.medium_from_numpy(C.numpy_tree(medium), device="cpu"),
            C.geometry_from_numpy(C.numpy_tree(geo), device="cpu"),
            C.spectra_from_numpy(C.numpy_tree(spectra), device="cpu"),
            PropagationConfig(**dataclasses.asdict(cfg)),
            torch.as_tensor(uniforms))


def compare(gen_ref, hits_ref, hist_ref, gen, hits, hist, tol=2e-3):
    he = np.asarray(hist_ref, np.float64).reshape(-1)
    hp = np.asarray(hist, np.float64).reshape(-1)
    assert float(gen) == float(gen_ref)
    assert float(hits_ref) > 20, "workload produced too few hits"
    assert abs(float(hits) - float(hits_ref)) <= max(2.0, 0.01 * float(hits_ref))
    assert np.abs(he - hp).sum() <= tol * he.sum() + 1e-6


@pytest.mark.parametrize("aniso,tilt", [(False, False), (True, True)])
def test_engine_matches_jax_engine(aniso, tilt):
    inputs = TK._workload(aniso=aniso, tilt=tilt)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    _, acc_j = TK._run_engine_with_uniforms(steps_j, medium_j, geo_j,
                                            spectra_j, cfg_j, u_j)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    res = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
    assert res.n_iterations == TK.T
    compare(acc_j.n_generated, acc_j.n_hits, acc_j.hist,
            res.n_generated, res.n_hits, res.hist)


def test_bruteforce_collision_agrees_with_culled():
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    culled = ET.propagate(steps, medium, geo, spectra, 0, cfg, uniforms=u)
    brute = ET.propagate(steps, medium, geo, spectra, 0,
                         dataclasses.replace(cfg, collision_mode="bruteforce"),
                         uniforms=u)
    compare(brute.n_generated, brute.n_hits, brute.hist,
            culled.n_generated, culled.n_hits, culled.hist)


def test_engine_drains_and_conserves():
    steps, medium, geo, spectra, cfg, _ = port_inputs(*TK._workload())
    res = ET.propagate(steps, medium, geo, spectra, 123, cfg)
    assert float(res.n_generated) == float(steps.num_photons.sum())
    assert float(res.n_hits) > 20
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(res.weight_hits), rtol=1e-5)
    assert bool(torch.isfinite(res.hist).all())


@pytest.mark.parametrize("change", [dict(medium_kind="water")])
def test_unported_engine_options_raise(change):
    """A water-kind medium without its wavelength tables is refused with
    ValueError (the tabulated media are ported: tests/test_torch_water.py;
    the expected estimator and soft binning: tests/test_torch_expected.py;
    the scatter-history rings: tests/test_torch_history.py)."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    with pytest.raises(ValueError, match="without wavelength tables"):
        ET.propagate(steps, medium._replace(**change), geo, spectra, 0, cfg,
                     uniforms=u)
