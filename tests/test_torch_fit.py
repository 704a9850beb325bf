"""clsim_tpu_torch.parallel.mesh.IceFit against the JAX IceFit on a
one-device CPU mesh (tests/test_diff.py's workload, N = 512, T = 12): one
SGD step, Adam steps against optax.adam (log-space param_transform, state
carried across steps), and the poisson / two_sample loss, with the engine
forward; the fused forward (the kernel's plain version here) against the
engine forward; and the three faults of the JAX IceFit that the port fixes.

Tolerances: losses rel 1e-5 and parameter updates rel 1e-3 against the
JAX step (the same engine arithmetic; float32 sums in another order);
Adam's first steps move each parameter by about lr, compared to atol 1e-6."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import test_diff as TD
from test_torch_engine import port_inputs

from clsim_tpu.hits.acceptance import icecube_dom_acceptance as acc_j
from clsim_tpu.hits.mcpe import expected_mcpe_factor as emf_j
from clsim_tpu.parallel.mesh import IceFit as IceFitJ
from clsim_tpu.parallel.mesh import make_mesh, shard_steps
from clsim_tpu.propagate.engine import propagate as prop_j
from clsim_tpu_torch.hits.acceptance import icecube_dom_acceptance as acc_t
from clsim_tpu_torch.hits.mcpe import expected_mcpe_factor as emf_t
from clsim_tpu_torch.parallel import mesh as M

torch.set_num_threads(2)

KEY = (0, 9)
A0 = np.full(4, 0.012, np.float32)


@pytest.fixture(scope="module")
def problem():
    medium, geo, spectra, cfg, steps = TD._setup()
    key = jnp.asarray(KEY, jnp.uint32)
    target = prop_j(steps, medium, geo, spectra, jax.random.fold_in(key, 0),
                    cfg, max_iterations=TD.T).hist
    st, m, g, sp, c, _ = port_inputs(medium, geo, spectra, cfg, steps,
                                     np.zeros((1, 8, 1), np.float32))
    return dict(jax=(medium, geo, spectra, cfg, steps, key, target),
                port=(st, m, g, sp, c, torch.as_tensor(np.asarray(target))))


def jax_steps(problem, n_steps, params, **kw):
    medium, geo, spectra, cfg, steps, key, target = problem["jax"]
    mesh = make_mesh(jax.devices()[:1])
    fit = IceFitJ(mesh, cfg, geo, spectra, max_iterations=TD.T, **kw)
    out = []
    for _ in range(n_steps):
        params, loss = fit.step(params, medium, shard_steps(steps, mesh),
                                key, target)
        out.append(({k: np.asarray(v) for k, v in params.items()},
                    float(loss)))
    return out


def port_steps(problem, n_steps, params, **kw):
    st, m, g, sp, c, target = problem["port"]
    fit = M.IceFit(c, g, sp, max_iterations=TD.T, **kw)
    out = []
    for _ in range(n_steps):
        params, loss = fit.step(params, m, st, KEY, target)
        out.append(({k: v.numpy() for k, v in params.items()}, float(loss)))
    return out, fit


def test_sgd_step_matches_jax(problem):
    lr = 1e-4
    (pj, lj), = jax_steps(problem, 1, {"a_dust400": jnp.asarray(A0)},
                          learning_rate=lr)
    ((pt, lt),), fit = port_steps(problem, 1, {"a_dust400": A0},
                                  learning_rate=lr)
    assert fit.cfg.score_function is False      # absorption only
    assert lt == pytest.approx(lj, rel=1e-5) and lt > 0.0
    np.testing.assert_allclose(pt["a_dust400"] - A0, pj["a_dust400"] - A0,
                               rtol=1e-3, atol=1e-12)
    assert np.abs(pt["a_dust400"] - A0).max() > 0.0


def test_adam_log_space_matches_optax(problem):
    """Two Adam steps in log space: torch.optim.Adam against optax.adam,
    the optimizer state carried across step() calls."""
    lr = 1e-3
    out_j = jax_steps(problem, 2, {"log_a": jnp.log(jnp.asarray(A0))},
                      optimizer=optax.adam(lr),
                      param_transform=lambda p: {"a_dust400":
                                                 jnp.exp(p["log_a"])})
    out_t, _ = port_steps(problem, 2, {"log_a": np.log(A0)},
                          optimizer=functools.partial(torch.optim.Adam,
                                                      lr=lr),
                          param_transform=lambda p: {"a_dust400":
                                                     torch.exp(p["log_a"])})
    for (pj, lj), (pt, lt) in zip(out_j, out_t):
        assert lt == pytest.approx(lj, rel=1e-5)
        np.testing.assert_allclose(pt["log_a"], pj["log_a"], atol=1e-6)
    assert np.abs(out_t[1][0]["log_a"] - np.log(A0)).max() > 1.5 * lr


def test_poisson_two_sample_matches_jax(problem):
    lr = 1e-5
    kw = dict(learning_rate=lr, loss="poisson", two_sample=True)
    (pj, lj), = jax_steps(problem, 1, {"a_dust400": jnp.asarray(A0)}, **kw)
    ((pt, lt),), _ = port_steps(problem, 1, {"a_dust400": A0}, **kw)
    assert lt == pytest.approx(lj, rel=1e-5)
    np.testing.assert_allclose(pt["a_dust400"] - A0, pj["a_dust400"] - A0,
                               rtol=1e-3, atol=1e-12)


def test_fused_forward_matches_engine_forward(problem):
    """forward='fused' (propagate_expected_diff: the kernel's plain version
    on CPU tensors, engine-autograd backward) takes the engine forward's
    step."""
    kw = dict(learning_rate=1e-4)
    ((pe, le),), _ = port_steps(problem, 1, {"a_dust400": A0}, **kw)
    ((pf, lf),), _ = port_steps(problem, 1, {"a_dust400": A0},
                                forward="fused", **kw)
    assert lf == pytest.approx(le, rel=1e-4)
    np.testing.assert_allclose(pf["a_dust400"] - A0, pe["a_dust400"] - A0,
                               rtol=1e-4, atol=1e-12)
    ((pb, lb),), _ = port_steps(problem, 1, {"a_dust400": A0},
                                forward="fused", bwd_fraction=0.5, **kw)
    assert lb == pytest.approx(lf, rel=1e-6)
    assert np.abs(pb["a_dust400"] - A0).max() > 0.0


@pytest.mark.parametrize("fields,score", [(("a_dust400",), False),
                                          (("b400",), True),
                                          (("alpha",), True),
                                          (("a_dust400", "b400"), True)])
def test_score_function_auto_selection(problem, fields, score):
    """score_function=None resolves on the first step: on when a
    scattering parameter is fitted.  `alpha` (the wavelength exponent of
    the scattering coefficient) counts as one here; the JAX package's
    SCATTERING_FIT_PARAMS omits it (clsim_tpu/parallel/mesh.py:202)."""
    st, m, g, sp, c, target = problem["port"]
    fit = M.IceFit(c, g, sp, max_iterations=2, learning_rate=0.0)
    params = {f: getattr(m, f).clone() for f in fields}
    fit.step(params, m, st, KEY, target)
    assert fit.cfg.score_function is score
    assert ("alpha" in IceFitJ.SCATTERING_FIT_PARAMS) is False
    assert "alpha" in M.IceFit.SCATTERING_FIT_PARAMS


def test_failing_param_transform_raises(problem):
    """The JAX IceFit probes the param_transform inside a bare `except`
    (clsim_tpu/parallel/mesh.py:361-366): a transform that fails there
    leaves the fit keys as the raw parameter names, which silently turns
    the score function off.  Here the failure surfaces."""
    st, m, g, sp, c, target = problem["port"]

    def bad(p):
        raise KeyError("b400_scale")

    fit = M.IceFit(c, g, sp, max_iterations=2, param_transform=bad)
    with pytest.raises(KeyError, match="b400_scale"):
        fit.step({"log_b": np.zeros(4, np.float32)}, m, st, KEY, target)
    assert fit._score_function is None


def test_fit_warnings(problem):
    """Fitting scattering parameters with score_function=False warns (as
    in the JAX package); fitting `anisotropy` warns that its gradient
    lacks the direction transform's Jacobian."""
    from clsim_tpu_torch.medium.anisotropy import AnisotropyParams
    st, m, g, sp, c, target = problem["port"]
    fit = M.IceFit(c, g, sp, max_iterations=2, learning_rate=0.0,
                   score_function=False)
    with pytest.warns(UserWarning, match="biased"):
        fit.step({"b400": m.b400.clone()}, m, st, KEY, target)
    aniso = AnisotropyParams(azimuth=torch.tensor(3.9),
                             mag_along=torch.tensor(0.04),
                             mag_perp=torch.tensor(-0.08), enabled=True)
    fit = M.IceFit(c, g, sp, max_iterations=2, learning_rate=0.0,
                   param_transform=lambda p: {"anisotropy": aniso._replace(
                       mag_along=p["k1"])})
    with pytest.warns(UserWarning, match="Jacobian"):
        fit.step({"k1": np.float32(0.04)}, m, st, KEY, target)


def test_bad_arguments_and_sharding_raise(problem):
    """Bad IceFit arguments raise; make_sharded_propagate's backend="fused"
    raises on an unsupported configuration or without the build-time
    inputs, and "auto" on CPU tensors serves the engine and says why
    (tests/test_parallel.py::test_sharded_auto_backend_reports_fallback)."""
    st, m, g, sp, c, target = problem["port"]
    for kw in (dict(forward="tpu"), dict(loss="l1"),
               dict(bwd_fraction=0.5)):
        with pytest.raises(ValueError):
            M.IceFit(c, g, sp, **kw)
    mesh = M.make_mesh(device="cpu")
    inputs = dict(medium=m, geo=g, spectra=sp)
    detect_soft = dataclasses.replace(c, estimator="detect")
    with pytest.raises(ValueError, match="unsupported: .*soft"):
        M.make_sharded_propagate(mesh, detect_soft, backend="fused", **inputs)
    with pytest.raises(ValueError, match="build-time"):
        M.make_sharded_propagate(mesh, c, backend="fused")
    run = M.make_sharded_propagate(mesh, c)
    assert run.backend == "engine" and "build-time" in run.backend_reason
    run = M.make_sharded_propagate(mesh, c, **inputs)
    assert run.backend == "engine" and "cpu" in run.backend_reason
    run = M.make_sharded_propagate(mesh, detect_soft, **inputs)
    assert run.backend == "engine" and "soft" in run.backend_reason
    assert M.make_sharded_propagate(mesh, c, backend="fused",
                                    **inputs).backend == "fused"
    # a detect config is fitted through its expected-estimator twin
    fit = M.IceFit(dataclasses.replace(c, estimator="detect"), g, sp)
    assert fit.cfg.estimator == "expected" and fit.cfg.soft_binning


def test_expected_mcpe_factor_matches_jax():
    x = np.linspace(270.0, 670.0, 41)
    pdf = np.exp(-((x - 420.0) / 80.0) ** 2)
    fj = float(emf_j(acc_j(), jnp.asarray(x), jnp.asarray(pdf)))
    ft = float(emf_t(acc_t(device="cpu"), x, pdf))
    assert ft == pytest.approx(fj, rel=1e-6) and 0.0 < ft < 1.0
