"""clsim_tpu_torch.propagate.diff.propagate_expected_diff against the JAX
package's (run with interpret=True, as tests/test_diff.py runs it), on
tests/test_diff.py's workloads (N = 512, T = 12; the beam at N = 1024,
T = 6).  The forward is the kernel's plain version here (CPU tensors), the
backward autograd of the port's engine on the same threefry stream.

Tolerances: primal L1 <= 4e-3 of the total (tests/test_diff.py's kernel
against engine); gradients against JAX's rel 1e-4 (the same engine
arithmetic, float32 sums in another order), against the port engine's own
autograd rel 1e-5 (the same function), against central differences of the
forward rel 0.02 (tests/test_diff.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_diff as TD
from test_torch_engine import port_inputs

from clsim_tpu.propagate.diff import propagate_expected_diff as ped_j
from clsim_tpu_torch.propagate import diff as DT
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.propagate import kernel as KT

torch.set_num_threads(2)

KEY = (0, 9)


def port(medium, geo, spectra, cfg, steps):
    st, m, g, sp, c, _ = port_inputs(medium, geo, spectra, cfg, steps,
                                     np.zeros((1, 8, 1), np.float32))
    return st, m, g, sp, c


@pytest.fixture(scope="module")
def setup():
    jax_inputs = TD._setup()
    return jax_inputs, port(*jax_inputs)


def test_primal_matches_jax(setup):
    (medium_j, geo_j, spectra_j, cfg_j, steps_j), (st, m, g, sp, c) = setup
    hj = np.asarray(ped_j(steps_j, medium_j, geo_j, spectra_j,
                          jnp.asarray(KEY, jnp.uint32), cfg_j,
                          n_iterations=TD.T, interpret=True), np.float64)
    ht = DT.propagate_expected_diff(st, m, g, sp, KEY, c,
                                    n_iterations=TD.T).double().numpy()
    assert hj.sum() > 1.0
    assert np.abs(hj - ht).sum() <= 4e-3 * hj.sum()
    # the external-stream variant reads the same numbers
    hu = DT.propagate_expected_diff(st, m, g, sp, KEY, c, n_iterations=TD.T,
                                    use_threefry=False).double().numpy()
    np.testing.assert_array_equal(hu, ht)


def test_gradient_matches_jax_engine_and_fd(setup):
    (medium_j, geo_j, spectra_j, cfg_j, steps_j), (st, m, g, sp, c) = setup
    key_j = jnp.asarray(KEY, jnp.uint32)
    proj = np.random.default_rng(2).random(
        (geo_j.n_doms, cfg_j.hist_n_bins)).astype(np.float32)
    a0 = 0.01

    def loss_j(a):
        mm = medium_j._replace(a_dust400=jnp.full(4, a, jnp.float32))
        return jnp.sum(ped_j(steps_j, mm, geo_j, spectra_j, key_j, cfg_j,
                             n_iterations=TD.T, interpret=True) * proj)

    def loss_t(a, fn):
        return (fn(m._replace(a_dust400=torch.ones(4) * a)) *
                torch.as_tensor(proj)).sum()

    fused = lambda mm: DT.propagate_expected_diff(st, mm, g, sp, KEY, c,
                                                  n_iterations=TD.T)
    engine = lambda mm: ET.propagate(st, mm, g, sp, 0, c,
                                     max_iterations=TD.T, key=KEY).hist
    g_j = float(jax.grad(loss_j)(jnp.float32(a0)))
    grads = []
    for fn in (fused, engine):
        a = torch.tensor(a0, requires_grad=True)
        grads.append(float(torch.autograd.grad(loss_t(a, fn), a)[0]))
    g_t, g_e = grads
    assert g_t == pytest.approx(g_j, rel=1e-4)
    assert g_t == pytest.approx(g_e, rel=1e-5)
    eps = 2e-4
    with torch.no_grad():
        fd = (float(loss_t(torch.tensor(a0 + eps), fused))
              - float(loss_t(torch.tensor(a0 - eps), fused))) / (2 * eps)
    assert g_t == pytest.approx(fd, rel=0.02)
    assert g_t < 0.0   # more dust -> fewer weighted hits


def test_gradients_reach_every_fitted_field(setup):
    """Every field IceFit fits carries a gradient from the kernel forward
    through the engine backward: b400, a_dust400, delta_tau, alpha, kappa,
    the anisotropy's magnitudes and the scattering law."""
    from clsim_tpu_torch.medium.anisotropy import AnisotropyParams
    _, (st, m, g, sp, c) = setup
    f = lambda v: torch.tensor(v, dtype=torch.float32, requires_grad=True)
    leaves = dict(b400=f([0.03] * 4), a_dust400=f([0.01] * 4),
                  delta_tau=m.delta_tau.clone().requires_grad_(True),
                  alpha=f(float(m.alpha)), kappa=f(float(m.kappa)))
    aniso = AnisotropyParams(azimuth=torch.tensor(3.9), mag_along=f(0.04),
                             mag_perp=f(-0.08), enabled=True)
    scat = m.scattering._replace(mean_cos=f(float(m.scattering.mean_cos)),
                                 liu_fraction=f(float(
                                     m.scattering.liu_fraction)))
    mm = m._replace(anisotropy=aniso, scattering=scat, **leaves)
    cs = dataclasses.replace(c, score_function=True)
    h = DT.propagate_expected_diff(st, mm, g, sp, KEY, cs, n_iterations=TD.T)
    wrt = list(leaves.values()) + [aniso.mag_along, aniso.mag_perp,
                                   scat.mean_cos, scat.liu_fraction]
    grads = torch.autograd.grad(h.sum(), wrt, allow_unused=True)
    for name, gr in zip(list(leaves) + ["mag_along", "mag_perp", "mean_cos",
                                        "liu_fraction"], grads):
        assert gr is not None, name
        assert bool(torch.isfinite(gr).all()) and float(gr.abs().sum()) > 0, \
            name


def test_rejects_detect_estimator(setup):
    _, (st, m, g, sp, c) = setup
    with pytest.raises(ValueError, match="expected"):
        DT.propagate_expected_diff(st, m, g, sp, KEY,
                                   dataclasses.replace(c, estimator="detect"))
    with pytest.raises(ValueError, match="threefry"):
        DT.propagate_expected_diff(st, m, g, sp, KEY, c, use_threefry=False,
                                   bwd_fraction=0.5)


@pytest.fixture(scope="module")
def beam():
    """tests/test_diff.py's pencil beam at a DOM 40 m out, the DOM on a
    five-DOM string (15 m spacing): a single DOM has no per-subdetector
    collision plan, which the kernel and its plain version need.

    The beam's photons are flasher-type (source_type 1: no cone) with one
    stacked spectrum, for which the JAX package samples the Cherenkov
    spectrum (clsim_tpu/ops/spectrum.py:172-174).  The port refuses a
    source_type without a stacked spectrum (ROADMAP.md C), so its inputs
    stack the same Cherenkov spectrum again as table 1: the same
    wavelengths from the same numbers."""
    from clsim_tpu.geometry import build_geometry
    from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
    medium, _, spectra, cfg, steps = TD._beam_workload(n=1024)
    geo = build_geometry(np.ones(5, np.int32), np.arange(1, 6),
                         np.full(5, 40.0), np.zeros(5),
                         30.0 - 15.0 * np.arange(5), oversize=8.0)
    jax_inputs = (medium, geo, spectra, cfg, steps)
    twice = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)] * 2)
    return jax_inputs, port(medium, geo, twice, cfg, steps)


def test_score_function_gradient_matches_jax(beam):
    """cfg.score_function: the likelihood-ratio term of the scattering law
    rides in the engine's per-slot log-likelihood; the primal is unchanged
    (exp(0) = 1) and the b400 gradient is JAX's."""
    (medium_j, geo_j, spectra_j, cfg_j, steps_j), (st, m, g, sp, c) = beam
    key_j = jnp.asarray([0, 700], jnp.uint32)
    cs_j = dataclasses.replace(cfg_j, score_function=True)
    cs = dataclasses.replace(c, score_function=True)

    def loss_j(b):
        mm = medium_j._replace(b400=jnp.full(4, b, jnp.float32))
        return jnp.sum(ped_j(steps_j, mm, geo_j, spectra_j, key_j, cs_j,
                             n_iterations=6, interpret=True, queue_rows=128,
                             flush_rows=32))

    def loss_t(b, cfg):
        return DT.propagate_expected_diff(
            st, m._replace(b400=torch.ones(4) * b), g, sp, [0, 700], cfg,
            n_iterations=6).sum()

    g_j = float(jax.grad(loss_j)(jnp.float32(0.02)))
    b = torch.tensor(0.02, requires_grad=True)
    l_s = loss_t(b, cs)
    g_s = float(torch.autograd.grad(l_s, b)[0])
    b = torch.tensor(0.02, requires_grad=True)
    l_d = loss_t(b, c)
    g_d = float(torch.autograd.grad(l_d, b)[0])
    assert float(l_s) == float(l_d)
    assert g_s == pytest.approx(g_j, rel=1e-3)
    assert np.sign(g_s) != np.sign(g_d)   # the detached term has the
    assert g_s < 0.0                      # wrong sign on the beam


def test_nan_poisoning_on_dropped_deposits(beam, monkeypatch):
    """A forward that reports dropped deposits (CNT_DROPPED > 0) returns a
    NaN-poisoned histogram.  Neither the CUDA kernel nor its plain version
    drops (atomics, no hit queue), so the counter is forced here."""
    _, (st, m, g, sp, c) = beam
    clean = DT.propagate_expected_diff(st, m, g, sp, KEY, c, n_iterations=6)
    assert bool(torch.isfinite(clean).all())
    real = KT.propagate_fused

    def dropping(*a, **k):
        res, totals = real(*a, **k)
        totals = totals.clone()
        totals[KT.CNT_DROPPED] = 1.0
        return res, totals

    monkeypatch.setattr(KT, "propagate_fused", dropping)
    h = DT.propagate_expected_diff(st, m, g, sp, KEY, c, n_iterations=6)
    assert not bool(torch.isfinite(h).any())


def test_bwd_fraction_matches_jax_subset(beam):
    """bwd_fraction: the backward runs on rng.permutation(fold_in(key,
    BWD_SALT), N)[:m], the JAX package's subset bit for bit, scaled by
    N / m; the gradient is JAX's."""
    (medium_j, geo_j, spectra_j, cfg_j, steps_j), (st, m, g, sp, c) = beam
    key_j = jnp.asarray([0, 31], jnp.uint32)

    def loss_j(a):
        mm = medium_j._replace(a_dust400=jnp.full(4, a, jnp.float32))
        return jnp.sum(ped_j(steps_j, mm, geo_j, spectra_j, key_j, cfg_j,
                             n_iterations=6, interpret=True, queue_rows=128,
                             flush_rows=32, bwd_fraction=0.5))

    g_j = float(jax.grad(loss_j)(jnp.float32(0.005)))
    a = torch.tensor(0.005, requires_grad=True)
    h = DT.propagate_expected_diff(st, m._replace(a_dust400=torch.ones(4) * a),
                                   g, sp, [0, 31], c, n_iterations=6,
                                   bwd_fraction=0.5)
    g_t = float(torch.autograd.grad(h.sum(), a)[0])
    assert g_t == pytest.approx(g_j, rel=1e-3)
    sel, scale = DT.bwd_subset([0, 31], 1024, 0.5)
    sel_j = jax.random.permutation(jax.random.fold_in(key_j, DT.BWD_SALT),
                                   1024)[:512]
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_j))
    assert scale == 2.0


def test_bwd_fraction_below_128_slots(beam):
    """The JAX package takes m = max(128, ...) slots for the backward even
    below 128 slots (clsim_tpu/propagate/diff.py:141), where the permutation
    has only N entries: the scale N / m < 1 shrinks the gradient (by half
    at N = 64).  Here m <= N: at N = 64 the subset is every slot, the scale
    1, and on the beam (identical steps in every slot) the gradient equals
    the full backward's."""
    _, (st, m, g, sp, c) = beam
    n = 64
    st = type(st)(*[f[:n] for f in st])
    c = dataclasses.replace(c, n_slots=n)
    sel, scale = DT.bwd_subset(KEY, n, 0.5)
    assert sel.numel() == n and scale == 1.0
    assert max(128, (int(n * 0.5) // 128) * 128) == 128   # the JAX rule
    grads = []
    for frac in (1.0, 0.5):
        a = torch.tensor(0.005, requires_grad=True)
        h = DT.propagate_expected_diff(
            st, m._replace(a_dust400=torch.ones(4) * a), g, sp, KEY, c,
            n_iterations=6, bwd_fraction=frac)
        grads.append(float(torch.autograd.grad(h.sum(), a)[0]))
    assert grads[0] != 0.0
    assert grads[1] == pytest.approx(grads[0], rel=1e-6)
