"""Differentiable fast path: kernel forward, engine-autograd backward.

PyTorch counterpart of clsim_tpu.propagate.diff.  The expected estimator
(fixed absorption horizon, survival-weight deposits, soft binning;
engine.py) is a smooth, reparameterized function of the medium parameters
once the random stream is fixed.  propagate_expected_diff runs its FORWARD
through the propagation kernel (propagate_fused: the CUDA kernel on CUDA
tensors, its plain version on CPU tensors) and its BACKWARD through
torch.autograd of the port's engine on the SAME stream: the in-kernel
threefry draws (ops/rng.py) are bit-identical to the engine's key mode, so
the engine's vector-Jacobian product is the gradient of the returned primal
up to float rounding, and finite differences of the forward check it.

While recording (util/profiling), the forward is the span "fit_forward"
(the kernel launch and its "plan" span) and counts its slots under
"fit_photons"; the backward is "fit_backward", with "fit_replay" (the
engine under grad) and "fit_vjp" (autograd.grad) inside it.

The JAX package has no backward Pallas kernel either: its backward is jax.vjp
of its engine (clsim_tpu/propagate/diff.py:82-94, :126-157), so the port's
backward is autograd of the port's engine and needs no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.rng import make_uniform_stream
from ..ops.spectrum import SpectrumTable
from ..types import PropagationConfig, StepBatch, tensor_leaves
from ..util import profiling as P
from . import engine as E
from . import kernel as K

# fold_in salt of the backward's random slot subset (the JAX package's)
BWD_SALT = 0x62776673


def replace_leaves(obj, updates: dict):
    """`obj` with the tensors at the given paths replaced."""
    fields = {}
    for name, v in obj._asdict().items():
        sub = {p[1:]: t for p, t in updates.items() if p[0] == name}
        if (name,) in updates:
            fields[name] = updates[(name,)]
        elif sub:
            fields[name] = replace_leaves(v, sub)
    return obj._replace(**fields)


def bwd_subset(key, n: int, fraction: float):
    """The backward's random slot subset and its gradient scale: m slots of
    rng.permutation(fold_in(key, BWD_SALT), n), m a multiple of 128 as in
    the JAX package, and n / m.

    The JAX package takes m = max(128, ...) and so m > n below 128 slots
    (clsim_tpu/propagate/diff.py:141), where the permutation has only n
    entries but the scale is n / m < 1: the gradient shrinks.  Here m is at
    most n."""
    m = min(n, max(128, (int(n * fraction) // 128) * 128))
    sel = rng.permutation(rng.fold_in(key, BWD_SALT), n)[:m]
    return sel, n / m


class _Problem(NamedTuple):
    """What the autograd function closes over (static for one call)."""
    medium: MediumProperties
    paths: tuple
    steps: StepBatch
    geo: DetectorGeometry
    spectra: SpectrumTable
    cfg: PropagationConfig
    n_iterations: int
    key: Optional[torch.Tensor]
    uniforms: Optional[torch.Tensor]
    bwd_fraction: float


class _ExpectedHist(torch.autograd.Function):
    """hist = kernel forward; d(hist) = autograd of the engine on the same
    stream.  The differentiable inputs are the medium's tensors."""

    @staticmethod
    def forward(ctx, prob: _Problem, *leaves):
        with P.span("fit_forward"):
            P.count("fit_photons", int(prob.steps.x.shape[0]))
            medium = replace_leaves(prob.medium,
                                    dict(zip(prob.paths, leaves)))
            res, totals = K.propagate_fused(
                prob.steps, medium, prob.geo, prob.spectra, 0, prob.cfg,
                iters_per_call=prob.n_iterations, max_calls=1,
                uniforms=prob.uniforms, threefry_key=prob.key)
            ctx.prob = prob
            ctx.save_for_backward(*leaves)
            # hits the kernel could not deposit poison the histogram, so a
            # fit loss goes NaN loudly instead of losing weight silently
            dev = totals.device
            poison = torch.where(totals[K.CNT_DROPPED] > 0.0,
                                 torch.tensor(float("nan"), device=dev),
                                 torch.tensor(0.0, device=dev))
            return res.hist + poison.to(res.hist.dtype)

    @staticmethod
    def backward(ctx, grad_hist):
        # on CUDA tensors autograd runs this on its device thread, where
        # the span is a root
        with P.span("fit_backward"):
            prob = ctx.prob
            want = ctx.needs_input_grad[1:]
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, want)]
            steps, scale = prob.steps, 1.0
            if prob.bwd_fraction < 1.0:
                # stochastic backward: the engine runs on a random slot
                # subset (keyed, so ordered step batches stay unbiased) and
                # the gradient is scaled back: an unbiased minibatch
                # estimate at bwd_fraction of the cost.  The primal is
                # untouched.
                sel, scale = bwd_subset(prob.key, int(steps.x.shape[0]),
                                        prob.bwd_fraction)
                sel = sel.to(steps.x.device)
                steps = StepBatch(*[a[sel] for a in steps])
            medium = replace_leaves(prob.medium,
                                    dict(zip(prob.paths, leaves)))
            with torch.enable_grad():
                with P.span("fit_replay"):
                    res = E.propagate(steps, medium, prob.geo, prob.spectra,
                                      0, prob.cfg,
                                      max_iterations=prob.n_iterations,
                                      uniforms=prob.uniforms, key=prob.key)
                wanted = [t for t, w in zip(leaves, want) if w]
                with P.span("fit_vjp"):
                    grads = iter(torch.autograd.grad(
                        res.hist, wanted, grad_outputs=grad_hist * scale,
                        allow_unused=True)) if wanted else iter(())
            return (None,) + tuple(next(grads) if w else None for w in want)


def propagate_expected_diff(steps: StepBatch, medium: MediumProperties,
                            geo: DetectorGeometry, spectra: SpectrumTable,
                            key, cfg: PropagationConfig,
                            n_iterations: int = 64,
                            use_threefry: bool = True,
                            bwd_fraction: float = 1.0) -> torch.Tensor:
    """Differentiable (n_doms, n_bins) hit-time histogram of the expected
    estimator, with respect to every floating-point tensor of `medium`
    that requires grad.

    Forward: the propagation kernel, n_iterations in one launch, drawing
    in-kernel threefry from `key` (use_threefry, the default) or reading
    rng.make_uniform_stream(key, n_iterations, N).  On CUDA tensors that is
    the CUDA kernel, launched or raising; on CPU tensors its plain version.
    Backward: torch.autograd of engine.propagate on the same key or stream
    (reparameterized trajectories; gradients flow through the survival
    weights, and with cfg.score_function through the scattering law).
    `bwd_fraction` < 1 runs the backward on a keyed random subset of the
    slots (threefry only).

    A histogram of a run that dropped deposits (CNT_DROPPED > 0) is
    NaN-poisoned, as the JAX package's is.  The CUDA kernel deposits with
    atomics and never drops, so on the card that counter is always 0; the
    rule stays for any forward that could."""
    if cfg.estimator != "expected":
        raise ValueError("propagate_expected_diff requires "
                         "cfg.estimator='expected'")
    if bwd_fraction < 1.0 and not use_threefry:
        raise ValueError("bwd_fraction < 1 needs the threefry variant (the "
                         "subset draws its own stream from the key)")
    k = rng.as_key(key)
    uniforms = None
    if not use_threefry:
        uniforms = make_uniform_stream(k.to(steps.x.device), n_iterations,
                                       int(steps.x.shape[0]))
    paths, leaves = zip(*tensor_leaves(medium))
    prob = _Problem(medium=medium, paths=paths, steps=steps, geo=geo,
                    spectra=spectra, cfg=cfg, n_iterations=int(n_iterations),
                    key=k if use_threefry else None, uniforms=uniforms,
                    bwd_fraction=float(bwd_fraction))
    return _ExpectedHist.apply(prob, *leaves)
