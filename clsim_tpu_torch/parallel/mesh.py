"""The differentiable ice-model fit (PyTorch counterpart of the fit part of
clsim_tpu.parallel.mesh).

IceFit fits per-layer ice parameters by gradient descent against target
hit-time histograms of the expected estimator.  The loss's forward runs on
the port's engine (forward="engine") or on the propagation kernel
(forward="fused": propagate_expected_diff, the CUDA kernel on CUDA tensors),
and its gradient is torch.autograd of the engine on the same threefry
stream.  The JAX package runs the same fit as one SPMD program over a jax
Mesh and all-reduces the gradients; here it runs in one process, and the
step key is folded with 0 exactly as the JAX package folds it with the
device index, so one step equals the JAX IceFit's on a one-device mesh.
The multi-process all_reduce of gradients, and make_sharded_propagate, are
queued (ROADMAP.md queue A item 14).

Three faults of the JAX IceFit are fixed here:
  * SCATTERING_FIT_PARAMS names `alpha` (the wavelength exponent of the
    scattering coefficient changes the sampled scatter distances, so it
    needs the score-function term like b400);
  * the probe that resolves which medium fields a param_transform
    overrides is not wrapped in a bare `except`: a transform that fails
    raises, instead of silently turning the score function off;
  * fitting `anisotropy` warns: neither estimator carries the Jacobian of
    the anisotropy's direction transform, so its gradient is biased.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.spectrum import SpectrumTable
from ..propagate import engine as E
from ..types import PropagationConfig, StepBatch

SHARDING_ITEM = ("multi-device sharding and the all_reduce of fit gradients "
                 "are queued (ROADMAP.md queue A item 14)")

# fold_in salt of two_sample's second stream (the JAX package's)
TWO_SAMPLE_SALT = 0x74776F


def make_sharded_propagate(*args, **kwargs):
    """The JAX package's SPMD propagate over a mesh: not ported yet."""
    raise NotImplementedError(SHARDING_ITEM)


def _replace_cfg(cfg: PropagationConfig, **kw) -> PropagationConfig:
    return dataclasses.replace(cfg, **kw)


class IceFit:
    """Gradient-descent fit of ice parameters against target histograms.

    step(fit_params, medium, steps, key, target_hist) -> (new_params, loss)
    takes a dict of parameter tensors (numpy arrays are converted to
    float32 tensors on the medium's device) and returns the updated dict
    (detached) and the loss."""

    # MediumProperties fields whose perturbation changes the sampling law of
    # scatter events: their gradients need the score-function term (the
    # detached estimator is wrong-signed on a beam workload, tests/
    # test_diff.py).  `alpha` is missing from the JAX package's set.
    SCATTERING_FIT_PARAMS = frozenset({"b400", "alpha", "anisotropy",
                                       "scattering"})

    def __init__(self, cfg: PropagationConfig, geo: DetectorGeometry,
                 spectra: SpectrumTable, learning_rate: float = 1e-3,
                 max_iterations: int = 64, forward: str = "engine",
                 score_function: Optional[bool] = None,
                 bwd_fraction: float = 1.0,
                 optimizer: Optional[Callable] = None,
                 param_transform: Optional[Callable] = None,
                 loss: str = "chi2", two_sample: bool = False):
        """forward='fused' routes the loss's forward through the kernel
        (propagate/diff.py); the engine serves only the backward.
        `score_function` adds the likelihood-ratio term so that
        scattering-parameter gradients are unbiased (costs variance); None
        resolves on the first step(): on when the fitted fields include a
        SCATTERING_FIT_PARAMS member, off otherwise; False while fitting
        scattering parameters warns.  `bwd_fraction` < 1 runs the backward
        on a random slot subset (forward='fused' only).

        `optimizer`: None for plain SGD with `learning_rate`, or a callable
        that makes a torch.optim optimizer from a list of parameter tensors
        (e.g. functools.partial(torch.optim.Adam, lr=0.05)); its state is
        carried across step() calls.  `param_transform` maps the
        fit-parameter dict to MediumProperties field overrides (fit in log
        space, fit a band of layers with the rest pinned, ...).

        `loss`: 'chi2' (sum (h - t)^2 / sum t) or 'poisson' (weights
        1 / (t + 1)).  `two_sample` differentiates against a residual taken
        on an independent second stream (an unbiased gradient of
        ||E[hist] - target||^2); the reported loss stays the plain
        residual."""
        if forward not in ("engine", "fused"):
            raise ValueError(f"unknown forward {forward!r}")
        if loss not in ("chi2", "poisson"):
            raise ValueError(f"unknown loss {loss!r}")
        if bwd_fraction < 1.0 and forward != "fused":
            raise ValueError("bwd_fraction < 1 needs forward='fused'")
        cfg_grad = cfg if cfg.estimator == "expected" else \
            _replace_cfg(cfg, estimator="expected", soft_binning=True)
        self._cfg_base = cfg_grad
        self._score_function = score_function
        self.cfg = cfg_grad if not score_function else \
            _replace_cfg(cfg_grad, score_function=True)
        self.geo = geo
        self.spectra = spectra
        self.lr = learning_rate
        self.max_iterations = int(max_iterations)
        self.forward = forward
        self.bwd_fraction = float(bwd_fraction)
        self.optimizer = optimizer
        self.param_transform = param_transform
        self.loss = loss
        self.two_sample = two_sample
        self._opt = None
        self._leaves = None
        self._warned = set()

    # -- the loss -----------------------------------------------------------

    @staticmethod
    def step_key(key):
        """The key of one step's stream: `key` folded with the process's
        rank, 0 (the JAX IceFit folds it with the device index)."""
        return rng.fold_in(rng.as_key(key), 0)

    def one_forward(self, medium: MediumProperties, steps: StepBatch, key):
        """The (n_doms, n_bins) expected histogram of one stream."""
        if self.forward == "fused":
            from ..propagate.diff import propagate_expected_diff
            return propagate_expected_diff(
                steps, medium, self.geo, self.spectra, key, self.cfg,
                n_iterations=self.max_iterations,
                bwd_fraction=self.bwd_fraction)
        return E.propagate(steps, medium, self.geo, self.spectra, 0,
                           self.cfg, max_iterations=self.max_iterations,
                           key=key).hist

    def loss_fn(self, fit_params: dict, medium: MediumProperties,
                steps: StepBatch, key, target_hist):
        """The fit loss at `fit_params` (differentiable in them)."""
        transform = self.param_transform or (lambda p: p)
        medium = medium._replace(**transform(fit_params))
        key = self.step_key(key)
        hist = self.one_forward(medium, steps, key)
        if self.loss == "poisson":
            w, scale = 1.0 / (target_hist + 1.0), 1.0
        else:
            w = 1.0
            scale = torch.clamp(target_hist.sum(), min=1.0)
        r1 = hist - target_hist
        monitor = (w * r1 * r1).sum() / scale
        if not self.two_sample:
            return monitor
        # an independent second sample for the residual factor: the gradient
        # of sum(w * r2 * r1), r2 held fixed, is unbiased for the gradient of
        # ||E hist - target||_w^2 (no Var(hist) penalty)
        with torch.no_grad():
            hist2 = self.one_forward(medium, steps,
                                     rng.fold_in(key, TWO_SAMPLE_SALT))
        surrogate = (w * (hist2 - target_hist) * r1).sum() * (2.0 / scale)
        # value = monitor, gradient = that of the surrogate
        return surrogate + (monitor - surrogate).detach()

    # -- one step -----------------------------------------------------------

    def _resolve(self, fit_params: dict):
        """Fields the fit overrides; resolves score_function=None and warns
        on the estimators' known biases."""
        eff = self.param_transform(fit_params) if self.param_transform \
            else fit_params
        keys = set(eff)
        scat = self.SCATTERING_FIT_PARAMS & keys
        if self._score_function is None:
            use_sf = bool(scat)
            self.cfg = _replace_cfg(self._cfg_base, score_function=use_sf)
            self._score_function = use_sf
        elif scat and not self._score_function and "scat" not in self._warned:
            self._warned.add("scat")
            warnings.warn(
                f"fitting scattering parameters {sorted(scat)} with "
                "score_function=False: the detached pathwise estimator's "
                "scattering gradient is biased (wrong-signed on a beam "
                "workload) -- pass score_function=True or leave it None",
                UserWarning, stacklevel=3)
        if "anisotropy" in keys and "aniso" not in self._warned:
            self._warned.add("aniso")
            warnings.warn(
                "fitting `anisotropy`: the gradient lacks the Jacobian of "
                "the anisotropy's direction transform (pre/post scatter), "
                "so it is biased; fit it by a scan or hold it fixed",
                UserWarning, stacklevel=3)

    def step(self, fit_params: dict, medium: MediumProperties,
             steps: StepBatch, key, target_hist):
        """One optimizer step.  Returns (new_params, loss)."""
        dev = medium.b400.device
        vals = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in fit_params.items()}
        self._resolve(vals)
        if self.optimizer is None:
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in vals.items()}
        else:
            if self._leaves is None:
                self._leaves = {k: v.detach().clone().requires_grad_(True)
                                for k, v in vals.items()}
                self._opt = self.optimizer(list(self._leaves.values()))
            leaves = self._leaves
            with torch.no_grad():
                for k, v in vals.items():
                    leaves[k].copy_(v)
        target = torch.as_tensor(target_hist, dtype=torch.float32,
                                 device=dev)
        loss = self.loss_fn(leaves, medium, steps, key, target)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves.values(), grads)]
        if self.optimizer is None:
            new = {k: (p - self.lr * g).detach()
                   for (k, p), g in zip(leaves.items(), grads)}
        else:
            for p, g in zip(leaves.values(), grads):
                p.grad = g
            self._opt.step()
            self._opt.zero_grad(set_to_none=True)
            new = {k: p.detach().clone() for k, p in leaves.items()}
        return new, loss.detach()
