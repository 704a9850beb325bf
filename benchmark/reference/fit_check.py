"""The fit cell's correctness: the last step of the window against a plain
reference of the same fit.

The reference is the frozen engine (reference/frozen/propagate/engine.py,
plain torch, float32, TF32 off) in threefry key mode: iteration i draws
rng.uniforms(rng.iter_key(key, i), (N,), 8), the draws the program's
kernel makes in-kernel for the same key.  It builds its own world, slots
and target from the configuration's numbers (world.reference_world,
sources/flash_string.py) and takes nothing the program made but the fit
parameters the program's optimizer reached and the key.  Its loss is the
plain chi2 written out below, its gradient a central difference of that
loss along a direction: no autograd anywhere.

Numbers compared, at the parameters p the last step started from:

  loss_gap  |L_prog - L_ref(p)| / L_ref(p), L_prog the loss the step
            reported;
  grad_gap  the worst over `directions` seeded random unit directions d of
            the fitted leaves of |d . g_prog - FD_ref(d)| / |FD_ref(d)|,
            g_prog the gradient the step applied (IceFit.last_grads) and
            FD_ref(d) = (L_ref(p + h d) - L_ref(p - h d)) / (2 h).  The gap
            is signed: a gradient of the wrong sign reads about 2;

and over the whole run:

  param_gap |p_prog - p_ref| / |p_ref - p_0|, p_0 the seeded start,
            p_prog the parameters the run's last step returned, and p_ref
            those that Adam, written out below in float64, reaches from
            p_0 applying the gradient each step of the run applied (the
            set-up's warm-up too) in turn.  A run whose optimizer never
            stepped reads 1, one at twice the learning rate about 1.

Each direction is the unit vector of p/|p| (the way from the truth, at 0,
to p) plus a seeded random unit vector.  A direction drawn wholly at
random among 69 leaves lies nearly orthogonal to the gradient now and
then (its cosine with it is about N(0, 1/69)), and there the central
difference's own error, a few 1e-4 of |g| (tests on a small world), rules
the gap; near the truth the gradient points away from it, so the half
along p keeps each direction's cosine with the gradient well away from 0.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.sources import flash_string
from benchmark.world import REFERENCE, pkg, reference_world

# the central difference's step in the log scales (chip_smoke's gate)
FD_STEP = 0.02


def chi2(hist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sum((h - t)^2) / sum(t), the fit's chi2 loss (the target's sum held
    at 1 or more, as the program's)."""
    r = hist - target
    return (r * r).sum() / torch.clamp(target.sum(), min=1.0)


def band(medium, band_z) -> tuple:
    """[lo, hi) of the layers whose centres lie inside band_z (m)."""
    L = int(medium.n_layers)
    centres = float(medium.layers_z_start) + (np.arange(L) + 0.5) * \
        float(medium.layer_height)
    inside = np.nonzero((centres > band_z[0]) & (centres < band_z[1]))[0]
    return int(inside[0]), int(inside[-1]) + 1


def fit_key(seed: int) -> list:
    """The run's threefry key (two 32-bit words) from its seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 20]))
    return [int(v) for v in rng.integers(0, 2 ** 32, 2)]


def slot_rng(seed: int):
    """The generator both sides draw the run's slots from."""
    return np.random.default_rng(np.random.SeedSequence([seed, 21]))


def start(seed: int, n: int, sigma: float) -> np.ndarray:
    """The fit's start: log scales drawn N(0, sigma) (a lognormal
    perturbation of the scales) from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 22]))
    return rng.normal(0.0, sigma, n).astype(np.float32)


def directions(seed: int, p, k: int) -> np.ndarray:
    """k seeded random unit directions of p's leaves, (k, n) float32: each
    the unit vector of p/|p| plus a random unit vector."""
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    p = np.asarray(p, np.float64)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 23]))
    return unit(unit(p) + unit(rng.standard_normal((k, len(p))))
                ).astype(np.float32)


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad) written out:
    step(g) applies the gradient g to the parameters p and returns them.
    In float64, or with every intermediate passed through `rnd` (the
    control's bfloat16)."""

    def __init__(self, p0, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 rnd=None):
        self.rnd = rnd or (lambda x: x)
        self.p = self.rnd(np.asarray(p0, np.float64))
        self.m = np.zeros_like(self.p)
        self.v = np.zeros_like(self.p)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0

    def step(self, g) -> np.ndarray:
        r = self.rnd
        g = r(np.asarray(g, np.float64))
        self.t += 1
        self.m = r(self.b1 * self.m + (1.0 - self.b1) * g)
        self.v = r(self.b2 * self.v + (1.0 - self.b2) * g * g)
        m_hat = r(self.m / (1.0 - self.b1 ** self.t))
        v_hat = r(self.v / (1.0 - self.b2 ** self.t))
        self.p = r(self.p - r(self.lr * r(m_hat / r(np.sqrt(v_hat)
                                                      + self.eps))))
        return self.p


def adam_of(conf: dict, p0, rnd=None) -> Adam:
    """The configuration's Adam from p0."""
    fit = conf["fit"]
    return Adam(p0, fit["learning_rate"], tuple(fit["adam_betas"]),
                fit["adam_eps"], rnd)


def param_gap(conf: dict, p0, grads, p_prog) -> tuple:
    """(param_gap, p_ref): the parameters the program's run reached against
    the configuration's Adam applying the run's gradients from p0."""
    opt = adam_of(conf, p0)
    for g in grads:
        opt.step(g)
    p_ref, p0 = opt.p, np.asarray(p0, np.float64)
    gap = np.linalg.norm(np.asarray(p_prog, np.float64) - p_ref) / \
        np.linalg.norm(p_ref - p0)
    return float(gap), p_ref


class Reference:
    """The fit on the frozen package: its slots, its target at the truth
    and its loss at any log scales of the band.  `mode` (a context
    manager's factory) is entered around every propagation: the control
    passes lowp.Bfloat16."""

    def __init__(self, conf: dict, seed: int, device, n_slots: int = None,
                 mode=contextlib.nullcontext):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rng = pkg(REFERENCE, "ops.rng")
        conv = pkg(REFERENCE, "convert")
        self.E = pkg(REFERENCE, "propagate.engine")
        fit = conf["fit"]
        n = n_slots or conf["propagation"]["n_slots"]
        self.world = world = reference_world(conf, device)
        # reference_world caps the segment at world.exact_segment
        self.cfg = dataclasses.replace(world.config, n_slots=n)
        self.T = int(fit["iterations"])
        self.steps = conv.steps_from_numpy(flash_string.slots(
            REFERENCE, world, conf, n, slot_rng(seed))._asdict(), device)
        # IceFit's stream of one rank: the run's key folded with rank 0
        self.key = rng.fold_in(rng.as_key(fit_key(seed), device), 0)
        self.lo, self.hi = band(world.medium, fit["band_z_m"])
        self.true = getattr(world.medium, fit["field"]).clone()
        self.field = fit["field"]
        self.device = device
        self.mode = mode
        self._target = None

    @property
    def target(self) -> torch.Tensor:
        """The histogram at the truth (made on first use)."""
        if self._target is None:
            self._target = self.hist(np.zeros(self.hi - self.lo, np.float32))
        return self._target

    def propagate(self, field: torch.Tensor) -> torch.Tensor:
        """The (n_doms, n_bins) expected histogram with the fitted field at
        `field` (differentiable in it where grad is enabled)."""
        medium = self.world.medium._replace(**{self.field: field})
        with self.mode():
            return self.E.propagate(
                self.steps, medium, self.world.geometry, self.world.spectra,
                0, self.cfg, max_iterations=self.T, key=self.key).hist

    def hist(self, log_s) -> torch.Tensor:
        """The histogram with the band's scales at exp(log_s)."""
        s = torch.as_tensor(np.asarray(log_s, np.float32),
                            device=self.device)
        t = self.true
        field = torch.cat([t[:self.lo], t[self.lo:self.hi] * torch.exp(s),
                           t[self.hi:]])
        with torch.no_grad():
            return self.propagate(field)

    def loss(self, log_s) -> float:
        return float(chi2(self.hist(log_s), self.target))


def readings(ref, p, dirs, h: float = FD_STEP):
    """(L_ref(p), [FD_ref(d) for d in dirs]) of `ref` (anything with
    loss(log_s)) at p."""
    p = np.asarray(p, np.float64)
    fds = [(ref.loss(p + h * d) - ref.loss(p - h * d)) / (2.0 * h)
           for d in np.asarray(dirs, np.float64)]
    return ref.loss(p), fds


def gaps(seen, dirs, loss_prog: float, grad_prog):
    """(loss_gap, grad_gap, what was compared) of a step that reported
    loss_prog and applied grad_prog, against the reference's readings
    `seen` (readings()) along each direction of dirs."""
    l_ref, fds = seen
    g = np.asarray(grad_prog, np.float64)
    loss_gap = abs(float(loss_prog) - l_ref) / l_ref
    per_dir = []
    for d, fd in zip(np.asarray(dirs, np.float64), fds):
        dg = float(d @ g)
        per_dir.append(dict(d_dot_g=dg, fd=fd, gap=abs(dg - fd) / abs(fd)))
    return loss_gap, max(x["gap"] for x in per_dir), dict(
        l_ref=l_ref, l_prog=float(loss_prog), directions=per_dir)
