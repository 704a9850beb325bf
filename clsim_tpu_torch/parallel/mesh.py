"""Photon sharding over ranks and the differentiable ice-model fit
(PyTorch counterpart of clsim_tpu.parallel.mesh).

The JAX package shards the slot axis of a step batch over a jax Mesh and
runs one SPMD program; every shard propagates its slots with no
communication, then the histograms and counters are psum-reduced.  Here
the same run is one process per rank of a torch.distributed process group
(parallel/bootstrap.py): a PhotonMesh names this process's rank, the group
and the rank's device, `shard_steps` takes this rank's contiguous slot
slice, and `make_sharded_propagate` propagates it and all-reduces the
result, so every rank returns the same PropagationResult.  One process
driving several GPUs is not supported.  Without a process group a mesh has
one rank and the collectives are skipped.

IceFit fits per-layer ice parameters by gradient descent against target
hit-time histograms of the expected estimator.  The loss's forward runs on
the port's engine (forward="engine") or on the propagation kernel
(forward="fused": propagate_expected_diff, the CUDA kernel on CUDA tensors),
and its gradient is torch.autograd of the engine on the same threefry
stream.  On a mesh each rank propagates its own slots with the step key
folded by its rank (as the JAX package folds it with the device index),
the loss reads the all-reduced histogram, and each rank's gradient
dL/dH . dh_r/dp is all-reduced after its own backward, so every rank takes
the same step along the gradient of the loss.

Faults of the JAX package fixed here:
  * the JAX IceFit differentiates inside its shard_map, whose transpose of
    psum is a psum: each shard's gradient is N dL/dH . dh_r/dp on N
    devices, nothing sums the shards, and the step returns shard 0's
    parameters, so it moves along N times shard 0's term instead of the
    gradient (ROADMAP.md queue C, C4).  Here the all-reduce of the forward
    leaves the gradient's scale alone and the gradients are summed;
  * the JAX sharded propagate returns no photon records, so a mesh-built
    simulate_hits there reads none; here save_photons on a mesh is refused
    (C2);
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
import os
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..convert import steps_from_numpy
from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.spectrum import SpectrumTable
from ..propagate import engine as E
from ..propagate.dispatch import ITERS_PER_CALL, backend_reason
from ..propagate.kernel import propagate_fused
from ..types import PropagationConfig, StepBatch
from ..util import profiling as P

# the name of the JAX package's mesh axis; here the ranks are that axis
PHOTON_AXIS = "photons"
RECORDS_REFUSED = (
    "photon records are not gathered over a mesh (ROADMAP.md queue C, C2): "
    "the JAX package's sharded propagate returns none; run save_photons "
    "without mesh=")
# fold_in salt of two_sample's second stream (the JAX package's)
TWO_SAMPLE_SALT = 0x74776F
# the kernel body's seed offset a rank (clsim_tpu/parallel/mesh.py:138)
RANK_SEED_STRIDE = 1000003


def local_rank(rank: int) -> int:
    """This process's index on its host: torchrun's LOCAL_RANK, Open MPI's
    OMPI_COMM_WORLD_LOCAL_RANK, else the global rank."""
    for var in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return int(rank)


@dataclasses.dataclass(frozen=True)
class PhotonMesh:
    """This process's place in a photon-sharded run: its rank and the
    number of ranks in `group` (None: the default group), the device its
    slots live on, and whether a process group exists (`active`; without
    one the mesh has one rank and no collective runs)."""
    group: object
    rank: int
    size: int
    device: torch.device
    active: bool

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce `t` in place over the ranks (sum or max); returns it."""
        if self.active:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX, group=self.group)
        return t


def make_mesh(group=None, device=None) -> PhotonMesh:
    """The mesh of `group` (None: the default process group) for this
    process; a one-rank mesh when torch.distributed is not initialized.
    `device` defaults to cuda:{local_rank % device_count}."""
    active = dist.is_available() and dist.is_initialized()
    if active:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group needs torch.distributed "
                         "initialized (parallel/bootstrap.py)")
    else:
        rank, size = 0, 1
    if device is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device for this rank: pass "
                               "device='cpu' to run the mesh on the CPU")
        device = torch.device("cuda", local_rank(rank) % n)
    return PhotonMesh(group=group, rank=int(rank), size=int(size),
                      device=torch.device(device), active=active)


def shard_steps(batch: StepBatch, mesh: PhotonMesh) -> StepBatch:
    """This rank's contiguous slot slice of a globally slot-assigned step
    batch (host arrays or tensors), on the rank's device."""
    n = int(batch.x.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} slots not divisible by {mesh.size} ranks")
    per = n // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    if isinstance(batch.x, torch.Tensor):
        return StepBatch(*[f[sl].to(mesh.device) for f in batch])
    return steps_from_numpy({k: v[sl] for k, v in batch._asdict().items()},
                            mesh.device)


def shard_seed(key, rank: int) -> int:
    """The kernel body's seed of `rank`, derived from a threefry key as the
    JAX shard body derives it (clsim_tpu/parallel/mesh.py:135-138, uint32
    then int32 arithmetic): ((k[-1] ^ (k[0] << 16)) & 0x7fffffff) + rank *
    1000003."""
    k = [int(v) & rng.MASK for v in rng.as_key(key).tolist()]
    s = (k[-1] ^ ((k[0] << 16) & rng.MASK)) & 0x7FFFFFFF
    s = (s + int(rank) * RANK_SEED_STRIDE) & rng.MASK
    return s - (1 << 32) if s >= (1 << 31) else s


def all_reduce_result(res: E.PropagationResult, mesh: PhotonMesh
                      ) -> E.PropagationResult:
    """The result summed over the ranks (histogram, counts, hit weight and
    the kernel's counters; iterations by max), in two collectives: one sum
    of a float64 buffer holding the histogram with the scalars and counters
    beside it, one max."""
    hist, dev = res.hist, res.hist.device
    scalars = torch.stack([torch.as_tensor(v, device=dev).to(torch.float64)
                           for v in (res.n_generated, res.n_hits,
                                     res.weight_hits)])
    parts = [hist.reshape(-1).to(torch.float64), scalars]
    if res.diag_totals is not None:
        parts.append(res.diag_totals.to(torch.float64))
    buf = mesh.all_reduce_(torch.cat(parts))
    iters = mesh.all_reduce_(torch.tensor([int(res.n_iterations)],
                                          dtype=torch.int64, device=dev),
                             op="max")
    nh = hist.numel()
    return E.PropagationResult(
        hist=buf[:nh].to(hist.dtype).reshape(hist.shape),
        n_generated=buf[nh], n_hits=buf[nh + 1], weight_hits=buf[nh + 2],
        n_iterations=int(iters.item()),
        diag_totals=None if res.diag_totals is None else buf[nh + 3:])


def make_sharded_propagate(mesh: PhotonMesh, cfg: PropagationConfig,
                           backend: str = "auto",
                           medium: Optional[MediumProperties] = None,
                           geo: Optional[DetectorGeometry] = None,
                           spectra: Optional[SpectrumTable] = None,
                           max_calls: int = 256, with_uniforms: bool = False,
                           **fused_opts):
    """A propagate over the mesh: run(steps, medium, geo, spectra, key)
    propagates this rank's slot slice (shard_steps; cfg.n_slots slots a
    rank) and returns the result all-reduced over the ranks, the same on
    every rank.  `key` is a threefry key (ops/rng.py).

    The kernel body serves the run when the configuration is supported
    (dispatch.backend_reason on the build-time medium, geo and spectra) and
    the rank's device is CUDA: it seeds the fused call loop
    (kernel.propagate_fused, `max_calls`, with balance off) with
    shard_seed(key, rank).  `fused_opts` are iters_per_call and repack
    (default True), as the JAX shard body takes them; the engine body
    accepts and ignores them, as the JAX one never reads them.  Otherwise
    the engine body propagates with key folded by the rank (rng.fold_in),
    the JAX shard's own stream.  backend="engine" asks for the engine,
    backend="fused" for the kernel body (its plain version on CPU tensors)
    and raises when the configuration is unsupported; "auto" records in
    run.backend_reason why it served the engine: the build-time arguments
    are missing, or the rank's device is not CUDA.  On a CUDA device an
    unsupported configuration raises, as dispatch.propagate_auto does.

    `with_uniforms` builds the parity variant: run takes a sixth argument,
    a (T, 8, cfg.n_slots * mesh.size) uniform stream, of which rank r reads
    the columns of its slots [r * n_slots, (r + 1) * n_slots), and runs
    one call of T iterations of the kernel body, which never repacks: a
    `repack` option there raises TypeError, as the JAX rule `repack =
    (not with_uniforms) and fused_opts.pop("repack", True)` leaves the
    key unread and its check of the options raises.

    Photon records are refused (RECORDS_REFUSED)."""
    if backend not in ("auto", "engine", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    if cfg.save_photons:
        raise ValueError(RECORDS_REFUSED)
    unknown = set(fused_opts) - {"iters_per_call", "repack"}
    if unknown:
        raise TypeError(f"unknown fused options: {sorted(unknown)}")
    reason = None
    if backend != "engine":
        if medium is None or geo is None or spectra is None:
            reason = "build-time medium/geo/spectra not provided"
        else:
            reason = backend_reason(medium, spectra, cfg, geo, cfg.n_slots)
            if reason is not None and mesh.device.type == "cuda":
                # as propagate_auto: a CUDA run never drops to the engine
                raise ValueError(f"sharded fused path unsupported: {reason}")
            if reason is None and backend == "auto" \
                    and mesh.device.type != "cuda":
                reason = (f"the rank's device is {mesh.device}: the CUDA "
                          "kernel runs on CUDA devices")
    use_fused = backend != "engine" and reason is None
    if backend == "fused" and not use_fused:
        raise ValueError(f"sharded fused path unsupported: {reason}")
    if with_uniforms and not use_fused:
        raise ValueError("with_uniforms runs the kernel body: "
                         f"{reason or 'backend=engine'}")
    if with_uniforms and "repack" in fused_opts:
        raise TypeError("unknown fused options: ['repack']")

    def run(steps: StepBatch, medium, geo, spectra, key, uniforms=None):
        if int(steps.x.shape[0]) != cfg.n_slots:
            raise ValueError(f"run takes this rank's {cfg.n_slots} slots "
                             f"(shard_steps), got {int(steps.x.shape[0])}")
        if (uniforms is not None) != with_uniforms:
            raise ValueError("the uniform stream is the sixth argument of "
                             "a with_uniforms build, and only of one")
        if not use_fused:
            res = E.propagate(steps, medium, geo, spectra, 0, cfg,
                              key=rng.fold_in(rng.as_key(key), mesh.rank))
            return all_reduce_result(res, mesh)
        opts = dict(fused_opts)
        repack = opts.pop("repack", True) and not with_uniforms
        calls = max_calls
        if with_uniforms:
            lo = mesh.rank * cfg.n_slots
            uniforms = torch.as_tensor(uniforms)[:, :, lo:lo + cfg.n_slots]
            uniforms = uniforms.to(steps.x.device).contiguous()
            opts.setdefault("iters_per_call", int(uniforms.shape[0]))
            calls = 1
        opts.setdefault("iters_per_call", ITERS_PER_CALL)
        res, _ = propagate_fused(steps, medium, geo, spectra,
                                 shard_seed(key, mesh.rank), cfg,
                                 max_calls=calls, uniforms=uniforms,
                                 repack=repack, balance=False, **opts)
        return all_reduce_result(res, mesh)

    run.backend = "fused" if use_fused else "engine"
    run.backend_reason = reason
    return run


def _replace_cfg(cfg: PropagationConfig, **kw) -> PropagationConfig:
    return dataclasses.replace(cfg, **kw)


class IceFit:
    """Gradient-descent fit of ice parameters against target histograms.

    step(fit_params, medium, steps, key, target_hist) -> (new_params, loss)
    takes a dict of parameter tensors (numpy arrays are converted to
    float32 tensors on the medium's device) and returns the updated dict
    (detached) and the loss.  With a `mesh`, `steps` is this rank's slot
    slice (shard_steps) and every rank returns the same parameters and
    loss."""

    # the gradient the last step() applied, {name: tensor} (all-reduced on
    # a mesh); None before the first step
    last_grads = None

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
                 loss: str = "chi2", two_sample: bool = False,
                 mesh: Optional[PhotonMesh] = None):
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
        residual.

        `mesh` (make_mesh / bootstrap.global_photon_mesh) shards the slots
        over ranks: the histogram is all-reduced, and so are the
        gradients after each rank's backward."""
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
        self.mesh = mesh
        self._opt = None
        self._leaves = None
        self._warned = set()
        self._steps = 0

    # -- the loss -----------------------------------------------------------

    def step_key(self, key):
        """The key of this rank's stream in one step: `key` folded with the
        rank (0 without a mesh), as the JAX IceFit folds it with the device
        index."""
        return rng.fold_in(rng.as_key(key),
                           0 if self.mesh is None else self.mesh.rank)

    def all_reduced(self, hist: torch.Tensor) -> torch.Tensor:
        """The histogram summed over the ranks, with the gradient of this
        rank's own: its value is the sum, and autograd through it reaches
        only `hist` with an unchanged scale (dL/dH . dh_r/dp).  An
        all_reduce whose backward sums dL/dH over the ranks would scale
        every rank's gradient by their number, as the JAX IceFit's does."""
        if self.mesh is None or not self.mesh.active:
            return hist
        total = self.mesh.all_reduce_(hist.detach().clone())
        return total + (hist - hist.detach())

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
        hist = self.all_reduced(self.one_forward(medium, steps, key))
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
            hist2 = self.all_reduced(self.one_forward(
                medium, steps, rng.fold_in(key, TWO_SAMPLE_SALT)))
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
        """One optimizer step.  Returns (new_params, loss); the gradient it
        applied is kept in `last_grads`.

        Spans and counters are recorded while a torch.profiler runs on the
        calling thread (profiling's follow_profiler): the root "fit_step"
        (the step's index as batch=), with "fit_forward" and
        "fit_optimizer" inside it; the backward's spans (propagate/diff.py)
        lie on autograd's device thread on CUDA tensors."""
        with P.follow_profiler(), P.span("fit_step", batch=self._steps):
            self._steps += 1
            return self._step(fit_params, medium, steps, key, target_hist)

    def _step(self, fit_params, medium, steps, key, target_hist):
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
        with P.span("fit_optimizer"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves.values(), grads)]
            if self.mesh is not None and self.mesh.active:
                # every rank's dL/dH . dh_r/dp, summed: the gradient of the
                # loss
                flat = self.mesh.all_reduce_(torch.cat([g.reshape(-1)
                                                        for g in grads]))
                grads = [f.reshape(g.shape) for f, g in zip(
                    torch.split(flat, [g.numel() for g in grads]), grads)]
            self.last_grads = {k: g.detach()
                               for k, g in zip(leaves, grads)}
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
