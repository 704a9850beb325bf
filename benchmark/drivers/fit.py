"""A closed loop of ice-fit steps: IceFit(forward="fused") with Adam on the
flashes of one string (sources/<source>.py), one IceFit.step a call.

Set-up builds the program's world and slots, the target (the program's
forward at the truth on the run's threefry key, so the loss is 0 there)
and takes the traffic's `warmup_steps` from the seeded start; each call
then takes the next step from where the last one left the parameters.
photons_per_s is the slots of every step taken in the window over the
window.  The seeded start, every step's applied gradient, the parameters
the run ends at and the last step's start and loss are kept for the check
(reference/fit_check.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys

from benchmark import roofline_fit
from benchmark.reference import fit_check as FC
from benchmark.world import PROGRAM, exact_segment, program_world


def make_fit(world, conf: dict):
    """A fresh IceFit of the configuration on the program's world: Adam on
    the log scales of the fitted field's band, the kernel forward, the
    segment capped at exact_segment."""
    import torch
    from clsim_tpu_torch.parallel.mesh import IceFit
    fit = conf["fit"]
    cfg = dataclasses.replace(
        world.config, max_segment_m=exact_segment(world.geometry,
                                                  world.config))
    lo, hi = FC.band(world.medium, fit["band_z_m"])
    true = getattr(world.medium, fit["field"]).clone()
    field = fit["field"]

    def transform(p):
        return {field: torch.cat([true[:lo], true[lo:hi]
                                  * torch.exp(p["log_s"]), true[hi:]])}

    return IceFit(cfg, world.geometry, world.spectra, forward="fused",
                  max_iterations=fit["iterations"], loss=fit["loss"],
                  bwd_fraction=fit["bwd_fraction"], param_transform=transform,
                  optimizer=functools.partial(
                      torch.optim.Adam, lr=fit["learning_rate"],
                      betas=tuple(fit["adam_betas"]), eps=fit["adam_eps"]))


class Driver:
    kind = "fit"

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.conf = ctx.config
        self.src = ctx.source()
        self.n = int(self.conf["propagation"]["n_slots"])
        self.steps_done = 0
        self.failed = 0
        self.last = None
        self.grads = []

    def make_fit(self, world):
        """The program's fit (the control puts the reference in its
        place)."""
        return make_fit(world, self.conf)

    # -- set-up and the timed calls -----------------------------------------

    def set_up(self):
        import torch
        from clsim_tpu_torch.convert import steps_from_numpy
        from clsim_tpu_torch.parallel.mesh import IceFit
        if not hasattr(IceFit, "last_grads"):
            raise SystemExit("this program's IceFit keeps no last_grads: the "
                             "fit cell's check needs the gradient a step "
                             "applied")
        ctx, fit = self.ctx, self.conf["fit"]
        self.world = w = program_world(self.conf, ctx.device)
        self.steps = steps_from_numpy(self.src.slots(
            PROGRAM, w, self.conf, self.n, FC.slot_rng(ctx.seed))._asdict(),
            ctx.device)
        self.fit = self.make_fit(w)
        self.key = FC.fit_key(ctx.seed)
        with torch.no_grad():
            self.target = self.fit.one_forward(
                w.medium, self.steps, self.fit.step_key(self.key))
        lo, hi = FC.band(w.medium, fit["band_z_m"])
        self.p0 = FC.start(ctx.seed, hi - lo, fit["start_sigma"])
        self.p = {"log_s": torch.as_tensor(self.p0, device=ctx.device)}
        # warm-up: K1's instantiation, the engine's kernels, autograd's
        # device thread and the optimizer's state
        for _ in range(self.tr["warmup_steps"]):
            self._step()

    def _step(self):
        start = self.p["log_s"]
        self.p, loss = self.fit.step(self.p, self.world.medium, self.steps,
                                     self.key, self.target)
        value = float(loss)
        self.last = (start, value)
        self.grads.append(self.fit.last_grads["log_s"].clone())
        return value

    def call(self, i: int):
        self.steps_done += 1
        if not math.isfinite(self._step()):
            self.failed += 1

    def counts(self):
        return self.steps_done, self.failed

    def end_to_end(self, window: float, calls: int) -> dict:
        return {"photons_per_s": self.n * calls / window}

    # -- per-layer data ---------------------------------------------------

    def layer_data(self, summary: dict, window: float, calls: int) -> dict:
        k1 = sum(s for name, s in summary["kernel_s"].items()
                 if "propagate_kernel" in name)
        ops, nbytes = roofline_fit.k1_work(self.conf, self.world,
                                           self.fit.cfg, calls)
        return dict(driver=self.kind, busy_s=summary["busy_s"],
                    window_s=window, steps=calls,
                    launches=summary["launches"], k1_s=k1, k1_ops=ops,
                    k1_bytes=nbytes)

    # -- correctness --------------------------------------------------------

    def release(self):
        import torch
        start, loss = self.last
        self.last = (start.cpu().numpy(), loss)
        self.grads = [g.cpu().numpy() for g in self.grads]
        self.p_end = self.p["log_s"].cpu().numpy()
        del self.fit, self.world, self.steps, self.target, self.p
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> list:
        ctx = self.ctx
        (start, loss), grad = self.last, self.grads[-1]
        ref = FC.Reference(self.conf, ctx.seed, ctx.device, self.n)
        dirs = FC.directions(ctx.seed, start, self.tr["directions"])
        loss_gap, grad_gap, seen = FC.gaps(FC.readings(ref, start, dirs),
                                           dirs, loss, grad)
        param_gap, p_ref = FC.param_gap(self.conf, self.p0, self.grads,
                                        self.p_end)
        seen.update(steps=len(self.grads), p_end=self.p_end.tolist(),
                    p_ref=p_ref.tolist())
        print(f"fit check: {seen}", file=sys.stderr)
        lim = self.tr["limits"]
        return [("loss_gap", loss_gap, lim["loss_gap"]),
                ("grad_gap", grad_gap, lim["grad_gap"]),
                ("param_gap", param_gap, lim["param_gap"])]
