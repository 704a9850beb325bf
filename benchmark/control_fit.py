"""The planted faults and the control of the fit cell's correctness check,
on the card at the cell's own size (the benchmark's runs never run them):

    python benchmark/control_fit.py --workload ic86-icefit.adam --seeds 11 12 13

For each seed it sets the cell's driver up as a run does (the program's
world, slots and target, the warm-up step from the seeded start), then
takes one step from where the warm-up left the fit (its parameters and its
optimizer's state) with each variant below and judges it against the
float32 reference (reference/fit_check.py) with the functions a run's
check uses:

  program      the program as it is: sound readings;
  sign_flip    the program's histogram passed on with its value and the
               opposite derivative (2 h.detach() - h): the step applies the
               sign-flipped gradient and keeps it;
  leaf_zeroed  the leaf of the warm-up step's largest |gradient| (the most
               illuminated layer) held out of autograd: its gradient is 0;
  dom_shift    the program's histogram rolled by one DOM (the target
               stays as set-up made it);
  step_skipped the optimizer's step left out: the parameters stay;
  lr_doubled   the optimizer at twice the configuration's learning rate.

Then it runs the cell through the harness (run_cell, `--seconds 1`) with
the control in the program's place:

  control      the reference computed in bfloat16 (reference/lowp.py), the
               nearest precision below the float32 the configuration
               states: its histogram (the target's too) from the frozen
               engine under lowp.Bfloat16 on its own slots, its gradient
               autograd's through it, its update fit_check.Adam with every
               intermediate rounded to bfloat16.

Prints one JSON line a seed.  FAULTS and `planted` serve the CPU tests too.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def sign_flip(driver):
    fit = driver.fit
    inner = fit.one_forward

    def flipped(medium, steps, key):
        h = inner(medium, steps, key)
        return 2.0 * h.detach() - h

    fit.one_forward = flipped


def leaf_zeroed(driver):
    import torch
    k = int(np.argmax(np.abs(np.asarray(driver.grads[-1].cpu()))))
    fit = driver.fit
    inner = fit.param_transform

    def pinned(p):
        s = p["log_s"]
        held = torch.zeros_like(s)
        held[k] = 1.0
        return inner({"log_s": s * (1.0 - held) + (s * held).detach()})

    fit.param_transform = pinned


def dom_shift(driver):
    import torch
    fit = driver.fit
    inner = fit.one_forward
    fit.one_forward = lambda medium, steps, key: torch.roll(
        inner(medium, steps, key), 1, dims=0)


def step_skipped(driver):
    driver.fit._opt.step = lambda *args, **kwargs: None


def lr_doubled(driver):
    for group in driver.fit._opt.param_groups:
        group["lr"] *= 2.0


FAULTS = {"sign_flip": sign_flip, "leaf_zeroed": leaf_zeroed,
          "dom_shift": dom_shift, "step_skipped": step_skipped,
          "lr_doubled": lr_doubled}


def _bf16(x) -> np.ndarray:
    """x rounded to bfloat16, as float64."""
    import torch
    t = torch.from_numpy(np.asarray(x, np.float32).copy())
    return t.to(torch.bfloat16).to(torch.float32).numpy().astype(np.float64)


class Bfloat16Adam:
    """The configuration's Adam (fit_check.Adam) with every intermediate
    rounded to bfloat16, in the place of IceFit's optimizer."""

    def __init__(self, params, conf: dict):
        from benchmark.reference import fit_check as FC
        self.params = list(params)
        self.opts = [FC.adam_of(conf, p.detach().cpu().numpy(), _bf16)
                     for p in self.params]

    def step(self):
        import torch
        with torch.no_grad():
            for p, opt in zip(self.params, self.opts):
                opt.p = _bf16(p.cpu().numpy())
                new = opt.step(p.grad.cpu().numpy())
                p.copy_(torch.as_tensor(new, dtype=p.dtype))

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            p.grad = None


def control(driver):
    """Puts the bfloat16 reference in the program's place (before set-up,
    so the target is the control's own)."""
    from benchmark.drivers.fit import make_fit
    from benchmark.reference import fit_check as FC
    from benchmark.reference.lowp import Bfloat16
    ctx, conf = driver.ctx, driver.conf
    field = conf["fit"]["field"]

    def make(world):
        fit = make_fit(world, conf)
        ref = FC.Reference(conf, ctx.seed, ctx.device, driver.n,
                           mode=Bfloat16)
        fit.one_forward = lambda medium, steps, key: ref.propagate(
            getattr(medium, field))
        fit.optimizer = lambda params: Bfloat16Adam(params, conf)
        return fit

    driver.make_fit = make


def planted(fault: str):
    """A harness patch (run_cell(patch=)) that plants `fault` in the timed
    path once the driver's set-up (the target, the warm-up) is done, or
    puts the control in the program's place."""
    def install(ctx, driver):
        if fault == "control":
            control(driver)
            return
        set_up = driver.set_up

        def set_up_then_plant():
            set_up()
            FAULTS[fault](driver)

        driver.set_up = set_up_then_plant
    return install


def fit_control(conf, traffic, src, seed: int, device) -> dict:
    """{variant: {loss_gap, grad_gap, param_gap}} of one seed, and what
    each compared."""
    import copy
    from benchmark.drivers.fit import Driver
    from benchmark.reference import fit_check as FC
    ctx = SimpleNamespace(config=conf, traffic=traffic, seed=seed,
                          device=device, source=lambda: src)
    drv = Driver(ctx)
    drv.set_up()
    warm_fit, start, warm, warm_grads = drv.fit, drv.p, drv.last, drv.grads
    keep = {id(warm_fit.geo): warm_fit.geo,
            id(warm_fit.spectra): warm_fit.spectra}
    kept = {}
    for name in ["program", *FAULTS]:
        drv.fit = copy.deepcopy(warm_fit, dict(keep))
        drv.p, drv.last, drv.grads = start, warm, list(warm_grads)
        if name in FAULTS:
            FAULTS[name](drv)
        drv._step()
        kept[name] = (drv.last[1], np.asarray(drv.grads[-1].cpu()),
                      [np.asarray(g.cpu()) for g in drv.grads],
                      np.asarray(drv.p["log_s"].cpu()))
    p, p0, n = np.asarray(start["log_s"].cpu()), drv.p0, drv.n
    drv.fit = warm_fit
    drv.release()
    del drv, warm_fit
    ref = FC.Reference(conf, seed, device, n)
    dirs = FC.directions(seed, p, traffic["directions"])
    seen = FC.readings(ref, p, dirs)
    out, detail = {}, {}
    for name, (loss, grad, grads, p_end) in kept.items():
        lg, gg, detail[name] = FC.gaps(seen, dirs, loss, grad)
        pg, _ = FC.param_gap(conf, p0, grads, p_end)
        out[name] = dict(loss_gap=lg, grad_gap=gg, param_gap=pg)
    out["compared"] = detail
    return out


def control_run(workload: str, seed: int, seconds: float) -> dict:
    """The harness's run of the cell with the control in the program's
    place: its result line's object."""
    from benchmark.harness import run_cell
    return run_cell(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", "0"],
                    time.perf_counter(), patch=planted("control"))


def main(argv) -> int:
    import argparse
    from benchmark.harness import HERE, cell_of, find, load_module, load_spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cell_of(load_spec(), args.workload)
    conf = json.loads(find("configs", cell["config"], ".json",
                           [HERE]).read_text())
    traffic = json.loads(find("traffic", cell["traffic"], ".json",
                              [HERE]).read_text())
    src = load_module("sources", traffic["source"], [HERE])
    import torch
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = fit_control(conf, traffic, src, seed, "cuda")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        run = control_run(args.workload, seed, 1.0)
        torch.cuda.empty_cache()
        out["control"] = dict(correct=run["correct"], checks=run["checks"],
                              attempted=run["attempted"],
                              failed=run["failed"],
                              memory_peak_bytes=run["device"][
                                  "memory_peak_bytes"],
                              seconds=time.perf_counter() - t1)
        out.update(workload=args.workload, seed=seed,
                   limits=traffic["limits"], seconds=t1 - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
