"""The control and the planted faults of the stream cells' correctness
check, on the card at a cell's own sizes (the benchmark's runs never run
them):

    python benchmark/control.py --workload <cell> --seeds 11 12 13
        [--what all|program|control] [--cap <iterations>]

For each seed it draws the run's `check_events` events of the pool, makes
the float32 reference of each (reference/stream_check.py) and judges
against it, exactly as a run judges its kept events (drivers/stream.judge):
  program     the program's own events (EventPipeline.process): sound
              readings;
  dom_shift   those histograms with every hit credited to the next DOM;
  time_shift  ... with every hit TIME_SHIFT bins late;
  weight_x2   ... with every deposit twice its weight / bias;
  control     the reference in the program's place computed in bfloat16
              (reference/lowp.py), the nearest precision below the float32
              the configuration states, over CONTROL_PHOTONS photons of
              the event (the control's event is its sample, so its
              generated count is exact).
Prints one JSON line a seed.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# iterations a chunk of the control may take: bfloat16 budgets that stop
# decreasing would keep photons alive for ever (in float32 a photon would
# need kilometres of path, a dozen absorption lengths, to outlive it)
CONTROL_CAP = 1000
# photons of each checked event the control propagates
CONTROL_PHOTONS = 262144
TIME_SHIFT = 4

FAULTS = {
    "dom_shift": lambda h: np.roll(h, 1, axis=0),
    "time_shift": lambda h: np.roll(h, TIME_SHIFT, axis=1),
    "weight_x2": lambda h: 2.0 * h,
}


def readings(zs: dict, limits: dict) -> dict:
    from benchmark.drivers.stream import judge
    return {k: {name: v for name, v, _ in judge(z, limits, 0.0)
                if name != "lost_photons"} for k, z in zs.items()}


def stream_control(conf, traffic, src, seed: int, device,
                   cap: int = CONTROL_CAP, program: bool = True,
                   control: bool = True) -> dict:
    """{variant: {number: reading}} on `check_events` events of the pool
    drawn from `seed`; `program` and `control` choose the variants."""
    from benchmark.reference import stream_check as SC
    from benchmark.reference.lowp import Bfloat16
    from benchmark.world import PROGRAM, program_world, reference_world
    world = reference_world(conf, device)
    pool = src.pool(traffic, conf)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 9]))
    pick = rng.choice(len(pool), traffic["check_events"], replace=False)
    n = traffic["check_photons"]
    refs = [SC.reference_event(world, src, pool[int(k)], seed + int(k), n,
                               device) for k in pick]
    zs = {"control": []} if control else {}
    for k, ref in zip(pick if control else (), refs):
        steps, _ = SC.event_steps(world, src, pool[int(k)],
                                  np.random.default_rng(np.random.SeedSequence(
                                      [seed, 10, int(k)])))
        sample = SC.one_photon_sample(steps, min(n, CONTROL_PHOTONS), rng)
        with Bfloat16():
            hist, (gen, hits, _) = SC.propagate_sample(
                world, sample, seed + 7, device, records=False, cap=cap)
        mean_gen, ref.mean_gen = ref.mean_gen, gen
        zs["control"].append(SC.event_z(hist, gen, hits, ref))
        ref.mean_gen = mean_gen
    if program:
        from clsim_tpu_torch.parallel.pipeline import EventPipeline
        pw = program_world(conf, device)
        pipe = EventPipeline(pw.sim, max_in_flight=traffic["max_in_flight"])
        res = pipe.process([src.sources(PROGRAM, pw, pool[int(k)])
                            for k in pick], seed=seed)
        zs["program"] = [SC.event_z(r.hist, r.n_generated, r.n_hits, ref)
                         for r, ref in zip(res, refs)]
        for name, fault in FAULTS.items():
            zs[name] = [SC.event_z(fault(np.asarray(r.hist, np.float64)),
                                   r.n_generated, r.n_hits, ref)
                        for r, ref in zip(res, refs)]
    out = readings(zs, traffic["limits"])
    out["events"] = {k: [SC.summary(z) for z in v] for k, v in zs.items()}
    return out


def main(argv) -> int:
    import argparse
    from benchmark.harness import HERE, cell_of, find, load_module, load_spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", choices=("all", "program", "control"),
                    default="all")
    ap.add_argument("--cap", type=int, default=CONTROL_CAP)
    args = ap.parse_args(argv)
    cell = cell_of(load_spec(), args.workload)
    conf = json.loads(find("configs", cell["config"], ".json",
                           [HERE]).read_text())
    traffic = json.loads(find("traffic", cell["traffic"], ".json",
                              [HERE]).read_text())
    src = load_module("sources", traffic["source"], [HERE])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = stream_control(conf, traffic, src, seed, "cuda", cap=args.cap,
                             program=args.what != "control",
                             control=args.what != "program")
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
