"""The spread of chip_smoke phase 10a's golden comparison over seeds, on a
CUDA GPU.

    python3 scripts/torch_golden_spread.py [N]     # N seeds, default 24

For config1_cascade and config3_flasher (clsim_tpu_torch/util/golden.py),
the golden's slot batches run through the kernel (mode 0, Philox) with
seeds 1..N, and again in the record mode on the same seed.  Each line
prints the hits, the largest recorded hit weight, E[w^2] / E[w] of the
hits' weights, the record run's histogram L1 against mode 0's, and
statistical_compare's largest |z| against the golden with that variance
and with the rule's constant-weight variance (the mean weight; 99 where it
raised).  The last line of each configuration gives the quantiles 0.5,
0.9 and 1 of both.
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def largest_z(G, name, res, golden, factor):
    try:
        return G.statistical_compare(
            name, float(res.n_hits), float(res.weight_hits),
            res.hist.double().cpu().numpy(), float(golden["n_hits"]),
            float(golden["weight_hits"]), golden["hist"],
            weight_factor=factor)
    except AssertionError:
        return 99.0


def main():
    import torch
    from clsim_tpu_torch.util import golden as G
    if not torch.cuda.is_available():
        sys.exit("torch_golden_spread: needs a CUDA GPU")
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    device = torch.device("cuda", 0)
    for name in ("config1_cascade", "config3_flasher"):
        golden = G.load_golden(name)
        sim, sources = G.CONFIGS[name](device)
        batches = sim.steps_from_particles(
            sources, np.random.default_rng(G.GOLDEN_SEED))
        plain_cfg = sim.config
        rec_cfg = dataclasses.replace(plain_cfg, save_photons=True)
        z_w, z_c = [], []
        for seed in range(1, n_seeds + 1):
            sim.config = plain_cfg
            res = sim.run_steps(batches, seed)
            sim.config = rec_cfg
            rec = sim.run_steps(batches, seed)
            w = rec.rec["weight"][0].double().cpu().numpy()
            factor = float((w * w).sum() / w.sum())
            h = res.hist.double().cpu().numpy()
            l1 = float(np.abs(rec.hist.double().cpu().numpy() - h).sum()
                       / h.sum())
            z_w.append(largest_z(G, name, res, golden, factor))
            z_c.append(largest_z(G, name, res, golden, None))
            print(f"{name} seed {seed}: hits {float(res.n_hits):.0f}, "
                  f"largest hit weight {w.max():.6g}, E[w^2]/E[w] "
                  f"{factor:.6g}, record-mode L1 {l1:.3g}; largest |z| "
                  f"{z_w[-1]:.3f} (constant-weight variance "
                  f"{z_c[-1]:.3f})", flush=True)
        q = (0.5, 0.9, 1.0)
        print(f"{name}: {n_seeds} seeds, largest |z| quantiles {q}: "
              f"{np.quantile(z_w, q).round(3).tolist()} (constant-weight "
              f"variance {np.quantile(z_c, q).round(3).tolist()})",
              flush=True)


if __name__ == "__main__":
    main()
