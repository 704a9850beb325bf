"""Large-N propagator-vs-oracle validation of clsim_tpu_torch (the BASELINE
correctness protocol of scripts/validate_oracle.py, on the port).

Runs >= 1e6 photons of a configuration through dispatch.propagate_auto
(on the card "auto" is the CUDA kernel in its Philox mode, "engine" the
port's torch engine) and through the independent float64 numpy oracle
(clsim_tpu_torch/validate/oracle.py) with np.random.default_rng(123), then
holds them together by clsim_tpu_torch/validate/matrix.py's check_case: the
total hits, the coarse hit-time bins and the hottest DOMs, and for
cascade-biased the per-hit weight law, equal-count clamped-weight time
bins and the total weight; generated = the steps' photons, every hit
recorded with weight 1/bias (unit weights in the unbiased configurations),
and the kernel launched under "auto" on the card, never under "engine".
Every statistic must pass (|z| < 5) and every check hold; the exit code
is 1 otherwise.

Usage:  python scripts/torch_validate_oracle.py [n_photons]
            [--config cascade|muon|flasher|cascade-biased|all]
            [--backend auto|engine] [--device cuda|cpu]

n_photons defaults to 1,000,000, photons_per_step = n_photons // 4096.
Configs (the BASELINE correctness matrix, validate/matrix.py):
  cascade        -- #1: cascade-like isotropic steps, tilt + anisotropy
  muon           -- #2: a 250 m muon track (the layered ice of #1: the
                    parsed spice_lea is not in the repository)
  flasher        -- #3: LED flasher pulses (multi-spectrum source_type)
  cascade-biased -- #4: #1 with the DOM acceptance as wavelength bias, per-hit
                    records (the production weighted path)
The usable equal-count bins of #4 need ~2e6 photons (n_photons 2003000).
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from clsim_tpu_torch.validate import matrix as MX  # noqa: E402


def card_line(device) -> str:
    if device.type != "cuda":
        return f"device {device}"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def run_config(config, n_photons, backend, device) -> bool:
    pps = max(1, n_photons // MX.N_STEPS)
    w = MX.workload(config, device, pps)
    print(f"=== {config} ===")
    print(f"{MX.N_STEPS} steps x {pps} photons = {MX.N_STEPS * pps}")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    res, launches = MX.propagate(w, backend)
    sync()
    print(f"propagator: {float(res.n_hits):.0f} hits in "
          f"{time.perf_counter() - t0:.1f}s (backend {backend}, device "
          f"{device}, {launches} kernel launches)")
    t0 = time.perf_counter()
    out = MX.oracle(w)
    print(f"oracle: {out[1]} hits in {time.perf_counter() - t0:.1f}s")
    case = MX.check_case(config, w, res, launches, out, backend)
    for line in case.cmp.lines:
        print(line)
    if case.unfold is not None:
        print(f"records {len(case.records[1])}, |weight x bias - 1| "
              f"{case.unfold:.3g}")
    for problem in case.problems:
        print(f"FAIL: {problem}")
    return not case.problems


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_photons", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--config", choices=list(MX.CONFIGS) + ["all"],
                    default="cascade")
    ap.add_argument("--backend", choices=["auto", "engine"], default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    print(card_line(device))
    configs = MX.CONFIGS if args.config == "all" else (args.config,)
    passed = [run_config(c, args.n_photons, args.backend, device)
              for c in configs]
    print("DONE" if all(passed) else
          f"FAILED: {[c for c, ok in zip(configs, passed) if not ok]}")
    return 0 if all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
