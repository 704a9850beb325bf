"""Entry point of the benchmark of clsim_tpu_torch on CUDA cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (the last line of standard output) and, as the last
lines of standard error, every number the correctness check compared with
its limit.  See harness.py and PERF.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], T_START))
