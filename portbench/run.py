#!/usr/bin/env python3
"""The benchmark of mimo_tpu_torch, the port, on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of BENCHMARK.json once in this process and prints one JSON
line: its end-to-end metrics (--trace 0) or its per-layer metrics
(--trace 1), whether the outputs are correct, and the device. Without a
CUDA card it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import env  # noqa: E402

env.set_cache_dirs()

from harness.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(t_start=T_START))
