#!/usr/bin/env python3
"""The benchmark of circuitmap_torch: one run of one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's CUDA
devices. Prints the set-up split on an earlier line, each compared
number beside its limit as the last lines on standard error, and the
result as one JSON object on the last line of standard output. The
cells, configurations and metrics are in ``BENCHMARK.json``; the files
that belong to each are under ``benchmarks/`` (see ``cmbench/harness.py``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's one build cache (its nvcc kernels and g++ host library)
# at a fixed place inside the checkout, so that only a cell's first run
# in a checkout builds
os.environ["CIRCUITMAP_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "circuitmap_torch", "_build")
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

from cmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
