"""The benchmark's one command:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on this machine's CUDA card(s) and
prints one JSON result line last (perfbench/README.md).  It exits with a
code other than 0, and prints no result, where the cell's cards are
missing.
"""
import os
import sys
import time

START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], start=START))
