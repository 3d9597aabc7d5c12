"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last the
compared numbers under ``checked``). Exits non-zero, with no result, where
there is no CUDA device or the port cannot be imported.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.harness import cache_environment, main  # noqa: E402

if __name__ == "__main__":
    cache_environment()
    sys.exit(main(t_start=T_START))
