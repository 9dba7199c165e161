"""The benchmark's command: one run of one cell of BENCHMARK.json on the card.

    python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared with the reference, each with its
limit, are the last lines of standard error. Set-up is timed from the
first line of this file.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from kzgbench import harness

    sys.exit(harness.main(t_start=T_START))
