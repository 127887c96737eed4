"""Run one cell of BENCHMARK.json once, on the machine's first card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared with the reference, each
beside its limit.  Exits with 2, and prints no result, where the cell's
cards are not there or the process holds JAX or the JAX package once the
window has closed.  Run from the root of a checkout: the program under test,
``matrix_inversion_tpu_torch``, is imported from there and builds its kernels
into its own ``_build/`` directory.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not this folder

from gpubench.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T0))
