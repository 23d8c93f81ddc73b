"""Run one cell of the benchmark on this machine's card and print its result.

    python3 krylov_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last); the last lines of
standard error give each number compared beside its limit.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits 2 and prints no
result.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root, in place of this script's directory, so that the
# harness and the program import as packages
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from krylov_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
