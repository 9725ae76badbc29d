"""Run one cell of the benchmark once, from the checkout's root:

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (inputs from the seed, the program's objects, every shape
warmed), then ``--seconds`` of measured work, then with ``--trace 1`` a
profiled pass, then the correctness check against the plain reference.
The last line of standard output is the result's JSON object; the
numbers compared with their limits are the last lines of standard error.
Exits non-zero, printing no result, without the CUDA devices the cell
asks for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.chdir(ROOT)      # the port's configs and checkpoints are relative
    from benchmark.harness import core

    return core.run(args, T0)


if __name__ == "__main__":
    sys.exit(main())
