"""A cell's correctness readings on many seeds in one process, for setting
its limits: whole runs of the cell (as ``benchmark/run.py`` makes them,
with a short window) one seed after another, the train views rendered
once. One result line a seed.

    python benchmark/tools/readings.py --workload freq-train --seconds 1 \
        --seeds 2147483951 2147483952 ...
"""

from __future__ import annotations

import argparse
import functools
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import core, inputs  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    os.chdir(ROOT)
    views = functools.lru_cache(maxsize=1)(inputs.train_views)
    inputs.train_views = views
    for seed in args.seeds:
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        core.run(run, time.perf_counter())
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
