"""Fit a viewer cell's ray budgets once, to write them into its file.

    python benchmark/tools/fit_view_budgets.py --workload <viewer cell>

Renders every orbit pose of the cell with budgets of the whole frame and
takes the largest ray counts: the active rays (span probe), the rays
with an occupied candidate, the rays of coarse opacity above 1e-3. The
budgets follow ``raymarch_bench.autocap``'s rule: active x 1.1 + 0.02,
occupied x 1.15 + 0.01, non-trivial x 1.15 + 0.01 (each at most the
one before). Prints them as JSON, with the counts.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import core, inputs, specs  # noqa: E402
from benchmark.traffic import view_frame  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    args = parser.parse_args(argv)
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    w = specs.workload(args.workload)
    ctx = core.Context(args.workload, w, specs.config(w["config"]), 0,
                       torch.device("cuda"))
    renderer, occupancy, select = view_frame.build(ctx)
    fn = view_frame.make_frame_fn(ctx, renderer, occupancy, select,
                                  {"capacity": 1.0, "occ": 1.0, "fine": 1.0})
    keys = ("active_rays", "occ_rays", "nontrivial_rays")
    most = dict.fromkeys(keys, 0)
    for pose in inputs.orbit_poses(w["params"]["poses"]):
        _, stats = fn(torch.as_tensor(pose, device="cuda"))
        for k in keys:
            most[k] = max(most[k], int(stats[k]))
    n = w["params"]["H"] * w["params"]["W"]
    cap = min(1.0, most["active_rays"] / n * 1.1 + 0.02)
    occ = min(cap, most["occ_rays"] / n * 1.15 + 0.01)
    fine = min(occ, most["nontrivial_rays"] / n * 1.15 + 0.01)
    up = [math.ceil(x * 1e4) / 1e4 for x in (cap, occ, fine)]
    print(json.dumps({"caps": dict(zip(("capacity", "occ", "fine"), up)),
                      "most": most}))


if __name__ == "__main__":
    main()
