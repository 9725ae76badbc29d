"""On the card, at each cell's own size: the control (the reference in the
program's place, one precision below the configuration's) and the
planted faults must each fail at least one of the cell's limits.

    python -m pytest benchmark/tests/test_benchmark_controls.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import inputs, specs
from benchmark.tools import controls



def fails(limits: dict, reading: dict) -> bool:
    return any(reading[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", specs.names("workloads"))
def test_control_and_faults_fail_the_limits(cell, cuda_device, in_root):
    torch.backends.cuda.matmul.allow_tf32 = False
    w = specs.workload(cell)
    c = specs.config(w["config"])
    seed = 2 ** 31 + 101
    if w["traffic"] == "train":
        p = w["params"]
        images, alphas, poses, K = inputs.train_views(p["views"], p["H"],
                                                      p["W"], cuda_device)
        data = {"images": images, "alphas": alphas,
                "poses": torch.as_tensor(poses, device=cuda_device),
                "K": torch.as_tensor(K)}
        got = controls.train_readings(w, c, seed, cuda_device, data)
    else:
        got = controls.frame_readings(w, c, seed, cuda_device)
    for name, reading in got.items():
        assert fails(w["limits"], reading), (name, reading, w["limits"])
