"""Fixtures of the benchmark's own tests (run them from the checkout's
root: ``python -m pytest benchmark/tests``). Tests that need the card
carry the ``cuda`` marker and skip themselves, from inside a fixture,
where there is none."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips itself where none is found")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size on the card")
    return torch.device("cuda", 0)


@pytest.fixture()
def in_root(monkeypatch):
    """Run from the checkout's root: the port's configs and checkpoints
    are relative paths."""
    monkeypatch.chdir(ROOT)
    return ROOT


# The viewer traffic of the repo's trained brick checkpoint
# (data/pretrain/hard_ngp_b9: 12 levels to 512, 512 bricks a hashed
# level), for the tests of the viewer's traffic and reference at tiny
# size: the benchmark has no viewer cell until a checkpoint at the
# published widths is trained.
VIEW_GRID = {"num_levels": 12, "desired_resolution": 512, "log2_bricks": 9,
             "table_rows": 5504}
VIEW_PORT = {"cfg_file": "configs/nerf/hard_ngp.yaml",
             "overrides": ["network.xyz_encoder.log2_bricks", "9"],
             "checkpoint": "data/pretrain/hard_ngp_b9"}
VIEW_PARAMS = {"poses": 100, "step": [32, 10, 10], "probe": ["auto", 2],
               "occ_resolution": 64, "occ_sel_resolution": 128,
               "occ_threshold": 0.02, "check_frames": 2,
               "caps": {"capacity": 0.3406, "occ": 0.2634, "fine": 0.2302}}


def tiny_copy(dest: Path) -> Path:
    """A copy of the benchmark in ``dest`` with a tiny CPU-sized cell of
    each real one (``<cell>-tiny``), and ``ngp-view-tiny``: 16x16 frames,
    3 views, 32-ray steps of 8 + 8 samples, 5-step epochs after a 6-step
    crop, the same limits."""
    bench = dest / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs = {name: json.loads((bench / "configs" / f"{name}.json")
                                .read_text())
               for name in ("nerf-freq-hard", "ngp-brick-hard")}
    view = json.loads(json.dumps(configs["ngp-brick-hard"]))
    view["port"] = json.loads(json.dumps(VIEW_PORT))
    view["model"]["grid"].update(VIEW_GRID)
    configs["ngp-brick-b9"] = view
    for name, c in configs.items():
        c["name"] = f"{name}-tiny"
        c["port"]["overrides"] += ["task_arg.N_rays", "32",
                                   "task_arg.N_samples", "8",
                                   "task_arg.N_importance", "8",
                                   "task_arg.ray_chunk", "256",
                                   "task_arg.precrop_iters", "6"]
        c["render"].update(N_samples=8, N_importance=8)
        c["train"].update(N_rays=32, precrop_iters=6)
        (bench / "configs" / f"{name}-tiny.json").write_text(json.dumps(c))
    workloads = {name: json.loads((bench / "workloads" / f"{name}.json")
                                  .read_text())
                 for name in ("freq-train", "ngp-train", "freq-dense-frame")}
    workloads["ngp-view"] = {
        "config": "ngp-brick-b9", "traffic": "view_frame", "chips": 1,
        "why": "viewer frames of the trained brick checkpoint",
        "params": json.loads(json.dumps(VIEW_PARAMS)),
        "end_to_end": ["view_frame_ms", "view_frame_p95_ms", "setup_s"],
        "profile": {"count": 10}, "limits": {"rms_levels": 0.025}}
    for name, w in workloads.items():
        w["name"] = f"{name}-tiny"
        w["config"] += "-tiny"
        w["params"].update(H=16, W=16)
        if "views" in w["params"]:
            w["params"].update(views=3, steps_per_call=5)
        if "poses" in w["params"]:
            w["params"].update(poses=8)
        w["profile"]["count"] = 2
        (bench / "workloads" / f"{name}-tiny.json").write_text(json.dumps(w))
    return bench


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture()
def run_tiny(tiny_bench, in_root, monkeypatch, capsys):
    """``run_tiny(cell, seed) -> (exit code, result dict or None, stderr)``:
    a whole run of a tiny cell on the CPU, in this process."""
    import argparse
    import time

    from benchmark.harness import core, specs

    monkeypatch.setattr(specs, "BENCH_DIR", tiny_bench)

    def run(cell, seed=1234, trace=0):
        capsys.readouterr()
        args = argparse.Namespace(workload=cell, seed=seed, seconds=0.3,
                                  trace=trace)
        rc = core.run(args, time.perf_counter(), device=torch.device("cpu"))
        out = capsys.readouterr()
        lines = [ln for ln in out.out.splitlines() if ln.startswith("{")]
        return rc, (json.loads(lines[-1]) if lines else None), out.err

    return run
