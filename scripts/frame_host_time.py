"""What sets the host's time of a frame-path frame on one GPU.

The NGP frame of the occupancy-raymarch path is issued by the host (41
ray chunks of ~46 small ops each; the card idles ~85% of it), so its wall
time is the host's time to issue it. This script renders the frame path
of both trained checkpoints at 800x800 at the JAX records' steps
(``freq_rm`` (32,12,10), NGP (32,10,10) and its bf16 arm; budgets 0.37 /
0.28 / 0.24 of the pixels, as autocap sets them) and reads, three times
over, the host's cost of one tiny launch (``torch.add`` on 16 floats) and
each frame synchronised (median of 20, with the host's issue time) and
over a window of 100 orbit frames with one of overlap, as
``raymarch_bench`` times them, then the window again with the garbage
collector off: twice before any profiler runs in the process, then after
one frame under ``torch.profiler``.

    python3 scripts/frame_host_time.py      # from the checkout's root
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = {
    "freq_rm": (["--cfg_file", "configs/nerf/hard.yaml", "pretrain_path",
                 "data/pretrain/hard"], (32, 12, 10)),
    "ngp": (["--cfg_file", "configs/nerf/hard_ngp.yaml", "pretrain_path",
             "data/pretrain/hard_ngp_b9", "network.xyz_encoder.log2_bricks",
             "9"], (32, 10, 10)),
}
SIZE = 800
SYNCED = 20
WINDOW = 100


def launch_us(x: torch.Tensor, n: int = 20000) -> float:
    """Host microseconds a ``torch.add`` on ``x``, n of them back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        torch.add(x, 1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def frames() -> dict:
    """name -> frame renderer at its family's step, on the card."""
    from nerf_replication_tpu_torch import raymarch_bench as rb
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
    from nerf_replication_tpu_torch.run import (
        build_grids,
        build_renderer,
        load_model,
    )

    focal = SIZE / (2.0 * np.tan(rb.CAMERA_ANGLE_X / 2.0))
    caps = rb.Caps(0.37, 0.28, 0.24)
    out = {}
    for family, (argv, step) in FAMILIES.items():
        cfg = make_cfg(parse_args(["--type", "evaluate", *argv, "device",
                                   "cuda", "save_result", "False"]))
        net = load_model(cfg, torch.device("cuda"))
        renderer = build_renderer(cfg, net)
        occupancy, select = build_grids(renderer.apply_fn, renderer.settings,
                                        "cuda")
        args = (SIZE, SIZE, focal, occupancy, select, renderer.settings)
        out[family] = rb.frame_factory(renderer.apply_fn, *args)(
            *step, caps, *rb.PROBE)
        if ngp_renderer.is_brick_ngp(net):
            apply16 = ngp_renderer.make_ngp_eval_apply(net, mlp_bf16=True)
            out[f"{family} bf16"] = rb.frame_factory(apply16, *args)(
                *step, caps, *rb.PROBE)
    return out


def report(tag: str, fns: dict, x, pose, poses) -> None:
    from nerf_replication_tpu_torch import raymarch_bench as rb

    print(f"[{tag}] {launch_us(x):.2f} us a torch.add", flush=True)
    for name, fn in fns.items():
        issue, wall = [], []
        for _ in range(SYNCED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(pose)
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        rb.time_frames(fn, poses[:1])
        window = rb.time_frames(fn, poses)
        gc.disable()
        try:
            no_gc = rb.time_frames(fn, poses)
        finally:
            gc.enable()
        print(f"[{tag}] {name}: synchronised {1e3 * np.median(wall):.2f} ms "
              f"(issue {1e3 * np.median(issue):.2f}), window "
              f"{1e3 * window:.2f} ms, window with gc off "
              f"{1e3 * no_gc:.2f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("frame_host_time.py needs a GPU")
    from torch.profiler import ProfilerActivity, profile

    from nerf_replication_tpu_torch import raymarch_bench as rb
    from nerf_replication_tpu_torch.ops import _build

    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["fused_nerf_mlp", "fused_ngp"])
    print(rb.card())
    fns = frames()
    x = torch.zeros(16, device="cuda")
    pose = torch.as_tensor(rb.orbit_poses(1)[0], device="cuda")
    poses = [torch.as_tensor(p, device="cuda")
             for p in rb.orbit_poses(WINDOW)]
    report("before any profiler", fns, x, pose, poses)
    report("before any profiler, again", fns, x, pose, poses)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fns["ngp"](pose)
        torch.cuda.synchronize()
    report("after one profiled frame", fns, x, pose, poses)


if __name__ == "__main__":
    main()
