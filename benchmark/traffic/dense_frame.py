"""Dense-frame traffic: whole frames of a trained model through
``Renderer.render`` as ``run.build_renderer`` sets it up, one frame in
flight, each read back to the host as uint8.

A frame is the rays of an orbit pose (the port's ``pixel_dirs`` and
``rotate_dirs``), rendered by ``Renderer.render`` and rounded to uint8;
the poses are ``orbit_poses(poses)`` cycled from an offset drawn from the
seed. Set-up loads the checkpoint and renders one frame. The window
renders whole frames until ``--seconds`` have passed; ``dense_frame_ms``
is its wall time over the frames it completed.

The check: ``check_frames`` of the window's frames, drawn from the seed,
rendered again by the plain reference from the same checkpoint file and
pose; compared is the root mean square of the uint8 difference, in
levels, worst frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, inputs, port
from benchmark.reference import field as ref_field
from benchmark.reference import render as ref_render

UNITS = {"dense_frame_ms": "ms"}


def rms_levels(a: torch.Tensor, b: torch.Tensor) -> float:
    """Root mean square of the difference of two uint8 images, in levels."""
    d = a.double() - b.double()
    return float(torch.sqrt((d * d).mean()))


def check_indices(n_done: int, count: int, seed: int) -> list[int]:
    """``count`` distinct frames of the ``n_done`` completed, from the
    seed."""
    rng = np.random.default_rng([int(seed), 7])
    return sorted(rng.choice(n_done, size=min(count, n_done),
                             replace=False).tolist())


class Cell:
    def __init__(self, ctx: core.Context):
        from nerf_replication_tpu_torch.models.nerf.renderer import (
            ngp_renderer,
        )
        from nerf_replication_tpu_torch.run import build_renderer, load_model

        self.ctx = ctx
        p, dev = ctx.params, ctx.device
        cfg = port.cfg(ctx.config, dev, checkpoint=True)
        with ctx.stage("checkpoint, renderer"):
            self.renderer = build_renderer(cfg, load_model(cfg, dev))
        self.H, self.W = p["H"], p["W"]
        self.focal = inputs.focal_of(self.W)
        self.poses = torch.as_tensor(inputs.orbit_poses(p["poses"]),
                                     device=dev)
        self.offset = int(np.random.default_rng([ctx.seed, 1]).integers(
            p["poses"]))
        dirs = torch.from_numpy(ngp_renderer.pixel_dirs(self.H, self.W,
                                                        self.focal)).to(dev)
        self.rotate = lambda pose: ngp_renderer.rotate_dirs(dirs, pose)
        self.done = []           # (pose index, uint8 image on the host)
        with ctx.stage("warm frame"):
            self.frame(0)        # every shape of a frame

    def frame(self, i: int) -> torch.Tensor:
        pose = self.poses[i % len(self.poses)]
        rays_d = self.rotate(pose)
        rgb, _ = self.renderer.render({"rays_o": pose[:3, 3].expand(
            rays_d.shape), "rays_d": rays_d})
        return ref_render.to_uint8(rgb).cpu()

    def window(self, seconds: float) -> dict:
        port.sync(self.ctx.device)
        t0 = time.perf_counter()
        i = self.offset
        while time.perf_counter() - t0 < seconds:
            self.done.append((i % len(self.poses), self.frame(i)))
            i += 1
        wall = time.perf_counter() - t0
        n = len(self.done)
        return {"dense_frame_ms": wall / n * 1e3, "attempted": n,
                "failed": 0, "wall_s": wall, "frames": n}

    def profiled(self, count: int):
        def run():
            for i in range(count):
                self.frame(self.offset + i)
        return run

    def checks(self) -> list:
        ctx, c = self.ctx, self.ctx.config
        del self.renderer
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        w = {k: v.to(ctx.device) for k, v in ref_field.load_checkpoint(
            f"{c['port']['checkpoint']}/pretrain.ckpt").items()}
        field = ref_field.Field(c["model"])
        worst = 0.0
        for j in check_indices(len(self.done), ctx.params["check_frames"],
                               ctx.seed):
            idx, img = self.done[j]
            ref = ref_render.dense_frame(field, w, self.poses[idx], self.H,
                                         self.W, self.focal, c["render"])
            worst = max(worst, rms_levels(img.to(ctx.device), ref))
        return core.checks(ctx, {"rms_levels": worst})
