"""Viewer traffic: frames of a trained NGP model on the occupancy-raymarch
frame path (``ngp_renderer.make_ngp_frame_renderer`` on the eval apply
of ``run.build_renderer``), one frame in flight, each read back to the
host as uint8.

Set-up loads the checkpoint, builds the two occupancy grids
(``run.build_grids``: 64^3 dilated 2, 128^3 dilated 1), and makes the
frame renderer at a fixed step (n_candidates, n_coarse, n_fine) and
fixed budgets, written in the cell's file (fitted once to the orbit's
largest ray counts by ``tools/fit_view_budgets.py``); no ladder, no gate.
The window renders whole frames from an offset drawn from the seed until
``--seconds`` have passed: ``view_frame_ms`` is its wall time over the
frames completed, ``view_frame_p95_ms`` the 95th percentile of the time
from a frame's dispatch to its image on the host. A frame whose rays
overflow a budget counts as failed.

The check: ``check_frames`` of the window's frames, drawn from the seed,
rendered again by the plain reference's frame path from the checkpoint
file (its own grids), compared by the root mean square of the uint8
difference in levels, worst frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, inputs, port
from benchmark.reference import field as ref_field
from benchmark.reference import frame_path as ref_frame
from benchmark.traffic.dense_frame import check_indices, rms_levels

UNITS = {"view_frame_ms": "ms", "view_frame_p95_ms": "ms"}
OVERFLOWS = ("coarse_overflow", "occ_overflow", "fine_overflow")


def make_frame_fn(ctx, renderer, occupancy, select, caps: dict):
    """The port's frame renderer at the cell's step, budgets and probe."""
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer

    p = ctx.params
    C, M, F = p["step"]
    sub, stride = p["probe"]
    return ngp_renderer.make_ngp_frame_renderer(
        renderer.apply_fn, p["H"], p["W"], inputs.focal_of(p["W"]),
        occupancy, renderer.settings, n_candidates=C, n_coarse=M,
        n_fine=F, capacity=caps["capacity"], fine_capacity=caps["fine"],
        occ_capacity=caps["occ"], select_occupancy=select,
        probe_sub=sub, probe_stride=stride, out_dtype=torch.uint8,
        return_stats=True)


def build(ctx):
    """(renderer, occupancy, select) of the cell's checkpoint."""
    from nerf_replication_tpu_torch.run import (
        build_grids,
        build_renderer,
        load_model,
    )

    p = ctx.params
    cfg = port.cfg(ctx.config, ctx.device, checkpoint=True)
    renderer = build_renderer(cfg, load_model(cfg, ctx.device))
    occupancy, select = build_grids(
        renderer.apply_fn, renderer.settings, ctx.device,
        p["occ_resolution"], p["occ_sel_resolution"], p["occ_threshold"])
    return renderer, occupancy, select


class Cell:
    def __init__(self, ctx: core.Context):
        self.ctx = ctx
        p = ctx.params
        with ctx.stage("checkpoint, grids"):
            self.renderer, occupancy, select = build(ctx)
        self.fn = make_frame_fn(ctx, self.renderer, occupancy, select,
                                p["caps"])
        self.poses = torch.as_tensor(inputs.orbit_poses(p["poses"]),
                                     device=ctx.device)
        self.offset = int(np.random.default_rng([ctx.seed, 1]).integers(
            p["poses"]))
        self.done = []           # (pose index, uint8 image, overflows)
        with ctx.stage("warm frames"):
            for i in range(2):   # every shape of a frame
                self.frame(i)

    def frame(self, i: int):
        img, stats = self.fn(self.poses[i % len(self.poses)])
        return img.cpu(), torch.stack([stats[k] for k in OVERFLOWS])

    def window(self, seconds: float) -> dict:
        port.sync(self.ctx.device)
        t0 = time.perf_counter()
        i, lat = self.offset, []
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            img, over = self.frame(i)
            lat.append(time.perf_counter() - t)
            self.done.append((i % len(self.poses), img, over))
            i += 1
        wall = time.perf_counter() - t0
        n = len(self.done)
        failed = int(sum(int(o.sum() > 0) for _, _, o in self.done))
        return {"view_frame_ms": wall / n * 1e3,
                "view_frame_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "attempted": n, "failed": failed, "wall_s": wall,
                "frames": n}

    def profiled(self, count: int):
        def run():
            for i in range(count):
                self.frame(self.offset + i)
        return run

    def checks(self) -> list:
        ctx, c, p = self.ctx, self.ctx.config, self.ctx.params
        del self.renderer, self.fn
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        w = {k: v.to(ctx.device) for k, v in ref_field.load_checkpoint(
            f"{c['port']['checkpoint']}/pretrain.ckpt").items()}
        frame = ref_frame.FramePath(ref_field.Field(c["model"]), w, p["H"],
                                    p["W"], inputs.focal_of(p["W"]),
                                    c["render"], p, ctx.device)
        worst = 0.0
        for j in check_indices(len(self.done), p["check_frames"], ctx.seed):
            idx, img, _ = self.done[j]
            worst = max(worst, rms_levels(img.to(ctx.device),
                                          frame(self.poses[idx])))
        return core.checks(ctx, {"rms_levels": worst})
