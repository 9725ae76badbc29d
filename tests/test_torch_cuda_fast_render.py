"""The compacted renders of the volume renderer on a GPU: the encode+MLP
kernel (#1) against its plain version at the shapes the compacted frame
and the segmented ERT fine pass give it, and the compacted frame, ERT and
``render_image_fast`` through the kernel against the same renders through
the plain version. Every test is marked ``cuda`` and skips itself where no
GPU is found. This file imports nothing of JAX, so on a GPU machine
without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_fast_render.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.evaluators import psnr_uint8
from nerf_replication_tpu_torch.models.nerf.renderer import Renderer
from nerf_replication_tpu_torch.run import build_grids, build_renderer, \
    load_model
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
        "pretrain_path", "data/pretrain/hard", "save_result", "False",
        "device", "cuda"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def renderer(cuda, monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args(ARGV))
    return build_renderer(cfg, load_model(cfg, cuda))


# rays x samples of the compacted frame's calls at a 40,000-ray chunk: the
# coarse pass, the dense fine pass, the two ERT segments (128 and 64 of 192
# samples, 20,096 survivors), and point counts that end in a part of the
# kernel's 128-point tile. Each has >= 70,000 points, so that one element
# is below MLP_BOUNDS' outlier share (1e-5 of them) of a few bf16 flips
SHAPES = [(40000, 64), (40000, 192), (40000, 128), (20096, 64), (20096, 128),
          (1153, 64), (4097, 192)]
# MLP_BOUNDS with each column's bound at 2e-2 of its max, not 1e-2: these
# random depths along view 0's rays give the coarse density column a max
# of 703 (~4000 on a frame's samples), and one bf16 flip at 1153 x 64
# points read 1.00e-2 of it on the H100 (every element inside the
# elementwise atol + rtol bound); the frame's own chunks read <= 9.98e-3
# in chip_smoke.py's phase 10, held to MLP_BOUNDS there
BOUNDS = chip_smoke.MLP_BOUNDS._replace(col_rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rays,samples", SHAPES)
def test_kernel_at_compacted_shapes(renderer, rays, samples):
    """#1 through the renderer's eval apply (both branches) against its
    plain version on random depths along ``rays`` rays of hard view 0,
    within BOUNDS."""
    view = synthetic_scene.test_views("hard", 200, 200, [0], device="cuda")[0]
    g = torch.Generator(device="cuda").manual_seed(rays + samples)
    idx = torch.randint(0, 200 * 200, (rays,), device="cuda", generator=g)
    ro = torch.as_tensor(view["rays_o"], device="cuda")[idx]
    rd = torch.as_tensor(view["rays_d"], device="cuda")[idx]
    t = 2.0 + 4.0 * torch.sort(torch.rand(rays, samples, device="cuda",
                                          generator=g), dim=-1).values
    pts = ro[:, None] + rd[:, None] * t[..., None]
    plain = chip_smoke.plain_twin(renderer.net)
    for model in ("", "fine"):
        launches = tracing.counts["fused_nerf_mlp_enc.launches"]
        with torch.inference_mode():
            out = renderer.apply_fn(pts, rd[:, None], model).reshape(-1, 4)
            ref = plain(pts, rd[:, None], model).reshape(-1, 4)
        assert tracing.counts["fused_nerf_mlp_enc.launches"] == launches + 1
        a = chip_smoke.agreement(out, ref, BOUNDS)
        assert a["ok"], chip_smoke.describe(a)


def _plain_renderer(renderer):
    """The renderer with its kernel replaced by the plain version."""
    plain = chip_smoke.plain_twin(renderer.net)
    return Renderer(renderer.net, settings=renderer.settings).use_apply(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 2])
def test_compacted_frame_matches_plain(renderer, segments):
    """A 200x200 compacted frame of hard view 0 (64^3 grid, budgets 0.4 /
    0.5) through #1 against the same frame through its plain version:
    every stat equal, the images >= 45 dB apart (bf16 flips move a few
    samples); a frame through #1 launches it as its budget says and reads
    nothing back to the host."""
    view = synthetic_scene.test_views("hard", 200, 200, [0], device="cuda")[0]
    renderer.settings = dataclasses.replace(renderer.settings,
                                            ert_segments=segments,
                                            ray_chunk=8000)
    occupancy, _ = build_grids(renderer.apply_fn, renderer.settings, "cuda",
                               64, 0, 0.05)
    pose = torch.as_tensor(view["pose"], dtype=torch.float32, device="cuda")
    images = {}
    for name, r in (("kernel", renderer), ("plain", _plain_renderer(renderer))):
        fn = r.make_frame_renderer(200, 200, float(view["focal"]),
                                   capacity=0.4, coarse_capacity=0.5,
                                   out_dtype=torch.uint8, occupancy=occupancy,
                                   return_stats=True)
        img, stats = fn(pose)
        images[name] = (img.cpu().numpy(),
                        {k: int(v) for k, v in stats.items()})
        if name == "kernel":
            torch.cuda.synchronize()
            launches = tracing.counts["fused_nerf_mlp_enc.launches"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(pose)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            b = fn.budget
            made = tracing.counts["fused_nerf_mlp_enc.launches"] - launches
            assert made == (b["coarse_rays"] + b["fine_rays"]
                            * b["fine_segments"]) // b["chunk"]
    (k_img, k_stats), (p_img, p_stats) = images["kernel"], images["plain"]
    assert k_stats == p_stats and k_stats["active_rays"] > 0
    assert psnr_uint8(k_img / 255.0, p_img / 255.0) >= 45.0


@pytest.mark.cuda
def test_render_image_fast_matches_plain(renderer):
    """render_image_fast of hard view 0 at 200x200 through #1 against the
    plain version's, and against the dense render through #1."""
    view = synthetic_scene.test_views("hard", 200, 200, [0], device="cuda")[0]
    renderer.settings = dataclasses.replace(renderer.settings, ray_chunk=8000)
    fast = renderer.render_image_fast(view["rays_o"], view["rays_d"])
    plain = _plain_renderer(renderer).render_image_fast(view["rays_o"],
                                                        view["rays_d"])
    dense = renderer.render_rays_batch(view["rays_o"], view["rays_d"])
    to_np = lambda x: x.clamp(0, 1).cpu().numpy()   # noqa: E731
    assert psnr_uint8(to_np(fast["rgb"]), to_np(plain["rgb"])) >= 55.0
    assert psnr_uint8(to_np(fast["rgb"]), to_np(dense["rgb"])) >= 55.0
    gt = np.asarray(view["colors"])
    assert abs(psnr_uint8(to_np(fast["rgb"]), gt)
               - psnr_uint8(to_np(dense["rgb"]), gt)) < 0.05
