"""The NGP record's rays, emulated on the GPU.

    python3 scripts/torch_ngp_tpu_rays.py

The JAX record result/quality_r5_ngp_hard.jsonl (29.34 dB on hard test
views 0-7) made its rays on a TPU, where ``dirs @ R.T`` in float32 runs as
one bfloat16 pass (both operands rounded to bf16, f32 products and sums),
in training (``DeviceRayPipeline``) and in its eval (``rays_for_camera``).
This prints (1) the record's checkpoint data/pretrain/hard_ngp_b9 on views
0-7 with exact rays and with rays rotated that way, densely through the
port; (2) the same after 15,500 steps of configs/nerf/hard_ngp.yaml at
``log2_bricks`` 9 on the 100 train views from the seed-0 init, trained on
rays rotated that way (``DeviceRayPipeline._pixel_rays`` replaced for the
run). Ground truth is rendered on the card; one JSON line each.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZE = 800
BASE = ["--cfg_file", "configs/nerf/hard_ngp.yaml",
        "network.xyz_encoder.log2_bricks", "9"]


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def rotate_one_bf16_pass(dirs: torch.Tensor, rot: torch.Tensor):
    """normalize(dirs @ rot.T) with both operands rounded to bf16 and the
    products and sums in f32 (a TPU's default float32 matmul)."""
    d = (bf16(dirs)[..., None, :] * bf16(rot)).sum(-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def tpu_views(views):
    """The test batches with their directions rotated in one bf16 pass."""
    out = []
    us, vs = np.meshgrid(np.arange(SIZE, dtype=np.float32),
                         np.arange(SIZE, dtype=np.float32))
    for v in views:
        inv_f = np.float32(1.0 / float(v["focal"]))
        dirs = np.stack([(us - SIZE / 2.0) * inv_f,
                         -(vs - SIZE / 2.0) * inv_f, -np.ones_like(us)], -1)
        d = rotate_one_bf16_pass(torch.from_numpy(dirs.reshape(-1, 3)),
                                 torch.from_numpy(v["pose"][:3, :3]))
        out.append({**v, "rays_d": d.numpy().astype(np.float32)})
    return out


def main() -> int:
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.datasets import pipeline
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.run import build_renderer, load_model
    from nerf_replication_tpu_torch.train.cli import train
    from nerf_replication_tpu_torch.utils import synthetic_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    views = synthetic_scene.test_views("hard", SIZE, SIZE, range(8),
                                       device="cuda")
    rays = {"exact": views, "tpu_rays": tpu_views(views)}

    def evaluate(cfg, net) -> dict:
        renderer = build_renderer(cfg, net)
        out = {}
        for tag, batches in rays.items():
            psnrs = [psnr_uint8(renderer.render(b)[0].cpu().numpy(),
                                b["colors"]) for b in batches]
            out[tag] = (float(np.mean(psnrs)), [round(p, 3) for p in psnrs])
        return out

    cfg = make_cfg(parse_args(BASE + ["pretrain_path",
                                      "data/pretrain/hard_ngp_b9"]))
    print(json.dumps({"record_ckpt": evaluate(
        cfg, load_model(cfg, torch.device("cuda")))}), flush=True)

    def pixel_rays(self, pose, u, v):
        dirs = torch.stack([(u - self.cx) / self.focal,
                            -(v - self.cy) / self.focal,
                            -torch.ones_like(u)], dim=-1)
        rays_d = rotate_one_bf16_pass(dirs, pose[..., :3, :3])
        return pose[..., :3, 3].expand(rays_d.shape), rays_d

    pipeline.DeviceRayPipeline._pixel_rays = pixel_rays
    arrays = synthetic_scene.train_views("hard", SIZE, SIZE, range(100),
                                         device="cuda")
    t0 = time.perf_counter()
    cfg = make_cfg(parse_args(BASE + [
        "train.epoch", "31", "resume", "False", "eval_ep", "100000",
        "save_latest_ep", "100000", "trained_model_dir",
        "build/ngp_tpu_rays"]))
    trainer = train(cfg, train_arrays=arrays, val_loader=views)
    print(json.dumps({"trained_on_tpu_rays": evaluate(cfg, trainer.network),
                      "steps": trainer.step,
                      "train_s": time.perf_counter() - t0, "device": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
