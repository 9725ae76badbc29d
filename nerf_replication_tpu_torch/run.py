"""Evaluation CLI of the port, the counterpart of run.py:

    python -m nerf_replication_tpu_torch.run --type evaluate \
        --cfg_file configs/nerf/hard.yaml pretrain_path data/pretrain/hard

* evaluate — render the config's test split, mean MSE/PSNR/SSIM and the
  frame time, fps = 1 / mean(frame times after the first)
* network  — render up to 4 views, per-view PSNR + PNG dumps

The weights come from ``pretrain_path`` when it is set, else from the
newest checkpoint under ``trained_model_dir``. The device is the config's
``device`` (``cuda`` unless overridden, e.g. ``device cpu``); CUDA that is
absent raises. ``network.use_pallas_mlp`` (a strict boolean, default True
in the port) routes the MLP through the fused CUDA kernel of the model
family: the encode+MLP kernel for frequency NeRFs, the fused brick
encode + NGP MLP kernel for brick hash-grid NGP networks, e.g.

    python -m nerf_replication_tpu_torch.run --type evaluate \
        --cfg_file configs/nerf/hard_ngp.yaml \
        pretrain_path data/pretrain/hard_ngp_b9 network.xyz_encoder.log2_bricks 9

A network the kernel does not cover then raises; with the flag off the
plain ``nn.Module`` network runs.

``task_arg.fast_sampling True`` renders every view through
``Renderer.render_image_fast`` (a coarse pass over every ray, the fine pass
over the rays it finds opaque), the reference's ``fast_sampling`` eval.

``task_arg.fast_render True`` renders every batch that carries a camera
``pose`` through the occupancy-raymarch frame renderer
(``ngp_renderer.make_ngp_frame_renderer``) instead of the dense path, with
the same apply: occupancy grids of the network's own density first (64^3
dilated 2 cells for the span probe, 128^3 dilated 1 for the candidate
selection; ``occ_resolution``, ``occ_sel_resolution``, ``occ_threshold``),
then one frame renderer per (H, W, focal) with the ``fast_*`` keys.
``--type dataset/input/mesh`` are not ported yet (ROADMAP.md item 10).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .config import as_bool, make_cfg, parse_args
from .datasets import make_test_dataset
from .evaluators import make_evaluator, psnr_uint8
from .models import make_network
from .models.nerf.renderer import make_renderer, ngp_renderer
from .ops import mlp_kernel
from .ops.occupancy import build_occupancy_grid
from .ops.ray_ops import density_activation
from .utils.ckpt_utils import load_network, load_pretrain, params_from_jax


def resolve_device(cfg) -> torch.device:
    device = torch.device(str(cfg.get("device", "cuda")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default "
            "(override with `device cpu` for the plain PyTorch path)")
    return device


def load_model(cfg, device):
    """The config's Network with its trained weights, on ``device``. A
    checkpoint that does not fit the config raises (a strict load), e.g. a
    hash-grid table of another ``log2_bricks`` (brick) or
    ``log2_hashmap_size`` (xla)."""
    network = make_network(cfg)
    tree = (load_pretrain(cfg.pretrain_path) if cfg.get("pretrain_path")
            else load_network(cfg.trained_model_dir, epoch=cfg.test.epoch))
    state = params_from_jax(tree)
    if ngp_renderer.grid_backend(network) is not None:
        enc = network.xyz_encoder
        rows = state.get("xyz_encoder.table", torch.empty(0)).shape[0]
        key = "log2_bricks" if enc.backend == "brick" else "log2_hashmap_size"
        if rows != enc.table.shape[0]:
            raise ValueError(
                f"the checkpoint's hash-grid table has {rows} rows, the "
                f"config's {enc.backend} layout {enc.table.shape[0]}: set "
                f"network.xyz_encoder.{key} to the checkpoint's")
    network.load_state_dict(state)
    return network.to(device).eval()


def build_renderer(cfg, network):
    """The config's renderer. With ``network.use_pallas_mlp`` on, a brick
    NGP network runs through the fused NGP kernel, a network of the
    vertex-exact ``xla`` grid through its ``nn.Module`` (no kernel covers
    it, as in the JAX package) and any other through the fused MLP kernel;
    a network that its kernel does not cover raises rather than running
    the plain network."""
    renderer = make_renderer(cfg, network)
    if not as_bool(cfg.network.get("use_pallas_mlp", True),
                   "network.use_pallas_mlp"):
        return renderer
    if ngp_renderer.is_brick_ngp(network):
        renderer.use_apply(ngp_renderer.make_ngp_eval_apply(network))
        print("fused CUDA NGP eval: True")
        return renderer
    if ngp_renderer.is_xla_ngp(network):
        print("xla hash grid: the nn.Module network (no kernel covers it)")
        return renderer
    if not renderer.enable_fused_mlp():
        raise ValueError(
            "network.use_pallas_mlp is on, but the fused MLP kernel does "
            f"not cover {mlp_kernel.unsupported(network)}; set "
            "network.use_pallas_mlp False for the plain MLP")
    print("fused CUDA MLP: True")
    return renderer


def build_grids(apply_fn, settings, device, resolution: int = 64,
                sel_resolution: int = 128, threshold: float = 0.02):
    """The frame path's occupancy grids from the density of ``apply_fn``'s
    "fine" branch (zero view directions, activated as ``settings`` says):
    ``(occupancy, select_occupancy)``, the first ``(grid, bbox, 2)`` at
    ``resolution`` dilated 2 cells, the second ``(grid, bbox)`` at
    ``sel_resolution`` dilated 1 cell, or None unless it is finer."""
    act = density_activation(settings.density_activation)

    def density(pts):
        return act(apply_fn(pts[:, None, :], pts.new_zeros(1, 1, 3),
                            "fine")[:, 0, 3])

    grid, bbox = build_occupancy_grid(density, resolution=resolution,
                                      threshold=threshold, dilate=2,
                                      device=device)
    select = None
    if sel_resolution > resolution:
        select = build_occupancy_grid(density, resolution=sel_resolution,
                                      threshold=threshold, dilate=1,
                                      device=device)
    return (grid, bbox, 2), select


def make_frame_fn(cfg, renderer):
    """``frame(batch) -> (rgb (H*W, 3), depth (H*W,))`` through the
    occupancy-raymarch frame renderer when ``task_arg.fast_render`` is on
    (a strict boolean), else None. The grids are built now, from
    ``renderer.apply_fn``; one frame renderer is made per (H, W, focal)."""
    ta = cfg.task_arg
    if not as_bool(ta.get("fast_render", False), "task_arg.fast_render"):
        return None
    occupancy, select = build_grids(
        renderer.apply_fn, renderer.settings, renderer.device,
        int(ta.get("occ_resolution", 64)),
        int(ta.get("occ_sel_resolution", 128)),
        float(ta.get("occ_threshold", 0.02)))
    print(f"occupancy grid: {occupancy[0].float().mean().item():.3f} "
          "occupied")
    probe_sub = ta.get("fast_probe_sub", 4)
    probe_sub = probe_sub if probe_sub == "auto" else int(probe_sub)
    cache = {}

    def frame(batch):
        H, W = int(batch["H"]), int(batch["W"])
        focal = float(batch["focal"])
        key = (H, W, focal)
        if key not in cache:
            cache[key] = ngp_renderer.make_ngp_frame_renderer(
                renderer.apply_fn, H, W, focal, occupancy,
                renderer.settings,
                n_candidates=int(ta.get("fast_candidates", 32)),
                n_coarse=int(ta.get("fast_coarse", 16)),
                n_fine=int(ta.get("fast_fine", 16)),
                capacity=float(ta.get("fast_capacity", 0.4)),
                out_dtype=torch.float32, return_depth=True,
                select_occupancy=select,
                occ_capacity=float(ta.get("fast_occ_capacity", 0.0)) or None,
                probe_sub=probe_sub,
                probe_stride=int(ta.get("fast_probe_stride", 1)))
        return cache[key](np.asarray(batch["pose"]).reshape(4, 4))

    return frame


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_evaluate(cfg, loader=None) -> dict:
    """Evaluate every view of ``loader`` (default: the config's test
    split); a loader is any iterable of test batches. Returns the mean
    metrics plus ``net_time`` (seconds per view) and ``rgb`` (the
    rendered (N, 3) images, numpy). With ``task_arg.fast_render`` a batch
    with a ``pose`` goes through the frame path (:func:`make_frame_fn`)."""
    device = resolve_device(cfg)
    network = load_model(cfg, device)
    renderer = build_renderer(cfg, network)
    frame = make_frame_fn(cfg, renderer)
    loader = make_test_dataset(cfg) if loader is None else loader
    evaluator = make_evaluator(cfg)
    net_time, images = [], []
    for batch in loader:
        _sync(device)
        t0 = time.perf_counter()
        if frame is not None and "pose" in batch:
            rgb, _ = frame(batch)
        else:
            rgb, _ = renderer.render(batch)
        _sync(device)
        net_time.append(time.perf_counter() - t0)
        images.append(rgb.cpu().numpy())
        evaluator.evaluate((rgb, None), batch)
    result = evaluator.summarize()
    print(result)
    times = net_time[1:] if len(net_time) > 1 else net_time
    print("net_time: ", float(np.mean(times)))
    print("fps: ", 1.0 / float(np.mean(times)))
    return {**result, "net_time": net_time, "rgb": images}


def run_network(cfg, loader=None) -> None:
    """Render up to 4 views: per-view PSNR, PNGs under
    ``result_dir/network_debug``."""
    from PIL import Image

    device = resolve_device(cfg)
    renderer = build_renderer(cfg, load_model(cfg, device))
    loader = make_test_dataset(cfg) if loader is None else loader
    out_dir = os.path.join(cfg.result_dir, "network_debug")
    os.makedirs(out_dir, exist_ok=True)
    total = 0.0
    for count, batch in enumerate(loader):
        t0 = time.perf_counter()
        rgb = renderer.render(batch)[0].cpu().numpy()
        total += time.perf_counter() - t0
        H, W = int(batch["H"]), int(batch["W"])
        print(f"view {count}: psnr {psnr_uint8(rgb, batch['colors']):.2f}")
        Image.fromarray(
            (np.clip(rgb.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8)
        ).save(os.path.join(out_dir, f"view{count:03d}.png"))
        if count == 3:
            break
    print("total_time:", total)


RUNS = {"evaluate": run_evaluate, "network": run_network}


def main(argv=None):
    # ray geometry and the plain MLP's f32 matmuls stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = parse_args(argv)
    if args.type not in RUNS:
        raise SystemExit(f"--type must be one of {sorted(RUNS)}; dataset, "
                         "input and mesh are not ported yet (ROADMAP.md "
                         "item 10)")
    RUNS[args.type](make_cfg(args))


if __name__ == "__main__":
    main()
