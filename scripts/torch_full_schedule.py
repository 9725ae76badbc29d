#!/usr/bin/env python3
"""Full-schedule training of the PyTorch/CUDA port on the hard scene, with
an eval after every epoch, resumable across processes.

    python3 scripts/torch_full_schedule.py --model ngp
    python3 scripts/torch_full_schedule.py --model freq --budget_s 1500

``ngp``: configs/nerf/hard_ngp.yaml at ``log2_bricks`` 9, 31 epochs of 500
steps (15,500) from a fresh seed-0 init on all 100 train views, eval on
hard test views 0-7: the schedule and views of the JAX record
result/quality_r5_ngp_hard.jsonl (29.34 dB, the mean over those views).
``freq``: configs/nerf/hard.yaml as committed, 120 epochs of 500 steps on
all 100 views, eval on test views 0 and 4 (the 31.75 dB of
data/pretrain/hard, BENCH_r05.json ``dense_test_psnr``).

Ground truth is rendered on the card (``synthetic_scene``), 800x800. Every
epoch runs through the train CLI's ``train()``, resumed from the
checkpoint of the one before (``latest.ckpt`` under build/full_<model>),
then the test views render densely through the eval renderer: uint8 PSNR
and SSIM. A run stops starting epochs after ``--budget_s`` seconds and is
continued by the same command (carry build/full_<model>, its checkpoint
and log, between machines). One JSON line an epoch goes to
build/full_<model>/log.jsonl and to stdout, then a final line with the
mean PSNR against the record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RUNS = {
    "ngp": dict(cfg="configs/nerf/hard_ngp.yaml", epochs=31,
                views=list(range(8)), record_db=29.34,
                opts=["network.xyz_encoder.log2_bricks", "9"]),
    "freq": dict(cfg="configs/nerf/hard.yaml", epochs=120, views=[0, 4],
                 record_db=31.75, opts=[]),
}
H = W = 800
N_TRAIN = 100


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=sorted(RUNS), required=True)
    parser.add_argument("--budget_s", type=float, default=3000.0)
    parser.add_argument("--eval_pretrain", metavar="DIR", default=None,
                        help="only evaluate DIR/pretrain.ckpt (e.g. the "
                             "record's committed checkpoint) on the run's "
                             "test views, densely, and exit")
    args = parser.parse_args(argv)
    run = RUNS[args.model]
    os.chdir(ROOT)
    model_dir = os.path.join("build", f"full_{args.model}")
    os.makedirs(model_dir, exist_ok=True)

    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8, ssim
    from nerf_replication_tpu_torch.run import build_renderer, resolve_device
    from nerf_replication_tpu_torch.train.cli import train
    from nerf_replication_tpu_torch.utils import synthetic_scene

    def cfg_for(*opts):
        return make_cfg(parse_args([
            "--cfg_file", run["cfg"], *run["opts"], "trained_model_dir",
            model_dir, "save_ep", "100000", "save_latest_ep", "1",
            "eval_ep", "100000", *opts]))

    device = resolve_device(cfg_for())
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    views = synthetic_scene.test_views("hard", H, W, run["views"],
                                       device=device)

    def evaluate(cfg, network) -> tuple[list, list]:
        renderer = build_renderer(cfg, network)
        psnrs, ssims = [], []
        for view in views:
            rgb = renderer.render(view)[0].cpu().numpy().reshape(H, W, 3)
            gt = view["colors"].reshape(H, W, 3)
            psnrs.append(psnr_uint8(rgb, gt))
            ssims.append(ssim((np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                              (np.clip(gt, 0, 1) * 255).astype(np.uint8),
                              win_size=7, channel_axis=2))
        return psnrs, ssims

    if args.eval_pretrain:
        from nerf_replication_tpu_torch.run import load_model as load_eval

        cfg = cfg_for("pretrain_path", args.eval_pretrain)
        psnrs, ssims = evaluate(cfg, load_eval(cfg, device))
        print(json.dumps({"model": args.model, "pretrain": args.eval_pretrain,
                          "psnr": float(np.mean(psnrs)),
                          "ssim": float(np.mean(ssims)), "view_psnr": psnrs,
                          "views": run["views"], "device": smi}), flush=True)
        return 0
    arrays = synthetic_scene.train_views(
        "hard", H, W, range(N_TRAIN), device=device)
    print(f"ground truth: {N_TRAIN} train and {len(views)} test "
          f"views at {H}x{W} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    from nerf_replication_tpu_torch.utils.ckpt_utils import load_model

    ckpt_dir = cfg_for().trained_model_dir   # <dir>/<task>/<scene>/<exp>
    log_path = os.path.join(model_dir, "log.jsonl")
    start = time.perf_counter()
    while True:
        payload = load_model(ckpt_dir)
        epoch = 0 if payload is None else payload["epoch"] + 1
        if epoch >= run["epochs"] or \
                time.perf_counter() - start > args.budget_s:
            break
        cfg = cfg_for("train.epoch", str(epoch + 1))
        trainer = train(cfg, train_arrays=arrays, val_loader=views)
        summary = trainer.summaries[-1]
        psnrs, ssims = evaluate(cfg, trainer.network)
        line = {"epoch": epoch, "step": trainer.step,
                "rays_per_s": summary["rays_per_s"],
                "train_s": summary["wall"],
                "loss": float(np.mean(summary["loss"])),
                "psnr": float(np.mean(psnrs)),
                "ssim": float(np.mean(ssims)),
                "view_psnr": psnrs, "peak_gb": summary["peak_bytes"] / 1e9,
                "device": smi}
        print(json.dumps(line), flush=True)
        with open(log_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        del trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()

    done = epoch >= run["epochs"]
    lines = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            lines = [json.loads(x) for x in f if x.strip()]
    last = lines[-1] if lines else {}
    print(json.dumps({"model": args.model, "finished": done,
                      "epochs_done": epoch, "of": run["epochs"],
                      "psnr": last.get("psnr"),
                      "record_db": run["record_db"],
                      "diff_db": (None if not lines else
                                  last["psnr"] - run["record_db"]),
                      "views": run["views"], "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
