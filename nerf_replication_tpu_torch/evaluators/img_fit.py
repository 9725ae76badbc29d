"""img_fit evaluator, the counterpart of
nerf_replication_tpu/evaluators/img_fit.py: the float PSNR of the fitted
image, the side-by-side ground truth | prediction ``<result_dir>/vis/res.jpg``
and ``<result_dir>/metrics.json``. Takes the network's output as tensors
(any device) or numpy arrays."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..registry import register
from .metrics import psnr


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Evaluator:
    def __init__(self, cfg=None):
        self.psnrs: list[float] = []
        self.result_dir = cfg.result_dir if cfg is not None else None
        if self.result_dir:
            os.makedirs(os.path.join(self.result_dir, "vis"), exist_ok=True)

    def evaluate(self, output, batch) -> dict:
        """``output``: a dict with 'rgb'; ``batch``: rgb and meta H/W."""
        H = int(np.asarray(_numpy(batch["meta"]["H"])).reshape(-1)[0])
        W = int(np.asarray(_numpy(batch["meta"]["W"])).reshape(-1)[0])
        pred = _numpy(output["rgb"]).reshape(H, W, 3)
        gt = _numpy(batch["rgb"]).reshape(H, W, 3)
        val = psnr(gt, pred, data_range=1.0)
        self.psnrs.append(val)
        if self.result_dir:
            from PIL import Image

            side = np.concatenate([gt, pred], axis=1)
            Image.fromarray((np.clip(side, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(self.result_dir, "vis", "res.jpg"))
        return {"psnr": val}

    def summarize(self) -> dict:
        ret = {"psnr": float(np.mean(self.psnrs)) if self.psnrs else 0.0}
        self.psnrs = []
        if self.result_dir:
            with open(os.path.join(self.result_dir, "metrics.json"), "w") as f:
                json.dump(ret, f)
        return ret


@register("evaluator", "img_fit", aliases=(
    "src.evaluators.img_fit", "nerf_replication_tpu.evaluators.img_fit"))
def _make_img_fit_evaluator(cfg):
    return Evaluator(cfg)
