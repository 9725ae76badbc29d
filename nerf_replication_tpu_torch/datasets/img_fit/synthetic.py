"""2D image-fitting dataset, the port's copy of
nerf_replication_tpu/datasets/img_fit/synthetic.py: one view of a
NeRF-synthetic scene (``view`` of its transforms_train.json), composited
onto white, resized by ``input_ratio`` with PIL's BOX filter; items are
``{uv, rgb, meta{H, W}}``, uv in [0, 1] on the pixel grid. The train split
draws ``N_pixels`` pixels without replacement from ``default_rng(seed)``
(``seed`` None by default, as in the JAX package), the test split gives
the whole image.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from ...registry import register


class Dataset:
    def __init__(self, cfg=None, **kwargs):
        data_root = kwargs.get("data_root", "data/nerf_synthetic")
        scene = cfg.get("scene", "lego") if cfg is not None else "lego"
        self.data_root = os.path.join(data_root, scene)
        self.split = kwargs.get("split", "train")
        self.input_ratio = float(kwargs.get("input_ratio", 1.0))
        view = int(kwargs.get("view", 0))
        ta = cfg.get("task_arg", {}) if cfg is not None else {}
        self.batch_size = int(ta.get("N_pixels", 8192))
        self._rng = np.random.default_rng(kwargs.get("seed", None))

        with open(os.path.join(self.data_root, "transforms_train.json")) as f:
            info = json.load(f)
        rel = info["frames"][view]["file_path"]
        rel = rel[2:] if rel.startswith("./") else rel
        img_path = os.path.join(self.data_root, rel + ".png")

        img = np.asarray(Image.open(img_path), dtype=np.float32) / 255.0
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        if self.input_ratio != 1.0:
            H, W = img.shape[:2]
            new = (int(W * self.input_ratio), int(H * self.input_ratio))
            img = np.asarray(
                Image.fromarray((img * 255).astype(np.uint8)).resize(
                    new, Image.BOX),
                dtype=np.float32) / 255.0
        self.img = img.astype(np.float32)

        H, W = img.shape[:2]
        X, Y = np.meshgrid(np.arange(W), np.arange(H))
        u = X.astype(np.float32) / (W - 1)
        v = Y.astype(np.float32) / (H - 1)
        self.uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        if self.split == "train":
            ids = self._rng.choice(len(self.uv), self.batch_size, replace=False)
            uv = self.uv[ids]
            rgb = self.img.reshape(-1, 3)[ids]
        else:
            uv = self.uv
            rgb = self.img.reshape(-1, 3)
        return {
            "uv": uv,
            "rgb": rgb,
            "meta": {"H": np.int32(self.img.shape[0]),
                     "W": np.int32(self.img.shape[1])},
        }

    def __len__(self) -> int:
        return 1


@register("dataset", "img_fit.synthetic", aliases=(
    "src.datasets.img_fit.synthetic",
    "nerf_replication_tpu.datasets.img_fit.synthetic"))
def _make_img_fit(cfg, **kwargs):
    return Dataset(cfg=cfg, **kwargs)
