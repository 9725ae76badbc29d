"""Latent-code dataset, the port's copy of
nerf_replication_tpu/datasets/latent.py: a per-scene ``<scene>.npy`` of
packed latent vectors, every item the split of its columns (1, 31, 128,
the rest). A parent-framework leftover that no shipped config reaches."""

from __future__ import annotations

import os

import numpy as np

from ..registry import register


class Dataset:
    def __init__(self, cfg=None, **kwargs):
        data_root = kwargs.get("data_root", "data")
        scene = cfg.get("scene", "lego") if cfg is not None else kwargs.get(
            "scene", "lego")
        self.data = np.load(os.path.join(data_root, scene + ".npy"))
        self.batch_size = int(kwargs.get("batch_size", 1024))

    def __getitem__(self, index):
        x_1, x_2 = self.data[:, :1], self.data[:, 1:32]
        y_1, y_2 = self.data[:, 32:32 + 128], self.data[:, 32 + 128:]
        return x_1, x_2, y_1, y_2

    def __len__(self):
        return len(self.data)


@register("dataset", "latent", aliases=(
    "src.datasets.latent", "nerf_replication_tpu.datasets.latent"))
def _make_latent(cfg, **kwargs):
    return Dataset(cfg=cfg, **kwargs)
