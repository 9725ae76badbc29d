"""Blender / NeRF-synthetic dataset (host side, numpy).

The port's copy of nerf_replication_tpu/datasets/nerf/blender.py, whose
package cannot be imported without JAX. Same behaviour: loads
``transforms_{split}.json`` + PNGs, honors ``cfg.scene``, ``cams`` and
``test_skip``, composites RGBA onto the background (the JAX loader's
``keep_alpha_quirk`` is not ported), focal from
``camera_angle_x``; the train split returns a random ``N_rays`` subset of
pixels, test/val every pixel. ``__getitem__`` returns the same batch dict
(colors, rays_o, rays_d, H, W, id, pose, focal, and depth/normal on the
test split when present). ``as_arrays`` stacks the split for the
device-resident training sampler (datasets/pipeline.py) and
``alpha_arrays`` the alpha channels of RGBA sources, which
random-background training needs.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...config import as_bool
from ...registry import register


def _load_png(path: str, size: tuple[int, int], resample) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.size != size:
        img = img.resize(size, resample)
    return np.asarray(img, dtype=np.float32)


class Dataset:
    def __init__(self, cfg=None, **kwargs):
        from PIL import Image

        self.data_root = kwargs.get("data_root", "data/nerf_synthetic")
        scene = (cfg.get("scene", "lego") if cfg is not None
                 else kwargs.get("scene", "lego"))
        self.scene_root = os.path.join(self.data_root, scene)
        self.split = kwargs.get("split", "val")
        self.H = int(kwargs.get("H", 800))
        self.W = int(kwargs.get("W", 800))
        self.input_ratio = float(kwargs.get("input_ratio", 1.0))
        ta = cfg.get("task_arg", {}) if cfg is not None else {}
        self.n_rays = int(ta.get("N_rays", 1024))
        self.white_bkgd = as_bool(ta.get("white_bkgd", True), "white_bkgd")
        test_skip = int(ta.get("test_skip", 1))
        cams = kwargs.get("cams", [0, -1, 1])
        self._rng = np.random.default_rng(kwargs.get("seed", None))

        with open(os.path.join(self.scene_root,
                               f"transforms_{self.split}.json")) as f:
            meta = json.load(f)
        self.camera_angle_x = float(meta["camera_angle_x"])
        if self.input_ratio != 1.0:
            self.H = int(self.H * self.input_ratio)
            self.W = int(self.W * self.input_ratio)

        frames = meta["frames"]
        start, stop, step = (list(cams) + [0, -1, 1])[:3]
        stop = len(frames) if stop == -1 else stop
        frames = frames[start:stop:step]
        if self.split in ("test", "val") and test_skip > 1:
            frames = frames[::test_skip]

        size = (self.W, self.H)
        self.images, self.poses, self.depths, self.normals = [], [], [], []
        self.alphas = []       # (H, W) float32 coverage of RGBA sources
        for frame in frames:
            base = os.path.join(self.scene_root, frame["file_path"])
            img = _load_png(base + ".png", size, Image.BILINEAR) / 255.0
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            if img.shape[-1] == 4:
                self.alphas.append(img[..., 3].astype(np.float32))
                bg = 1.0 if self.white_bkgd else 0.0
                img = img[..., :3] * img[..., 3:] + bg * (1.0 - img[..., 3:])
            self.images.append(img.astype(np.float32))
            self.poses.append(np.array(frame["transform_matrix"],
                                       dtype=np.float32))
            if self.split == "test":
                if os.path.exists(base + "_depth_0001.png"):
                    self.depths.append(_load_png(
                        base + "_depth_0001.png", size, Image.NEAREST))
                if os.path.exists(base + "_normal_0001.png"):
                    self.normals.append(_load_png(
                        base + "_normal_0001.png", size, Image.BILINEAR)
                        / 255.0)

    @property
    def focal(self) -> float:
        return self.W / (2.0 * np.tan(self.camera_angle_x / 2.0))

    def as_arrays(self):
        """The whole split for the device-resident sampler: (images
        (N, H, W, 3) float32, poses (N, 4, 4) float32, K (3, 3) float32)."""
        f = self.focal
        K = np.array([[f, 0, self.W / 2.0], [0, f, self.H / 2.0],
                      [0, 0, 1.0]], dtype=np.float32)
        return np.stack(self.images), np.stack(self.poses), K

    def alpha_arrays(self):
        """(N, H, W) float32 coverage, or None when the source images
        carried no alpha channel."""
        if len(self.alphas) != len(self.images):
            return None
        return np.stack(self.alphas)

    def _rays_for_pixels(self, pose, u, v):
        f = self.focal
        dirs = np.stack([(u - self.W / 2.0) / f, -(v - self.H / 2.0) / f,
                         -np.ones_like(u, dtype=np.float32)], -1)
        rays_d = dirs @ pose[:3, :3].T
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape).copy()
        return rays_o.astype(np.float32), rays_d.astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        image, pose = self.images[index], self.poses[index]
        if self.split == "train":
            idx = self._rng.choice(self.H * self.W, self.n_rays, replace=False)
            u = (idx % self.W).astype(np.float32)
            v = (idx // self.W).astype(np.float32)
        else:
            us, vs = np.meshgrid(np.arange(self.W), np.arange(self.H))
            u = us.ravel().astype(np.float32)
            v = vs.ravel().astype(np.float32)
        ui, vi = u.astype(np.int64), v.astype(np.int64)
        rays_o, rays_d = self._rays_for_pixels(pose, u, v)
        out = {"colors": image[vi, ui], "rays_o": rays_o, "rays_d": rays_d,
               "H": np.int32(self.H), "W": np.int32(self.W),
               "id": np.int32(index), "pose": pose.astype(np.float32),
               "focal": np.float32(self.focal)}
        if self.split == "test":
            if index < len(self.depths):
                out["depth"] = self.depths[index][vi, ui]
            if index < len(self.normals):
                out["normal"] = self.normals[index][vi, ui]
        return out

    def __len__(self) -> int:
        return len(self.images)


@register("dataset", "nerf.blender", aliases=(
    "src.datasets.nerf.blender", "nerf_replication_tpu.datasets.nerf.blender"))
def _make_blender(cfg, **kwargs):
    return Dataset(cfg=cfg, **kwargs)
