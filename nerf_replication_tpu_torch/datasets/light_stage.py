"""Light-stage / ZJU-MoCap multi-camera dataset, the port's copy of
nerf_replication_tpu/datasets/light_stage.py (a parent-framework leftover
that no shipped config reaches): the ``annots.npy`` camera rig (K, R, T
per camera, per-frame image lists), camera and frame range selection,
per-frame world bounding boxes from ``<vertices_dir>/<frame>.npy``, and
world rays through a w2c [R|T] camera (OpenCV convention). Train items draw
``N_rays`` pixels with numpy's global generator, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np

from ..registry import register


class Dataset:
    def __init__(self, cfg=None, **kwargs):
        self.data_root = kwargs["data_root"]
        self.split = kwargs.get("split", "train")
        self.input_ratio = float(kwargs.get("input_ratio", 1.0))
        n_rays = 1024
        if cfg is not None:
            n_rays = int(cfg.get("task_arg", {}).get("N_rays", 1024))
        self.n_rays = n_rays

        annots = np.load(os.path.join(self.data_root, "annots.npy"),
                         allow_pickle=True).item()
        self.cams = annots["cams"]
        num_cams = len(self.cams["K"])
        c0, c1, cs = kwargs.get("cameras", [0, -1, 1])
        c1 = num_cams if c1 == -1 else c1
        self.render_cameras = np.arange(num_cams)[c0:c1:cs]

        num_frames = len(annots["ims"])
        f0, f1, fs = kwargs.get("frames", [0, -1, 1])
        f1 = num_frames if f1 == -1 else f1

        self.items = []
        self.bboxs = {}
        vertices_dir = kwargs.get("vertices_dir", "new_vertices")
        vertices_start = 1 if ("313" in self.data_root or
                               "315" in self.data_root) else 0
        for frame_index in np.arange(num_frames)[f0:f1:fs]:
            for camera_index in self.render_cameras:
                self.items.append({
                    "img_path": os.path.join(
                        self.data_root,
                        annots["ims"][frame_index]["ims"][camera_index]),
                    "frame_index": int(frame_index),
                    "camera_index": int(camera_index),
                })
            vpath = os.path.join(self.data_root, vertices_dir,
                                 f"{frame_index + vertices_start}.npy")
            if os.path.exists(vpath):
                vertices = np.load(vpath)
                self.bboxs[int(frame_index)] = np.concatenate(
                    [vertices.min(0) - 0.05, vertices.max(0) + 0.05])

    def _camera(self, idx: int):
        K = np.array(self.cams["K"][idx], dtype=np.float32)
        R = np.array(self.cams["R"][idx], dtype=np.float32)
        T = np.array(self.cams["T"][idx], dtype=np.float32).reshape(3) / 1000.0
        if self.input_ratio != 1.0:
            K = K.copy()
            K[:2] *= self.input_ratio
        return K, R, T

    def __getitem__(self, index: int) -> dict:
        from PIL import Image as PILImage

        item = self.items[index]
        img = np.asarray(PILImage.open(item["img_path"]),
                         dtype=np.float32) / 255.0
        if self.input_ratio != 1.0:
            H, W = img.shape[:2]
            new = (int(W * self.input_ratio), int(H * self.input_ratio))
            img = np.asarray(PILImage.fromarray(
                (img * 255).astype(np.uint8)).resize(new),
                dtype=np.float32) / 255.0
        H, W = img.shape[:2]
        K, R, T = self._camera(item["camera_index"])

        if self.split == "train":
            idx = np.random.choice(H * W, min(self.n_rays, H * W),
                                   replace=False)
            u = (idx % W).astype(np.float32)
            v = (idx // W).astype(np.float32)
        else:
            us, vs = np.meshgrid(np.arange(W), np.arange(H))
            u = us.ravel().astype(np.float32)
            v = vs.ravel().astype(np.float32)
        colors = img[v.astype(int), u.astype(int), :3]

        # world rays through a w2c = [R|T] camera (OpenCV convention)
        pix = np.stack([u, v, np.ones_like(u)], -1)
        cam_dirs = pix @ np.linalg.inv(K).T
        rays_d = cam_dirs @ R  # R^T in world
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(-R.T @ T, rays_d.shape).copy()

        out = {
            "colors": colors.astype(np.float32),
            "rays_o": rays_o.astype(np.float32),
            "rays_d": rays_d.astype(np.float32),
            "H": np.int32(H), "W": np.int32(W), "id": np.int32(index),
            "frame_index": np.int32(item["frame_index"]),
            "camera_index": np.int32(item["camera_index"]),
        }
        bbox = self.bboxs.get(item["frame_index"])
        if bbox is not None:
            out["wbounds"] = bbox.astype(np.float32)
        return out

    def __len__(self):
        return len(self.items)


@register("dataset", "light_stage", aliases=(
    "src.datasets.light_stage", "nerf_replication_tpu.datasets.light_stage"))
def _make_light_stage(cfg, **kwargs):
    return Dataset(cfg=cfg, **kwargs)
