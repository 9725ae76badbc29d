"""Device-resident training ray pipeline.

The counterpart of nerf_replication_tpu/datasets/pipeline.py:26-151: the
whole train split lives on the device as uint8 (the PNG sources are 8-bit,
so /255 round-trips exactly), and each step draws one random image and
``n_rays`` random pixels of it from a ``torch.Generator`` on the device,
with no host-to-device copy per step. The first ``precrop_iters`` global
steps draw from the centre crop (``precrop_frac`` of each side).
``sample_across_images`` draws each ray's image independently. With
``alphas`` (the coverage of RGBA sources, uint8 on the device too) a batch
also holds ``alpha``, which random-background training needs.

Ray geometry stays in float32 and never runs as a TF32 matmul: the camera
rotation is applied as an elementwise product and sum.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_uint8(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.uint8:
        a = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
    return a


class DeviceRayPipeline:
    def __init__(self, images, poses, K, n_rays: int = 1024,
                 precrop_iters: int = 0, precrop_frac: float = 0.5,
                 sample_across_images: bool = False, alphas=None,
                 device="cpu"):
        """images (N, H, W, 3) and alphas (N, H, W) or None, in [0, 1] or
        uint8; poses (N, 4, 4) c2w; K (3, 3) intrinsics."""
        self.device = torch.device(device)
        self.images = torch.as_tensor(_to_uint8(images), device=self.device)
        self.alphas = None if alphas is None else torch.as_tensor(
            _to_uint8(alphas), device=self.device)
        self.poses = torch.as_tensor(np.asarray(poses, np.float32),
                                     device=self.device)
        self.n_images, self.H, self.W = self.images.shape[:3]
        K = np.asarray(K, np.float32)
        self.focal, self.cx, self.cy = (float(K[0, 0]), float(K[0, 2]),
                                        float(K[1, 2]))
        self.n_rays = n_rays
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self.sample_across_images = sample_across_images

    def _pixel_rays(self, pose: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor):
        """Rays through pixels (u, v) of one camera ``pose`` (4, 4) or of
        one camera a pixel (n, 4, 4), float32: rays_d = normalize(dirs @
        R^T), rays_o = the camera centre."""
        dirs = torch.stack([(u - self.cx) / self.focal,
                            -(v - self.cy) / self.focal,
                            -torch.ones_like(u)], dim=-1)
        rays_d = (dirs[..., None, :] * pose[..., :3, :3]).sum(-1)
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return pose[..., :3, 3].expand(rays_d.shape), rays_d

    def bounds(self, step: int):
        """Pixel bounds ``(u_lo, u_hi, v_lo, v_hi)`` (high exclusive) at
        global step ``step``: the centre crop during precrop."""
        if step < self.precrop_iters:
            dW = int(self.W // 2 * self.precrop_frac)
            dH = int(self.H // 2 * self.precrop_frac)
            return (self.W // 2 - dW, self.W // 2 + dW,
                    self.H // 2 - dH, self.H // 2 + dH)
        return 0, self.W, 0, self.H

    def sample(self, generator: torch.Generator, step: int = 1 << 30) -> dict:
        """One training batch {rays_o, rays_d, colors}, each (n_rays, 3)
        float32 on the device, and {alpha} (n_rays,) when the pipeline
        holds alphas."""
        u_lo, u_hi, v_lo, v_hi = self.bounds(step)
        kw = dict(generator=generator, device=self.device)
        shape = () if not self.sample_across_images else (self.n_rays,)
        img = torch.randint(0, self.n_images, shape, **kw)
        u = torch.randint(u_lo, u_hi, (self.n_rays,), **kw)
        v = torch.randint(v_lo, v_hi, (self.n_rays,), **kw)
        colors = self.images[img, v, u].float() / 255.0
        rays_o, rays_d = self._pixel_rays(self.poses[img], u.float(),
                                          v.float())
        batch = {"rays_o": rays_o.contiguous(), "rays_d": rays_d,
                 "colors": colors}
        if self.alphas is not None:
            batch["alpha"] = self.alphas[img, v, u].float() / 255.0
        return batch
