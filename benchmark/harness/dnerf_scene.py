"""The dynamic hard scene, the same for the program and the reference: the
train views of ``hard_dnerf``, made from the seedless scene on the device.

A copy of ``nerf_replication_tpu_torch/utils/synthetic_scene.py``'s
dynamic variant (``HARD_MOTION``, ``spheres_at``, ``frame_times``): the
hard scene's primitive k moved at time t by amp_k * sin(pi * rate_k * t),
its texture carried along (its phase moved by -freq * offset), t = 0 the
hard scene itself. View i of n is at time i / (n - 1), at the i-th of
``inputs.train_poses(n)``. Rendered by ``inputs.render_view``'s quadrature
of the analytic field, stored as RGBA uint8 and composited onto white as a
loader reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import HARD_SPHERES, focal_of, train_poses

# (amp xyz, rate)
HARD_MOTION = [
    ((0.00, 0.00, 0.15), 1.0),
    ((0.00, 0.25, 0.00), 0.5),
    ((0.20, 0.00, 0.10), 2.0),
    ((-0.15, 0.10, 0.00), 1.0),
    ((0.00, -0.20, -0.10), 0.5),
    ((0.15, 0.15, 0.00), 2.0),
    ((0.00, 0.20, 0.15), 1.0),
    ((-0.20, 0.00, 0.00), 0.5),
]


def spheres_at(t: float) -> list:
    """The hard scene's primitives at time ``t``."""
    out = []
    for (center, radius, color, density, amp, freq, phase), (a, rate) in \
            zip(HARD_SPHERES, HARD_MOTION):
        off = [ak * float(np.sin(np.pi * rate * t)) for ak in a]
        out.append((tuple(c + o for c, o in zip(center, off)), radius, color,
                    density, amp, freq,
                    tuple(p - f * o for p, f, o in zip(phase, freq, off))))
    return out


def frame_times(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.float32) / max(n - 1, 1)).astype(
        np.float32)


@torch.no_grad()
def render_view(pose: np.ndarray, H: int, W: int, focal: float, spheres,
                device, n_samples: int = 384, near: float = 2.0,
                far: float = 6.0, chunk: int = 40000):
    """``inputs.render_view`` for the primitives ``spheres``: rgb (H*W, 3)
    and alpha (H*W,) float32 on ``device``."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    dirs = np.stack([(us - W / 2.0) / focal, -(vs - H / 2.0) / focal,
                     -np.ones_like(us)], -1)
    rays_d = dirs @ pose[:3, :3].T
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rd = torch.as_tensor(rays_d.reshape(-1, 3), dtype=torch.float32,
                         device=device)
    ro = torch.as_tensor(pose[:3, 3], device=device).expand(rd.shape)
    t = torch.linspace(near, far, n_samples, device=device)
    dt = (far - near) / (n_samples - 1)
    f32 = dict(dtype=torch.float32, device=device)
    centers = torch.tensor([s[0] for s in spheres], **f32)
    radii = torch.tensor([s[1] for s in spheres], **f32)
    colors = torch.tensor([s[2] for s in spheres], **f32)
    densities = torch.tensor([s[3] for s in spheres], **f32)
    amp = torch.tensor([s[4] for s in spheres], **f32)
    freq = torch.tensor([s[5] for s in spheres], **f32)
    phase = torch.tensor([s[6] for s in spheres], **f32)
    shift = torch.tensor([[1.1, 0.7, 1.9]], **f32) * torch.arange(
        3, **f32)[:, None]
    rgb_out, acc_out = [], []
    for i in range(0, rd.shape[0], chunk):
        o, d = ro[i:i + chunk], rd[i:i + chunk]
        oc = o[:, None, :] - centers
        b = (d[:, None, :] * oc).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - radii * radii)
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = torch.where(disc > 0, -b - root, torch.inf)
        t1 = torch.where(disc > 0, -b + root, -torch.inf)
        inside = (t[:, None] > t0[:, None]) & (t[:, None] < t1[:, None])
        sigma = inside.float() @ densities
        n, s, k = torch.nonzero(inside, as_tuple=True)
        p = o[n] + d[n] * t[s, None]
        arg = (freq[k][:, None, :] * p[:, None, :] + phase[k][:, None, :]
               + shift[None])
        tex = 1.0 + amp[k][:, None] * torch.sin(arg).prod(-1)
        col = torch.clip(colors[k] * tex, 0.0, 1.0) * densities[k][:, None]
        num = torch.zeros(o.shape[0] * n_samples, 3, device=device)
        num.index_add_(0, n * n_samples + s, col)
        rgb = (num.reshape(o.shape[0], n_samples, 3)
               / sigma[..., None].clamp_min(1e-8))
        alpha = 1.0 - torch.exp(-sigma * dt)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                          dim=-1)
        w = alpha * trans
        rgb_out.append((w[..., None] * rgb).sum(-2))
        acc_out.append(w.sum(-1))
    return torch.cat(rgb_out), torch.cat(acc_out)


@torch.no_grad()
def train_views(n: int, H: int, W: int, device):
    """The scene's ``n`` train views as a loader reads them: uint8 images
    (n, H, W, 3) and alphas (n, H, W) on ``device``; float32 numpy poses
    (n, 4, 4), K (3, 3) and times (n,)."""
    focal = focal_of(W)
    poses = train_poses(n)
    times = frame_times(n)
    images = torch.empty(n, H, W, 3, dtype=torch.uint8, device=device)
    alphas = torch.empty(n, H, W, dtype=torch.uint8, device=device)
    for i in range(n):
        rgb, acc = render_view(poses[i], H, W, focal,
                               spheres_at(float(times[i])), device)
        rgba = (torch.clamp(torch.cat([rgb, acc[:, None]], -1), 0, 1)
                * 255).to(torch.uint8).float() / 255.0
        img = rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])
        images[i] = torch.round(img * 255.0).to(torch.uint8).reshape(H, W, 3)
        alphas[i] = (rgba[:, 3] * 255.0).round().to(torch.uint8).reshape(H, W)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]],
                 dtype=np.float32)
    return images, alphas, poses, K, times
