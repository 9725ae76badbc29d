"""Inputs made from the seed, the same for the program and the reference:
initial weights, the train views of the procedural "hard" scene, and the
orbit of viewing poses.

The scene is a copy of ``nerf_replication_tpu_torch/utils/synthetic_scene.py``
(``HARD_SPHERES``, ``split_poses``/``train_poses``, ``look_at_pose``,
``render_gt``, the RGBA uint8 store and the composite onto white), here
computed on the device without a host round trip. The orbit is
``raymarch_bench.orbit_poses``.
"""

from __future__ import annotations

import numpy as np
import torch

# (center, radius, rgb, density, tex_amp, tex_freq, tex_phase)
HARD_SPHERES = [
    ((0.0, 0.0, -0.15), 0.55, (0.80, 0.25, 0.15), 250.0,
     0.45, (23.0, 31.0, 17.0), (0.0, 1.3, 2.1)),
    ((0.62, 0.15, 0.18), 0.30, (0.15, 0.65, 0.25), 250.0,
     0.50, (55.0, 47.0, 61.0), (0.7, 0.2, 1.9)),
    ((-0.58, 0.30, -0.05), 0.27, (0.20, 0.30, 0.85), 250.0,
     0.50, (71.0, 83.0, 64.0), (2.3, 0.9, 0.4)),
    ((0.05, -0.60, 0.32), 0.24, (0.92, 0.80, 0.15), 250.0,
     0.45, (120.0, 95.0, 110.0), (1.1, 2.8, 0.6)),
    ((-0.15, 0.58, 0.40), 0.22, (0.85, 0.35, 0.75), 250.0,
     0.40, (140.0, 150.0, 125.0), (0.3, 1.7, 2.9)),
    ((0.35, 0.48, -0.38), 0.20, (0.25, 0.80, 0.80), 250.0,
     0.50, (90.0, 75.0, 105.0), (1.9, 0.5, 1.2)),
    ((-0.42, -0.45, 0.05), 0.23, (0.95, 0.55, 0.20), 250.0,
     0.45, (65.0, 58.0, 80.0), (2.6, 1.4, 0.8)),
    ((0.10, 0.05, 0.62), 0.18, (0.60, 0.60, 0.95), 250.0,
     0.50, (105.0, 130.0, 88.0), (0.9, 2.2, 1.6)),
]
CAMERA_ANGLE_X = 0.6911112070083618   # the Blender lego field of view


def focal_of(W: int) -> float:
    return W / (2.0 * np.tan(CAMERA_ANGLE_X / 2.0))


def look_at_pose(eye: np.ndarray) -> np.ndarray:
    """c2w (4, 4), OpenGL convention (camera -z looks at the origin)."""
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(right, forward)
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def train_poses(n: int) -> np.ndarray:
    """The scene's ``n`` train cameras at radius 4 (rng(1): all phis, then
    all thetas, away from the poles)."""
    g = np.random.default_rng(1)
    phis = g.uniform(0, 2 * np.pi, n)
    thetas = np.arccos(g.uniform(0.15, 0.85, n))
    eyes = np.stack([4.0 * np.sin(thetas) * np.cos(phis),
                     4.0 * np.sin(thetas) * np.sin(phis),
                     4.0 * np.cos(thetas)], -1)
    return np.stack([look_at_pose(e) for e in eyes]).astype(np.float32)


def orbit_poses(frames: int) -> np.ndarray:
    """``frames`` viewing poses on a circle of radius 4 at height 1.5."""
    return np.stack([look_at_pose(np.array(
        [4.0 * np.cos(a), 4.0 * np.sin(a), 1.5], dtype=np.float32))
        for a in np.linspace(0, 2 * np.pi, frames + 1)[:-1]])


@torch.no_grad()
def render_view(pose: np.ndarray, H: int, W: int, focal: float, device,
                n_samples: int = 384, near: float = 2.0, far: float = 6.0,
                chunk: int = 40000):
    """The analytic field by dense midpoint quadrature: rgb (H*W, 3) and
    alpha (H*W,) float32 on ``device``."""
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
    centers = torch.tensor([s[0] for s in HARD_SPHERES], **f32)
    radii = torch.tensor([s[1] for s in HARD_SPHERES], **f32)
    colors = torch.tensor([s[2] for s in HARD_SPHERES], **f32)
    densities = torch.tensor([s[3] for s in HARD_SPHERES], **f32)
    amp = torch.tensor([s[4] for s in HARD_SPHERES], **f32)
    freq = torch.tensor([s[5] for s in HARD_SPHERES], **f32)
    phase = torch.tensor([s[6] for s in HARD_SPHERES], **f32)
    shift = torch.tensor([[1.1, 0.7, 1.9]], **f32) * torch.arange(
        3, **f32)[:, None]                                     # (3 ch, 3 ax)
    rgb_out, acc_out = [], []
    for i in range(0, rd.shape[0], chunk):
        o, d = ro[i:i + chunk], rd[i:i + chunk]
        # the depths inside each primitive: |o + t d - c| < r between the
        # roots of a quadratic (d is a unit vector)
        oc = o[:, None, :] - centers                           # (N, K, 3)
        b = (d[:, None, :] * oc).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - radii * radii)
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = torch.where(disc > 0, -b - root, torch.inf)
        t1 = torch.where(disc > 0, -b + root, -torch.inf)
        inside = (t[:, None] > t0[:, None]) & (t[:, None] < t1[:, None])
        sigma = inside.float() @ densities                     # (N, S)
        # the textured colour only where a point is inside a primitive:
        # clip(rgb_k * (1 + amp_k prod_a sin(freq_ka p_a + phase_ka +
        # shift_ca)), 0, 1), weighted by the primitive's density
        n, s, k = torch.nonzero(inside, as_tuple=True)
        p = o[n] + d[n] * t[s, None]                           # (P, 3)
        arg = (freq[k][:, None, :] * p[:, None, :] + phase[k][:, None, :]
               + shift[None])                                  # (P, 3, 3)
        tex = 1.0 + amp[k][:, None] * torch.sin(arg).prod(-1)  # (P, 3)
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
    """The scene's first ``n`` train views as a loader reads them: stored
    as RGBA uint8 (truncated), composited onto white; returned as uint8
    images (n, H, W, 3) and alphas (n, H, W) on ``device``, with the poses
    (n, 4, 4) and intrinsics K (3, 3) as float32 numpy."""
    focal = focal_of(W)
    poses = train_poses(100)[:n]
    images = torch.empty(n, H, W, 3, dtype=torch.uint8, device=device)
    alphas = torch.empty(n, H, W, dtype=torch.uint8, device=device)
    for i in range(n):
        rgb, acc = render_view(poses[i], H, W, focal, device)
        rgba = (torch.clamp(torch.cat([rgb, acc[:, None]], -1), 0, 1)
                * 255).to(torch.uint8).float() / 255.0
        img = rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])
        images[i] = torch.round(img * 255.0).to(torch.uint8).reshape(H, W, 3)
        alphas[i] = (rgba[:, 3] * 255.0).round().to(torch.uint8).reshape(H, W)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]],
                 dtype=np.float32)
    return images, alphas, poses, K


def init_weights(shapes: dict, model: dict, seed: int, device) -> dict:
    """Initial weights from ``seed`` on ``device`` in two draws: every
    Dense kernel a normal clipped at 2 sigma, sigma = 1/sqrt(fan_in)
    / 0.8796 (Flax's lecun_normal's scale), biases zero but the density
    head's ``density_bias``; a table uniform in +-1e-4."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    kernels = sorted(k for k in shapes if k.endswith(".weight"))
    tables = sorted(k for k in shapes if not k.endswith((".weight", ".bias")))
    n_k = sum(int(np.prod(shapes[k])) for k in kernels)
    n_t = sum(int(np.prod(shapes[k])) for k in tables)
    z = torch.randn(n_k, generator=g, device=device).clamp_(-2.0, 2.0)
    u = torch.rand(n_t, generator=g, device=device) * 2e-4 - 1e-4
    out, at = {}, 0
    for k in kernels:
        n = int(np.prod(shapes[k]))
        std = shapes[k][1] ** -0.5 / 0.87962566103423978
        out[k] = (z[at:at + n] * std).reshape(shapes[k])
        at += n
    at = 0
    for k in tables:
        n = int(np.prod(shapes[k]))
        out[k] = u[at:at + n].reshape(shapes[k]).clone()
        at += n
    for k in shapes:
        if k.endswith(".bias"):
            out[k] = torch.zeros(shapes[k], device=device)
            if k.endswith("alpha.bias"):
                out[k] += model.get("density_bias", 0.0)
    return out
