"""Procedural scenes and their ground truth, in PyTorch.

The counterpart of nerf_replication_tpu/utils/synthetic_scene.py, which
renders ground truth with JAX. :func:`render_gt` computes what its
``render_gt`` (:179-243) computes — dense midpoint quadrature of the
analytic sphere field at 384 samples — on any torch device.
:func:`test_views` rebuilds a scene's test split as ``generate_scene``
writes it and the Blender loader reads it: the same poses
(``rng(seed + 3)``, 8 test views, radius 4), the image quantized to RGBA
uint8 and composited onto white. These are the views the JAX package's
test PSNRs were measured on. :func:`train_views` does the same for the
train split (``rng(seed + 1)``, 100 views, as the hard scene was made).
"""

from __future__ import annotations

import numpy as np
import torch

# (center xyz, radius, rgb, density) spheres
DEFAULT_SPHERES = [
    ((0.0, 0.0, 0.0), 0.45, (0.85, 0.15, 0.10), 40.0),
    ((0.55, 0.0, 0.25), 0.28, (0.10, 0.70, 0.20), 60.0),
    ((-0.5, 0.35, -0.2), 0.25, (0.15, 0.25, 0.90), 60.0),
    ((0.0, -0.55, 0.4), 0.2, (0.95, 0.85, 0.10), 80.0),
    ((-0.1, 0.55, 0.45), 0.18, (0.90, 0.40, 0.80), 80.0),
]

# "hard": sharp primitives with 3-D plaid textures;
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

# "med": the hard geometry at lower texture frequencies
MED_SPHERES = [
    (c, r, col, dens, amp, tuple(f * 0.4 for f in freq), ph)
    for (c, r, col, dens, amp, freq, ph) in HARD_SPHERES
]

SCENES = {"probe": DEFAULT_SPHERES, "hard": HARD_SPHERES,
          "med": MED_SPHERES}
CAMERA_ANGLE_X = 0.6911112070083618  # the Blender lego field of view
# generate_scene's defaults, with which the hard scene was made: the test
# poses depend on all three
SEED, N_TEST, RADIUS = 0, 8, 4.0
N_TRAIN = 100   # the hard scene's train views (scripts/tpu_queue_r5.sh:40)


def _sphere_fields(sphere):
    """A scene entry as (center, radius, rgb, density, tex or None)."""
    if len(sphere) == 4:
        return (*sphere, None)
    center, radius, color, density, amp, freq, phase = sphere
    return center, radius, color, density, (amp, freq, phase)


def _tex_mod(pts: torch.Tensor, amp, freq, phase) -> torch.Tensor:
    """3-D plaid modulation in [1 - amp, 1 + amp] per color channel."""
    out = []
    for c in range(3):
        s = (torch.sin(freq[0] * pts[..., 0] + phase[0] + 1.1 * c)
             * torch.sin(freq[1] * pts[..., 1] + phase[1] + 0.7 * c)
             * torch.sin(freq[2] * pts[..., 2] + phase[2] + 1.9 * c))
        out.append(1.0 + amp * s)
    return torch.stack(out, dim=-1)


def look_at_pose(eye: np.ndarray) -> np.ndarray:
    """c2w (4, 4), OpenGL convention (camera -z looks at the origin)."""
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def camera_rays(pose: np.ndarray, H: int, W: int, focal: float):
    """(H, W, 3) float32 ray origins and unit directions through the
    pixel corners, as the Blender loader makes them."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    dirs = np.stack([(us - W / 2.0) / focal, -(vs - H / 2.0) / focal,
                     -np.ones_like(us)], -1)
    rays_d = dirs @ pose[:3, :3].T
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d


def split_poses(n: int, split_seed: int):
    """The ``n`` poses of a split as ``generate_scene`` draws them: all
    phis, then all thetas, from ``rng(SEED + split_seed)``; so a subset
    must be taken after drawing all ``n``."""
    g = np.random.default_rng(SEED + split_seed)
    phis = g.uniform(0, 2 * np.pi, n)
    thetas = np.arccos(g.uniform(0.15, 0.85, n))  # avoid the poles
    eyes = np.stack([RADIUS * np.sin(thetas) * np.cos(phis),
                     RADIUS * np.sin(thetas) * np.sin(phis),
                     RADIUS * np.cos(thetas)], -1)
    return [look_at_pose(e) for e in eyes]


def test_poses():
    """The test-split camera poses that ``generate_scene`` writes."""
    return split_poses(N_TEST, 3)


def train_poses():
    """The train-split camera poses of a 100-view ``generate_scene``."""
    return split_poses(N_TRAIN, 1)


@torch.inference_mode()
def render_gt(pose, H, W, focal, spheres=DEFAULT_SPHERES, n_samples=384,
              near=2.0, far=6.0, device="cpu", chunk=10000):
    """Volume-render the analytic field by dense midpoint quadrature.
    Returns numpy float32 rgb (H, W, 3), alpha (H, W), depth (H, W)."""
    rays_o, rays_d = camera_rays(pose, H, W, focal)
    ro = torch.as_tensor(rays_o.reshape(-1, 3).copy(), device=device)
    rd = torch.as_tensor(rays_d.reshape(-1, 3), device=device)
    t = torch.linspace(near, far, n_samples, dtype=torch.float32,
                       device=device)
    dt = (far - near) / (n_samples - 1)
    parsed = [_sphere_fields(s) for s in spheres]
    f32 = dict(dtype=torch.float32, device=device)
    centers = torch.tensor([p[0] for p in parsed], **f32)
    radii = torch.tensor([p[1] for p in parsed], **f32)
    colors = torch.tensor([p[2] for p in parsed], **f32)
    densities = torch.tensor([p[3] for p in parsed], **f32)

    rgb_out, acc_out, depth_out = [], [], []
    for i in range(0, ro.shape[0], chunk):
        pts = ro[i:i + chunk, None] + rd[i:i + chunk, None] * t[None, :, None]
        dist = torch.linalg.norm(pts[..., None, :] - centers, dim=-1)
        w_k = (dist < radii).float() * densities           # (N, S, K)
        sigma = w_k.sum(-1)
        wsum = w_k.sum(-1, keepdim=True).clamp_min(1e-8)
        col_k = torch.stack(
            [torch.clip(colors[k] * _tex_mod(pts, *p[4]), 0.0, 1.0)
             if p[4] is not None else colors[k].expand(pts.shape)
             for k, p in enumerate(parsed)], dim=-2)       # (N, S, K, 3)
        rgb = (w_k[..., None] * col_k).sum(-2) / wsum
        alpha = 1.0 - torch.exp(-sigma * dt)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                          dim=-1)
        w = alpha * trans
        acc = w.sum(-1)
        rgb_out.append((w[..., None] * rgb).sum(-2))
        acc_out.append(acc)
        depth_out.append((w * t).sum(-1) / acc.clamp_min(1e-8))
    return (torch.cat(rgb_out).cpu().numpy().reshape(H, W, 3),
            torch.cat(acc_out).cpu().numpy().reshape(H, W),
            torch.cat(depth_out).cpu().numpy().reshape(H, W))


def _stored_and_loaded(pose, H, W, focal, scene, device):
    """Ground truth as ``generate_scene`` stores it (RGBA uint8) and the
    Blender loader reads it: the image composited onto white, float32
    (H, W, 3), and the stored alpha, float32 (H, W)."""
    rgb, alpha, _ = render_gt(pose, H, W, focal, SCENES[scene], device=device)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    img = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
    img = np.asarray(img, dtype=np.float32) / 255.0
    return (img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:]),
            np.ascontiguousarray(img[..., 3]))


def train_views(scene: str, H: int, W: int, idx, device="cpu"):
    """Train views ``idx`` of a 100-view ``generate_scene(scene)`` as the
    Blender loader's ``as_arrays`` and ``alpha_arrays`` give them: (images
    (n, H, W, 3) float32, poses (n, 4, 4) float32, K (3, 3) float32,
    alphas (n, H, W) float32), ground truth from :func:`render_gt` on
    ``device``."""
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2.0))
    poses = train_poses()
    views = [_stored_and_loaded(poses[i], H, W, focal, scene, device)
             for i in idx]
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]],
                 dtype=np.float32)
    return (np.stack([v[0] for v in views]).astype(np.float32),
            np.stack([poses[i] for i in idx]).astype(np.float32), K,
            np.stack([v[1] for v in views]).astype(np.float32))


def test_views(scene: str, H: int, W: int, idx, device="cpu") -> list[dict]:
    """Test views ``idx`` of ``generate_scene(scene)`` as the
    Blender loader's test batches (colors, rays_o, rays_d, H, W, id,
    pose, focal), with ground truth from :func:`render_gt` on ``device``
    stored and loaded as ``generate_scene`` and the loader do it: RGBA
    uint8, then composited onto white in float32."""
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2.0))
    poses = test_poses()
    batches = []
    for i in idx:
        pose = poses[i]
        img, _ = _stored_and_loaded(pose, H, W, focal, scene, device)
        rays_o, rays_d = camera_rays(pose, H, W, focal)
        batches.append({
            "colors": img.reshape(-1, 3).astype(np.float32),
            "rays_o": rays_o.reshape(-1, 3).astype(np.float32),
            "rays_d": rays_d.reshape(-1, 3).astype(np.float32),
            "H": np.int32(H), "W": np.int32(W), "id": np.int32(i),
            "pose": pose.astype(np.float32), "focal": np.float32(focal),
        })
    return batches
