"""Hierarchical volume rendering, the training step and the dense frame in
plain PyTorch, after the NeRF paper (Mildenhall et al. 2020, section 5
and its appendix): stratified coarse samples, inverse-CDF fine samples
from the coarse weights, the sorted union through the fine MLP, alpha
compositing onto a white background; the loss is the coarse and the
fine image's squared error; the update is Adam after an element-wise
gradient clip.

The random draws of a training step follow the measured program's
order and shapes on one ``torch.Generator`` an epoch: the image, the
pixels' columns and rows, the background colours (``random_bkgd``), the
coarse jitter, the fine samples' ``u``. On the same device and seed they
are the program's draws, so both sides train on the same rays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .field import Field


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of a training epoch, a function of (seed,
    epoch): the measured trainer's rule."""
    return int(np.random.SeedSequence([int(seed), int(epoch)])
               .generate_state(1, np.uint64)[0] >> 1)


def weights_of(sigma, t, finite_tail: bool):
    """Compositing weights from raw densities (softplus-activated)."""
    delta = t[..., 1:] - t[..., :-1]
    tail = (delta[..., -1:] if finite_tail
            else torch.full_like(delta[..., :1], 1e10))
    delta = torch.cat([delta, tail], -1)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(raw, w, t):
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    acc = w.sum(-1)
    return rgb + (1.0 - acc[..., None]), acc, (w * t).sum(-1)


def sample_pdf(bins, weights, n, u=None):
    """Inverse-CDF samples of each row's piecewise-constant pdf over
    ``bins`` (..., B+1) with ``weights`` (..., B) + 1e-5; at ``u`` or, if
    None, at ``linspace(0, 1, n)``. A ``u`` past the last CDF value lands
    on the last edge; repeated CDF values take the last of the repeats."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
            *cdf.shape[:-1], n).contiguous()
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render_rays(field: Field, w, rays_o, rays_d, r: dict, gen=None):
    """Coarse and fine pass of rays (N, 3) under render settings ``r``;
    with ``gen`` the training draws (jitter, fine ``u``). Returns
    (rgb, acc, rgb_coarse, acc_coarse)."""
    n, S, I = rays_o.shape[0], r["N_samples"], r["N_importance"]
    u = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    t = (r["near"] * (1.0 - u) + r["far"] * u).expand(n, S)
    if gen is not None:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], -1)
        lower = torch.cat([t[..., :1], mids], -1)
        t = lower + (upper - lower) * torch.rand(
            (n, S), generator=gen, device=rays_o.device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = viewdirs[:, None]
    raw = field(w, rays_o[:, None] + rays_d[:, None] * t[..., None], dirs,
                "coarse")
    wc = weights_of(raw[..., 3], t, r["finite_tail"])
    rgb_c, acc_c, _ = composite(raw, wc, t)
    bins = 0.5 * (t[..., 1:] + t[..., :-1])
    uf = (None if gen is None else
          torch.rand((n, I), generator=gen, device=rays_o.device))
    tf = sample_pdf(bins, wc[..., 1:-1].detach(), I, uf)
    t_all = torch.sort(torch.cat([t, tf], -1), -1).values
    raw_f = field(w, rays_o[:, None] + rays_d[:, None] * t_all[..., None],
                  dirs, "fine")
    wf = weights_of(raw_f[..., 3], t_all, r["finite_tail"])
    rgb_f, acc_f, _ = composite(raw_f, wf, t_all)
    return rgb_f, acc_f, rgb_c, acc_c


# -- training ----------------------------------------------------------------

def train_batch(data: dict, gen, step: int, r: dict, random_bkgd: bool):
    """One step's rays from the views ``data`` (uint8 ``images`` (V, H, W,
    3) and ``alphas`` (V, H, W) on the device, ``poses`` (V, 4, 4), ``K``
    (3, 3)): one image, ``N_rays`` pixels of it (the centre crop of
    ``precrop_frac`` of each side before ``precrop_iters`` steps), then
    (random_bkgd) each ray's background colour. Returns rays_o, rays_d,
    the target colours and the backgrounds (or None)."""
    images, poses, K = data["images"], data["poses"], data["K"]
    dev = images.device
    n_img, H, W = images.shape[:3]
    n = r["N_rays"]
    if step < r["precrop_iters"]:
        dW = int(W // 2 * r["precrop_frac"])
        dH = int(H // 2 * r["precrop_frac"])
        u_lo, u_hi, v_lo, v_hi = W // 2 - dW, W // 2 + dW, H // 2 - dH, \
            H // 2 + dH
    else:
        u_lo, u_hi, v_lo, v_hi = 0, W, 0, H
    img = torch.randint(0, n_img, (), generator=gen, device=dev)
    u = torch.randint(u_lo, u_hi, (n,), generator=gen, device=dev)
    v = torch.randint(v_lo, v_hi, (n,), generator=gen, device=dev)
    colors = images[img, v, u].float() / 255.0
    focal, cx, cy = float(K[0, 0]), float(K[0, 2]), float(K[1, 2])
    dirs = torch.stack([(u.float() - cx) / focal, -(v.float() - cy) / focal,
                        -torch.ones(n, device=dev)], -1)
    pose = poses[img]
    rays_d = (dirs[:, None, :] * pose[:3, :3]).sum(-1)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    bg = None
    if random_bkgd:
        alpha = (data["alphas"][img, v, u].float() / 255.0)[:, None]
        bg = torch.rand((n, 3), generator=gen, device=dev)
        colors = (colors - (1.0 - alpha)) + bg * (1.0 - alpha)
    return rays_o, rays_d, colors, bg


def loss_of(field, w, batch, r: dict, gen):
    """The fine and the coarse image's mean squared error, each
    re-composited onto the ray's random background where there is one."""
    rays_o, rays_d, colors, bg = batch
    rgb_f, acc_f, rgb_c, acc_c = render_rays(field, w, rays_o, rays_d, r,
                                             gen)
    if bg is not None:
        rgb_f = rgb_f + (bg - 1.0) * (1.0 - acc_f[..., None])
        rgb_c = rgb_c + (bg - 1.0) * (1.0 - acc_c[..., None])
    return ((rgb_f - colors) ** 2).mean() + ((rgb_c - colors) ** 2).mean()


def lr_at(train: dict, step: int) -> float:
    """The learning rate of global step ``step`` (from 0): ``lr`` decayed
    by ``lr_gamma`` over every ``lr_decay_epochs`` whole epochs of
    ``ep_iter`` steps."""
    decay = (step // train["ep_iter"]) / train["lr_decay_epochs"]
    return train["lr"] * train["lr_gamma"] ** decay


class Adam:
    """Adam with optax's float32 bias corrections and the learning rate of
    :func:`lr_at`, after clipping every gradient value to [-clip, clip];
    from zero moments at step 0, or from a run's moments ``m``, ``v`` after
    ``t`` steps."""

    def __init__(self, params: dict, train: dict, m=None, v=None, t=0,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.train, self.clip = train, train["clip"]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: (torch.zeros_like(p) if m is None else m[k].clone())
                  for k, p in params.items()}
        self.v = {k: (torch.zeros_like(p) if v is None else v[k].clone())
                  for k, p in params.items()}
        self.t = int(t)

    @staticmethod
    def _correction(b: float, t: int) -> float:
        f32 = np.float32
        return float(f32(1) - f32(float(f32(b)) ** t))

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        lr = lr_at(self.train, self.t)
        self.t += 1
        bc1 = self._correction(self.b1, self.t)
        bc2 = self._correction(self.b2, self.t)
        for k, p in params.items():
            g = grads[k].clamp(-self.clip, self.clip)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[k] / bc1)
                   / ((self.v[k] / bc2).sqrt() + self.eps))


def train_steps(field: Field, w: dict, data: dict, r: dict, train: dict,
                seed: int, epochs, state: dict | None = None) -> dict:
    """Training from weights ``w`` over ``epochs``, (epoch, steps) pairs:
    each epoch draws all its steps from one generator seeded
    ``epoch_seed(seed, epoch)``, and the global step (which sets the
    centre crop and the learning rate) counts on from Adam's ``state``
    ({m, v, t}: a run's moments after ``t`` steps) or from 0. Returns the
    step ``losses``, the ``first`` step's gradients (clipped, as the
    optimizer takes them), the ``weights`` after the last step and Adam's
    ``state`` then."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w.items()}
    state = state or {}
    opt = Adam(params, train, state.get("m"), state.get("v"),
               state.get("t", 0))
    r = {**r, **train}
    dev = data["images"].device
    losses, first = [], None
    for epoch, n_steps in epochs:
        gen = torch.Generator(device=dev).manual_seed(epoch_seed(seed, epoch))
        for _ in range(n_steps):
            batch = train_batch(data, gen, opt.t, r, train["random_bkgd"])
            loss = loss_of(field, params, batch, r, gen)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            if first is None:
                first = {k: g.clamp(-train["clip"], train["clip"])
                         for k, g in grads.items()}
            opt.step(params, grads)
            losses.append(loss.item())
    return {"losses": losses, "first": first,
            "weights": {k: v.detach() for k, v in params.items()},
            "state": {"m": opt.m, "v": opt.v, "t": opt.t}}


# -- frames ----------------------------------------------------------------

def pixel_dirs(H: int, W: int, focal: float, device) -> torch.Tensor:
    """Camera-space directions (H*W, 3) through the pixel corners, row
    after row (the camera looks along -z)."""
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([(u - W / 2.0) / focal, -(v - H / 2.0) / focal,
                        -torch.ones_like(u)], -1).reshape(-1, 3)


def frame_rays(pose: torch.Tensor, dirs: torch.Tensor):
    """World rays of a camera-to-world ``pose`` (4, 4): unit directions."""
    d = (dirs[:, None, :] * pose[:3, :3]).sum(-1)
    d = d / torch.linalg.norm(d.double(), dim=-1, keepdim=True).float()
    return pose[:3, 3].expand(d.shape), d


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


@torch.no_grad()
def dense_frame(field: Field, w, pose, H, W, focal, r: dict,
                chunk: int = 20000) -> torch.Tensor:
    """A whole frame (H*W, 3) uint8 rendered densely, ``chunk`` rays at a
    time."""
    ro, rd = frame_rays(pose, pixel_dirs(H, W, focal, pose.device))
    out = [render_rays(field, w, ro[i:i + chunk], rd[i:i + chunk], r)[0]
           for i in range(0, ro.shape[0], chunk)]
    return to_uint8(torch.cat(out))
