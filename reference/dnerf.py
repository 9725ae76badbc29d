"""D-NeRF in plain float32 PyTorch: the reference the port's D-NeRF
(``nerf_replication_tpu_torch.models.nerf.dnerf_network``) is held to.

Pumarola et al., "D-NeRF: Neural Radiance Fields for Dynamic Scenes",
CVPR 2021, arXiv:2011.13961, sec. 4 and the implementation details of
sec. 5; the code's ``DirectTemporalNeRF`` (github.com/albertpumarola/D-NeRF,
``run_dnerf.py``). Per sample point x at time t with view direction d:

* deformation Psi_t: ``dx = Psi_t(gamma(x) | gamma(t))``, ``D_t`` ReLU
  layers of ``W_t`` with gamma(x) alone re-joined as ``[gamma(x), h]``
  after each layer in ``skips_t``, then a linear 3-wide head; ``dx = 0``
  where t = 0 (the canonical frame, the paper's Eq. 1);
* canonical Psi_x: the NeRF paper's MLP on ``gamma(x + dx)``: ``D`` ReLU
  layers of ``W`` with ``[gamma(x + dx), h]`` after each layer in
  ``skips``, the density from the last trunk layer, a linear feature
  layer joined with gamma(d), one ReLU view layer of ``W / 2``, rgb;
* gamma(p) = [p, sin(2^0 p), cos(2^0 p), ..., sin(2^(L-1) p), cos(...)].

Rendering is the hierarchical one of NeRF, both passes through the one
model (``use_two_models_for_fine`` off): stratified coarse depths,
inverse-CDF fine depths from the coarse weights (their gradient stopped),
the sorted union, alpha compositing; the loss is the fine and the coarse
image's mean squared error. Every tensor is float32 and every product a
float32 product: run with ``torch.backends.cuda.matmul.allow_tf32`` False
(:func:`no_tf32`). No kernels, no batching of the model, no cache; this
file imports nothing of the port.

Departures from the paper and its code, each one the measured program's:

* density through softplus where the code has ReLU (a ReLU field under a
  white background can collapse to zero density everywhere);
* the NeRF package's conventions: white background, the 1e10 far
  interval, +1e-10 in the transmittance product, ``weights + 1e-5`` in the
  inverse CDF, unit view directions;
* Adam's bias corrections in float32 (optax's), after clipping every
  gradient value to [-40, 40] (:func:`adam_step`);
* the weights are a dict under the port's names: ``deform.pts.{i}``,
  ``deform.out``, ``canonical.pts.{i}``, ``canonical.alpha``,
  ``canonical.feature``, ``canonical.views.0``, ``canonical.rgb``, each
  ``.weight`` (out, in) and ``.bias``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Float32 products stay float32 on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def freq_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    feats = [x]
    for i in range(n_freqs):
        feats += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(feats, dim=-1)


def _dense(w: dict, name: str, h: torch.Tensor) -> torch.Tensor:
    return F.linear(h, w[f"{name}.weight"], w[f"{name}.bias"])


def deform(w: dict, m: dict, x: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """Psi_t: points (N, 3) at times (N,) -> dx (N, 3), 0 where t = 0.
    ``m`` holds ``xyz_freqs``, ``time_freqs``, ``D_t``, ``skips_t``."""
    gx = freq_encode(x, m["xyz_freqs"])
    h = torch.cat([gx, freq_encode(t[:, None], m["time_freqs"])], dim=-1)
    for i in range(m["D_t"]):
        h = torch.relu(_dense(w, f"deform.pts.{i}", h))
        if i in m["skips_t"]:
            h = torch.cat([gx, h], dim=-1)
    dx = _dense(w, "deform.out", h)
    return torch.where(t[:, None] == 0.0, torch.zeros_like(dx), dx)


def canonical(w: dict, m: dict, x: torch.Tensor,
              d: torch.Tensor) -> torch.Tensor:
    """Psi_x: canonical points (N, 3), unit directions (N, 3) -> raw
    ``[rgb, sigma]`` (N, 4). ``m`` holds ``xyz_freqs``, ``dir_freqs``,
    ``D``, ``skips``."""
    gx = freq_encode(x, m["xyz_freqs"])
    h = gx
    for i in range(m["D"]):
        h = torch.relu(_dense(w, f"canonical.pts.{i}", h))
        if i in m["skips"]:
            h = torch.cat([gx, h], dim=-1)
    sigma = _dense(w, "canonical.alpha", h)
    h = torch.cat([_dense(w, "canonical.feature", h),
                   freq_encode(d, m["dir_freqs"])], dim=-1)
    h = torch.relu(_dense(w, "canonical.views.0", h))
    return torch.cat([_dense(w, "canonical.rgb", h), sigma], dim=-1)


def field(w: dict, m: dict, pts: torch.Tensor, dirs: torch.Tensor,
          t: torch.Tensor) -> torch.Tensor:
    """Raw outputs (..., 4) at points (..., 3) with directions and times
    broadcastable to them."""
    shape = pts.shape[:-1]
    x = pts.reshape(-1, 3)
    d = dirs.expand(*shape, 3).reshape(-1, 3)
    tt = t.expand(shape).reshape(-1)
    return canonical(w, m, x + deform(w, m, x, tt), d).reshape(*shape, 4)


def weights_of(sigma: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Compositing weights from raw densities (softplus) at depths z."""
    delta = z[..., 1:] - z[..., :-1]
    delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(raw: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """rgb on a white background."""
    rgb = (wts[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    return rgb + (1.0 - wts.sum(-1)[..., None])


def sample_pdf(bins, weights, n: int, u=None) -> torch.Tensor:
    """Inverse-CDF depths of each row's piecewise-constant pdf over
    ``bins`` (..., B+1), ``weights`` (..., B) + 1e-5, at ``u`` (..., n) or
    at ``linspace(0, 1, n)``."""
    wt = weights + 1e-5
    cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
            *cdf.shape[:-1], n).contiguous()
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render_rays(w: dict, m: dict, r: dict, rays_o, rays_d, times,
                jitter=None, u_fine=None) -> dict:
    """Both passes of rays (N, 3) at times (N,) under render settings
    ``r`` (``N_samples``, ``N_importance``, ``near``, ``far``); ``jitter``
    (N, N_samples) and ``u_fine`` (N, N_importance) are the training
    draws (None: the eval depths). Returns the raw outputs and rgb of the
    coarse and the fine pass."""
    n, S, I = rays_o.shape[0], r["N_samples"], r["N_importance"]
    u = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    z = (r["near"] * (1.0 - u) + r["far"] * u).expand(n, S)
    if jitter is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * jitter
    dirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True))[:, None]
    t = times.reshape(-1, 1)
    raw_c = field(w, m, rays_o[:, None] + rays_d[:, None] * z[..., None],
                  dirs, t)
    wc = weights_of(raw_c[..., 3], z)
    bins = 0.5 * (z[..., 1:] + z[..., :-1])
    zf = sample_pdf(bins, wc[..., 1:-1].detach(), I, u_fine)
    z_all = torch.sort(torch.cat([z, zf], -1), -1).values
    raw_f = field(w, m, rays_o[:, None] + rays_d[:, None] * z_all[..., None],
                  dirs, t)
    return {"raw_coarse": raw_c, "raw": raw_f,
            "rgb_coarse": composite(raw_c, wc),
            "rgb": composite(raw_f, weights_of(raw_f[..., 3], z_all))}


def loss_of(w: dict, m: dict, r: dict, batch: dict, jitter=None,
            u_fine=None):
    """(fine MSE + coarse MSE, the render's outputs) of a batch of
    ``rays_o``, ``rays_d``, ``times``, ``colors``."""
    out = render_rays(w, m, r, batch["rays_o"], batch["rays_d"],
                      batch["times"], jitter, u_fine)
    c = batch["colors"]
    return (((out["rgb"] - c) ** 2).mean()
            + ((out["rgb_coarse"] - c) ** 2).mean()), out


def adam_step(w: dict, grads: dict, state: dict, lr: float,
              clip: float = 40.0, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> dict:
    """One Adam update after clipping each gradient value to [-clip,
    clip], with optax's float32 bias corrections. ``state`` holds ``m``,
    ``v`` (dicts) and ``t`` (updates so far); returns the new weights and
    updates ``state``."""
    t = state.get("t", 0) + 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(float(f32(b1)) ** t))
    bc2 = float(f32(1) - f32(float(f32(b2)) ** t))
    out = {}
    for k, p in w.items():
        g = grads[k].clamp(-clip, clip)
        m = state.setdefault("m", {}).get(k, torch.zeros_like(p))
        v = state.setdefault("v", {}).get(k, torch.zeros_like(p))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state["m"][k], state["v"][k] = m, v
        out[k] = p - lr * (m / bc1) / ((v / bc2).sqrt() + eps)
    state["t"] = t
    return out
