"""Volume-rendering ray ops in PyTorch.

The counterparts of nerf_replication_tpu/ops/ray_ops.py:28-245, with the
same conventions and numerics in float32: :func:`get_rays`,
:func:`stratified_sample`, :func:`density_activation`,
:func:`compute_weights` (1e10 far tail or ``finite_tail``, +1e-10 in the
transmittance product), :func:`sample_pdf`, :func:`composite` and
:func:`ray_aabb_intersect`.

Every random draw of a training batch goes through :func:`draw`, so that a
data-parallel rank, whose generator is a ``parallel.mesh.RowGenerator``,
draws at the global batch's shape and keeps its own rays' values; with a
``torch.Generator`` a draw is what it was.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draw(sample, shape, generator) -> torch.Tensor:
    """``sample(shape, generator)``: a random draw of ``shape`` (rays first)
    from a ``torch.Generator`` (or None: the default one), or, from a
    data-parallel rank's ``parallel.mesh.RowGenerator``, this rank's rows
    of the draw at the global batch's shape."""
    if generator is None or isinstance(generator, torch.Generator):
        return sample(tuple(shape), generator)
    return generator.draw(sample, tuple(shape))


def local_rows(generator, n: int) -> int:
    """The rows of an ``n``-ray batch that ``generator`` draws for: ``n``,
    or a data-parallel rank's share of a global batch of ``n``."""
    if generator is None or isinstance(generator, torch.Generator):
        return n
    if generator.total != n:
        raise ValueError(f"a rank's generator for a batch of "
                         f"{generator.total} rays, not {n}")
    return generator.rows


def get_rays(uv: torch.Tensor, K_inv: torch.Tensor, c2w: torch.Tensor):
    """World-space rays through pixel coordinates ``uv`` (..., 2) with
    inverse intrinsics ``K_inv`` (3, 3) and an OpenGL camera-to-world
    ``c2w`` (3|4, 4) (the camera looks along -z). Returns
    ``(rays_o, rays_d)``, each (..., 3), with unit directions."""
    x, y = uv[..., 0], uv[..., 1]
    ones = torch.ones_like(x)
    cam = torch.stack([x, y, ones], dim=-1) @ K_inv.T
    dirs = torch.stack([cam[..., 0], -cam[..., 1], -ones], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def stratified_sample(n_rays: int, n_samples: int, near: float, far: float,
                      generator: torch.Generator | None = None,
                      lindisp: bool = False,
                      device: torch.device | str | None = None) -> torch.Tensor:
    """Coarse depths (n_rays, n_samples): the bin edges of
    ``linspace(near, far)`` (or linear in disparity) for eval; with a
    ``generator``, each sample is jittered uniformly within its stratum
    (the train form)."""
    u = torch.linspace(0.0, 1.0, n_samples, device=device)
    if lindisp:
        t = 1.0 / (1.0 / near * (1.0 - u) + 1.0 / far * u)
    else:
        t = near * (1.0 - u) + far * u
    t = t.expand(n_rays, n_samples)
    if generator is not None:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], dim=-1)
        lower = torch.cat([t[..., :1], mids], dim=-1)
        r = draw(lambda sh, g: torch.rand(sh, generator=g, device=device),
                 t.shape, generator)
        t = lower + (upper - lower) * r
    return t


def density_activation(name: str):
    """'relu' (the reference) or 'softplus' (strictly positive). Other
    names raise, where the JAX package would fall back to relu."""
    if name == "softplus":
        return F.softplus
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown density activation {name!r}")


def compute_weights(sigma: torch.Tensor, t: torch.Tensor,
                    activation=torch.relu, finite_tail: bool = False,
                    raw_noise_std: float = 0.0,
                    generator: torch.Generator | None = None):
    """Compositing weights from raw densities ``sigma`` (..., S) at depths
    ``t`` (..., S). The last interval is 1e10 long, or as long as the one
    before it with ``finite_tail``. With ``raw_noise_std`` > 0 and a
    ``generator`` (training), Gaussian noise of that std is added to the
    raw densities. Returns ``(weights, alpha, trans)`` with the exclusive
    transmittance T_i = prod_{j<i}(1 - alpha_j + eps)."""
    delta = t[..., 1:] - t[..., :-1]
    tail = (delta[..., -1:] if finite_tail
            else torch.full_like(delta[..., :1], 1e10))
    delta = torch.cat([delta, tail], dim=-1)
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + raw_noise_std * draw(
            lambda sh, g: torch.randn(sh, generator=g, device=sigma.device),
            sigma.shape, generator)
    alpha = 1.0 - torch.exp(-activation(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans, alpha, trans


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_importance: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_importance`` depths per ray: at
    ``u = linspace(0, 1)`` (eval), or at uniform ``u`` drawn from
    ``generator`` (training); ``bins`` (..., B+1) are edges, ``weights``
    (..., B) their weights. Unsorted.

    Ties and tails as the JAX masked-reduction form (ray_ops.py:181-210):
    the segment is [last cdf entry <= u, first entry > u], so repeated
    cdf values pick the last of the repeats, and u at or past the final
    cdf entry lands on the last edge.
    """
    eps = 1e-5
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = (*cdf.shape[:-1], n_importance)
    if generator is not None:
        u = draw(lambda sh, g: torch.rand(sh, generator=g, device=cdf.device),
                 shape, generator)
    else:
        u = torch.linspace(0.0, 1.0, n_importance, device=cdf.device)
        u = u.expand(shape).contiguous()

    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bin_below, bin_above = bins.gather(-1, below), bins.gather(-1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return bin_below + frac * (bin_above - bin_below)


def composite(rgb: torch.Tensor, weights: torch.Tensor, t: torch.Tensor,
              white_bkgd: bool = False):
    """Per-ray ``rgb = sum(w c)``, ``depth = sum(w t)``, ``acc = sum(w)``;
    a white background adds ``1 - acc``."""
    rgb_map = (weights[..., None] * rgb).sum(dim=-2)
    depth_map = (weights * t).sum(dim=-1)
    acc_map = weights.sum(dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map


def ray_aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor, bbox_min,
                       bbox_max, near_default: float, far_default: float):
    """Slab test of rays (N, 3) against the box [bbox_min, bbox_max]:
    ``(near, far, hit)``, each (N,). A ray that misses (or whose box lies
    behind it) gets ``near_default`` / ``far_default``; a hit starts at
    depth 0 at the earliest."""
    lo = torch.as_tensor(bbox_min, dtype=rays_o.dtype, device=rays_o.device)
    hi = torch.as_tensor(bbox_max, dtype=rays_o.dtype, device=rays_o.device)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-10, 1e-10, rays_d)
    t0 = (lo - rays_o) * inv_d
    t1 = (hi - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    start = torch.clamp(tmin, min=0.0)
    hit = tmax > start
    near = torch.where(hit, start, near_default)
    far = torch.where(hit, tmax, far_default)
    return near, far, hit
