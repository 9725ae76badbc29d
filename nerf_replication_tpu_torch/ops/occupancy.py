"""Occupancy grid for empty-space skipping, the counterpart of
nerf_replication_tpu/ops/occupancy.py.

* :func:`build_occupancy_grid` queries a trained field's activated density
  at the centres of an R^3 lattice (in chunks), thresholds it and dilates
  the result (:func:`_dilate`), so that thin structures across cell faces
  stay covered.
* :func:`ray_spans`, :func:`points_occupied` and :func:`rays_active` look
  points and ray probes up in a grid: a uint8 gather a sample, no MLP.

The lattice centres are computed in numpy float32 exactly as the JAX
package computes them, and every lookup takes the float32 steps that the
JAX package's compiled lookup takes, so that the same density gives the
same grid and the same rays the same cells. XLA turns a division by a
compile-time constant into a product by the constant's float32
reciprocal, so a point's position in the box is ``(p - lo) * (1 / (hi -
lo))`` here, not a quotient. Everything but the lattice runs on the device
of its tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_points(resolution: int, bbox) -> np.ndarray:
    """The R^3 cell centres of ``bbox`` (lo xyz, hi xyz), (R^3, 3) float32
    in ``ij`` order, as the JAX package computes them."""
    lo = np.asarray(bbox[:3], np.float32)
    hi = np.asarray(bbox[3:], np.float32)
    centers = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    return np.stack(np.meshgrid(
        lo[0] + centers * (hi[0] - lo[0]),
        lo[1] + centers * (hi[1] - lo[1]),
        lo[2] + centers * (hi[2] - lo[2]), indexing="ij"), -1).reshape(-1, 3)


@torch.inference_mode()
def build_occupancy_grid(density_fn, resolution: int = 64,
                         bbox=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
                         threshold: float = 0.01, dilate: int = 2,
                         chunk: int = 65536, device="cpu"):
    """Returns (grid uint8 (R, R, R) on ``device``, bbox tuple).

    ``density_fn(pts (N, 3)) -> activated sigma (N,)``, called on
    ``chunk`` points at a time. ``threshold`` is in density units: the
    alpha of one cell is about 1 - exp(-sigma * cell).
    """
    pts = torch.from_numpy(grid_points(resolution, bbox)).to(device)
    thr = torch.full((), threshold, dtype=torch.float32, device=device)
    occ = torch.cat([density_fn(pts[i:i + chunk]) > thr
                     for i in range(0, pts.shape[0], chunk)])
    grid = occ.to(torch.uint8).reshape(resolution, resolution, resolution)
    if dilate > 0:
        grid = _dilate(grid, dilate)
    lo_hi = np.concatenate([np.asarray(bbox[:3], np.float32),
                            np.asarray(bbox[3:], np.float32)])
    return grid, tuple(lo_hi.tolist())


def _dilate(grid: torch.Tensor, k: int) -> torch.Tensor:
    """Max-pool dilation by ``k`` cells along each axis, as the JAX
    package does it: the roll wraps, and only the low border (the first
    ``s`` planes) is reset afterwards, so the high border keeps what
    wrapped in from the low side. The grid is the reference's, quirk
    included."""
    out = grid.clone()
    for axis in range(3):
        acc = out.clone()
        for s in range(1, k + 1):
            acc = torch.maximum(acc, torch.roll(out, s, dims=axis))
            acc = torch.maximum(acc, torch.roll(out, -s, dims=axis))
            sl = [slice(None)] * 3
            sl[axis] = slice(0, s)
            acc[tuple(sl)] = torch.maximum(grid, out)[tuple(sl)]
        out = acc
    return out


def box_scale(bbox, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bbox's lo corner and the float32 reciprocal of its extent, on
    ``device``. A caller that looks points up inside a frame makes these
    once and passes them as ``scale``: a copy to the device inside a frame
    waits for the host."""
    lo = np.asarray(bbox[:3], np.float32)
    inv = np.float32(1.0) / (np.asarray(bbox[3:], np.float32) - lo)
    return torch.from_numpy(lo).to(device), torch.from_numpy(inv).to(device)


def points_occupied(pts: torch.Tensor, grid: torch.Tensor, bbox,
                    scale=None) -> torch.Tensor:
    """(..., 3) world points -> (...) bool occupancy; points outside the
    bbox are unoccupied. ``scale`` is :func:`box_scale` of ``bbox`` on the
    points' device, made here when not given."""
    lo, inv = scale if scale is not None else box_scale(bbox, pts.device)
    r = grid.shape[0]
    u = (pts - lo) * inv
    inside = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    cell = torch.clamp((u * r).to(torch.int32), 0, r - 1).long()
    flat = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    occ = grid.reshape(-1).index_select(0, flat.reshape(-1))
    return (occ.reshape(flat.shape) > 0) & inside


def ray_spans(rays_o: torch.Tensor, rays_d: torch.Tensor,
              t_probe: torch.Tensor, grid: torch.Tensor, bbox,
              margin: float = 0.0, scale=None):
    """Per-ray occupied span from grid probes: ``rays_o``/``rays_d`` (N, 3)
    probed at depths ``t_probe`` (S,) float32 on their device; the span
    runs from the first to the last occupied probe, widened by ``margin``
    on each side and clipped to the probes' range. ``scale`` as for
    :func:`points_occupied`.

    Returns (active (N,), t_enter (N,), t_exit (N,)); inactive rays get
    the full [t_probe[0], t_probe[-1]] span.
    """
    t = t_probe
    pts = rays_o[:, None] + rays_d[:, None] * t[None, :, None]   # (N, S, 3)
    hit = points_occupied(pts, grid, bbox, scale)                 # (N, S)
    active = hit.any(dim=-1)
    t_lo, t_hi = t[0], t[-1]
    big = torch.full((), 1e10, dtype=torch.float32, device=t.device)
    t_enter = torch.where(hit, t[None, :], big).amin(dim=-1)
    t_exit = torch.where(hit, t[None, :], -big).amax(dim=-1)
    t_enter = torch.clamp(t_enter - margin, t_lo, t_hi)
    t_exit = torch.clamp(t_exit + margin, t_lo, t_hi)
    t_enter = torch.where(active, t_enter, t_lo)
    t_exit = torch.where(active, t_exit, t_hi)
    return active, t_enter, t_exit


def rays_active(rays_o: torch.Tensor, rays_d: torch.Tensor, t_probe,
                grid: torch.Tensor, bbox, scale=None) -> torch.Tensor:
    """Probe occupancy along each ray at depths ``t_probe`` ((S,) or
    (N, S)): active (N,) bool, any probe in an occupied cell. ``scale`` as
    for :func:`points_occupied`."""
    t = torch.as_tensor(t_probe, dtype=torch.float32, device=rays_o.device)
    t = t.expand(rays_o.shape[0], t.shape[-1])
    pts = rays_o[:, None] + rays_d[:, None] * t[..., None]      # (N, S, 3)
    return points_occupied(pts, grid, bbox, scale).any(dim=-1)
