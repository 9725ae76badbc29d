"""Deformation-field (D-NeRF style) encoders, the counterpart of
nerf_replication_tpu/models/encoding/dnerf.py.

* ``dnerf``: the frequency-encoded (xyz, t) through a ``depth`` x ``width``
  MLP with the encoding re-concatenated as ``[enc, h]`` after each layer
  in ``skips``, predicting a delta; frames t >= 0 move by it (t = -1 is the
  canonical frame), then the frequency encoding of the moved points. Time
  is encoded with ``freq`` bands, as in the JAX module (its ``time_freq``
  is unused), and divided by num_frames - 1. The points are not
  normalised.
* the grid variants (any name containing ``ngp`` or ``tensorf``): a 3-D
  vertex-exact hash grid of the points moved by a CP-factored spacetime
  tensor delta (three parameters ``st_feat_{i}`` of shape (3, F, frames,
  reso), one per output axis: the product over the axes of bilinear
  samples at (t / (num_frames - 1), coordinate), summed over F); frames
  t > 0 move, clipped to [0,1].
"""

from __future__ import annotations

import torch
from torch import nn

from ..flax_init import dense
from .freq import freq_encode
from .hashgrid import (
    HashGridEncoder,
    _cfg_bounds,
    _normalize,
    _register_box,
    frame_time,
    grid_kw,
)


def sample_plane(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (align_corners) of ``plane`` (F, T, R) at u in
    [0,1] along T and v in [0,1] along R -> (N, F); the cell corners are
    clipped to the plane."""
    T, R = plane.shape[-2:]
    pu, pv = u * (T - 1), v * (R - 1)
    u0 = torch.floor(pu).long().clamp(0, T - 1)
    v0 = torch.floor(pv).long().clamp(0, R - 1)
    u1, v1 = (u0 + 1).clamp(0, T - 1), (v0 + 1).clamp(0, R - 1)
    fu, fv = (pu - u0)[..., None], (pv - v0)[..., None]

    def g(a, b):
        return plane[:, a, b].T

    return ((1 - fu) * (1 - fv) * g(u0, v0) + (1 - fu) * fv * g(u0, v1)
            + fu * (1 - fv) * g(u1, v0) + fu * fv * g(u1, v1))


class DNeRFEncoder(nn.Module):
    """The ``variant`` of the D-NeRF family; input (..., 4) = (xyz, t)."""

    def __init__(self, variant: str = "dnerf", freq: int = 10,
                 width: int = 256, depth: int = 8, skips=(4,),
                 num_frames: int = 2, bounds=(), grid_kw: dict | None = None,
                 tensor_feat: int = 64, tensor_reso: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.variant, self.freq, self.skips = variant, freq, tuple(skips)
        self.num_frames, self.bounds = num_frames, tuple(bounds)
        self.grid_kw = grid_kw
        _register_box(self, self.bounds)
        if grid_kw is not None:
            self.grid = HashGridEncoder(**grid_kw, generator=generator)
            self.output_dim = self.grid.output_dim
            for i in range(3):
                value = torch.empty(3, tensor_feat, num_frames, tensor_reso)
                value.normal_(generator=generator)
                setattr(self, f"st_feat_{i}", nn.Parameter(0.1 * value))
            return
        enc_dim = 4 * (1 + 2 * freq)
        dims = [enc_dim] + [width + (enc_dim if i in self.skips else 0)
                            for i in range(depth)]
        self.time_mlp = nn.ModuleList(dense(dims[i], width, generator)
                                      for i in range(depth))
        self.time_out = dense(dims[-1], 3, generator)
        self.output_dim = 3 * (1 + 2 * freq)

    @classmethod
    def from_cfg(cls, enc_cfg, variant: str = "dnerf",
                 generator: torch.Generator | None = None):
        g = enc_cfg.get
        grid = (grid_kw(enc_cfg) if "ngp" in variant or "tensorf" in variant
                else None)
        return cls(variant=variant, freq=int(g("freq", 10)),
                   width=int(g("W", 256)), depth=int(g("D", 8)),
                   num_frames=int(g("num_frames", 2)),
                   bounds=_cfg_bounds(enc_cfg), grid_kw=grid,
                   generator=generator)

    def _mlp_delta(self, xyz, t):
        enc = torch.cat([freq_encode(xyz, self.freq),
                         freq_encode(t, self.freq)], dim=-1)
        h = enc
        for i, layer in enumerate(self.time_mlp):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([enc, h], dim=-1)
        return self.time_out(h)

    def _tensor_delta(self, xyz, t):
        """delta[..., i] = sum_f prod_axis bilerp(st_feat_i[axis],
        (t, coordinate_axis))."""
        tt = frame_time(t[..., 0], self.num_frames - 1)
        deltas = []
        for i in range(3):
            st = getattr(self, f"st_feat_{i}")
            prod = None
            for axis in range(3):
                feat = sample_plane(st[axis], tt, xyz[..., axis])
                prod = feat if prod is None else prod * feat
            deltas.append(prod.sum(-1))
        return torch.stack(deltas, dim=-1)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz, t = xyzt[..., :3], xyzt[..., 3:]
        if self.grid_kw is not None:
            xyz = _normalize(self, xyz)
            warped = torch.clamp(xyz + self._tensor_delta(xyz, t), 0.0, 1.0)
            return self.grid(torch.where(t > 0, warped, xyz),
                             normalize=False)
        delta = self._mlp_delta(xyz, frame_time(t, self.num_frames - 1))
        return freq_encode(torch.where(t >= 0, xyz + delta, xyz), self.freq)
