"""Multi-resolution hash-grid encoder, brick backend, as an ``nn.Module``.

The counterpart of ``HashGridEncoder(backend="brick")`` in
nerf_replication_tpu/models/encoding/hashgrid.py: the table is one
``nn.Parameter`` of shape (n_rows, 256) in the layout of
ops/hashgrid_kernel.py, so a JAX checkpoint's ``params/xyz_encoder/table``
loads into it as it is. The forward is the training encode with its table
gradient (``ops.hashgrid_kernel.BrickHashEncodeFn``: the CUDA kernels on a
CUDA tensor, their plain versions on a CPU tensor; bf16 table reads and
bf16 gradient contributions on levels of at most 4096 rows, f32 above; no
gradient to the points). The eval path reaches the packed-table kernels
through models/nerf/renderer/ngp_renderer.py instead.

Not ported yet: ``backend="xla"`` (the vertex-exact formulation) and the
composite encoders, ROADMAP.md items A.10 and A.12.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import as_bool
from ...ops import hashgrid_kernel as hk

EPS = 1e-6


def normalize_to_unit(x: torch.Tensor, bounds) -> torch.Tensor:
    """Clamp to ``bounds`` (lo..., hi...) and scale into [0,1]^D by the
    largest side, in float32 as the JAX package does."""
    d = x.shape[-1]
    lo = torch.tensor(bounds[:d], dtype=x.dtype, device=x.device)
    hi = torch.tensor(bounds[d:], dtype=x.dtype, device=x.device)
    return _into_box(x, lo, hi, (hi - lo).max() + EPS)


def _into_box(x, lo, hi, side):
    x = torch.minimum(torch.maximum(x, lo), hi)
    return (x - lo) / side


class HashGridEncoder(nn.Module):
    """3-D bricked hash grid with 2 features a level; ``output_dim`` is
    2 x levels. Points are world-space when ``bounds`` is set."""

    def __init__(self, n_levels: int = 16, base_resolution: int = 16,
                 finest_resolution: int = -1, per_level_scale: float = 2.0,
                 log2_bricks: int = 12, bounds=(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_levels = n_levels
        self.base_resolution = base_resolution
        self.finest_resolution = finest_resolution
        self.per_level_scale = per_level_scale
        self.log2_bricks = log2_bricks
        self.bounds = tuple(bounds)
        if self.bounds:
            # the corners as buffers: they move with the module, so no
            # call copies them to the device (a copy would wait for the
            # host inside a frame)
            lo = torch.tensor(self.bounds[:3], dtype=torch.float32)
            hi = torch.tensor(self.bounds[3:], dtype=torch.float32)
            self.register_buffer("box_lo", lo, persistent=False)
            self.register_buffer("box_hi", hi, persistent=False)
            self.register_buffer("box_side", (hi - lo).max() + EPS,
                                 persistent=False)
        self.layout = hk.make_brick_layout(
            n_levels, base_resolution, finest_resolution,
            log2_bricks=log2_bricks, per_level_scale=per_level_scale)
        table = torch.empty(self.layout.n_rows, hk.ROW)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)
        self.input_dim = 3
        self.output_dim = 2 * n_levels

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        """Reads the JAX package's names and the reference YAML's
        (``num_levels``, ``level_dim``, ``desired_resolution``, ``bbox``)."""
        g = enc_cfg.get
        backend = str(g("backend", "xla"))
        if backend != "brick":
            raise NotImplementedError(
                f"hash-grid backend {backend!r} is not ported yet: ROADMAP.md "
                "item A.10 (the vertex-exact xla backend)")
        shape = (g("input_dim", 3), g("n_features", g("level_dim", 2)))
        if shape != (3, 2) or as_bool(g("input_grad", False), "input_grad"):
            raise ValueError("brick backend supports input_dim=3, n_features=2, "
                             "input_grad=False")
        return cls(n_levels=int(g("n_levels", g("num_levels", 16))),
                   base_resolution=int(g("base_resolution", 16)),
                   finest_resolution=int(g("finest_resolution",
                                           g("desired_resolution", -1))),
                   per_level_scale=float(g("per_level_scale", 2.0)),
                   log2_bricks=int(g("log2_bricks", 12)),
                   bounds=tuple(g("bounds", g("bbox", ()))),
                   generator=generator)

    def to_unit(self, x: torch.Tensor) -> torch.Tensor:
        """World points (N, 3) -> [0,1]^3: normalised to the bounds when
        set, then clipped."""
        if self.bounds:
            x = _into_box(x, self.box_lo, self.box_hi, self.box_side)
        return torch.clamp(x, 0.0, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3) -> (..., 2L)."""
        shape = x.shape[:-1]
        x = self.to_unit(x.reshape(-1, 3).float()).contiguous()
        out = hk.BrickHashEncodeFn.apply(self.layout, self.table, x)
        return out.reshape(*shape, self.output_dim)
