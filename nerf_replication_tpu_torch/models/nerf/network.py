"""NeRF model (coarse + fine MLP) as ``nn.Module``s.

The counterpart of nerf_replication_tpu/models/nerf/network.py:

* :class:`NeRFMLP` — D x W trunk with the encoded input re-concatenated
  after each layer in ``skips`` as ``[x, h]`` (input first), a raw density
  head, a feature layer (no ReLU), ``view_depth`` view-conditioned layers
  of width W/2 and an RGB head. Outputs raw ``[rgb, sigma]``.
* :class:`Network` — coarse + fine MLPs and the config's encoders.

Dtype policy of network.py:47-72: float32 parameters, every matmul in
``dtype`` (``network.dtype``: bfloat16 for the frequency configs) with its
output rounded to ``dtype`` as Flax's ``Dense(dtype=bf16)`` does, float32
raw output. The NGP configs set float32: every product is then f32, and
must not run in TF32 (``torch.backends.cuda.matmul.allow_tf32`` False, as
the entry points set it). A hash-grid encoder is a submodule, so its
table is the state_dict's ``xyz_encoder.table``.
Submodule names give state_dict keys ``pts.{i}``, ``feature``, ``alpha``,
``views.{i}``, ``rgb`` for Flax's ``pts_{i}``, ..., ``views_{i}``.

Initialisation is Flax ``nn.Dense``'s: kernels ``lecun_normal`` (a normal
truncated at +-2 sigma, sigma = 1/sqrt(fan_in) / 0.87962566 so that the
truncated variance is 1/fan_in), biases zero and the ``alpha`` bias
``density_bias``, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...config import as_bool
from ...utils import tracing
from ..encoding import get_encoder
from ..flax_init import lecun_normal_


def _dense(layer: nn.Linear, h: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(h, layer.weight.to(dtype), layer.bias.to(dtype))


class NeRFMLP(nn.Module):
    """``tracing.counts["NeRFMLP.calls"]`` counts forward calls of every
    instance."""

    def __init__(self, in_dim: int, view_dim: int, depth: int = 8,
                 width: int = 256, view_depth: int = 1,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 density_bias: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth, self.width, self.view_depth = depth, width, view_depth
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.dtype = dtype
        dims = [in_dim] + [width + (in_dim if i in self.skips else 0)
                           for i in range(depth)]
        self.pts = nn.ModuleList(nn.Linear(dims[i], width)
                                 for i in range(depth))
        if use_viewdirs:
            self.alpha = nn.Linear(dims[-1], 1)
            self.feature = nn.Linear(dims[-1], width)
            self.views = nn.ModuleList(
                nn.Linear(width + view_dim if i == 0 else width // 2,
                          width // 2) for i in range(view_depth))
            self.rgb = nn.Linear(width // 2, 3)
        else:
            self.output = nn.Linear(dims[-1], 4)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)
        if use_viewdirs:
            nn.init.constant_(self.alpha.bias, density_bias)

    def forward(self, pts_feat: torch.Tensor,
                view_feat: torch.Tensor | None = None) -> torch.Tensor:
        """(N, C_pts), (N, C_dir) -> raw (N, 4) = [rgb, sigma], float32."""
        tracing.counts["NeRFMLP.calls"] += 1
        dt = self.dtype
        x = pts_feat.to(dt)
        h = x
        for i, layer in enumerate(self.pts):
            h = torch.relu_(_dense(layer, h, dt))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        if not self.use_viewdirs:
            return _dense(self.output, h, dt).float()
        sigma = _dense(self.alpha, h, dt)
        h = torch.cat([_dense(self.feature, h, dt), view_feat.to(dt)], dim=-1)
        for layer in self.views:
            h = torch.relu_(_dense(layer, h, dt))
        return torch.cat([_dense(self.rgb, h, dt), sigma], dim=-1).float()


class Network(nn.Module):
    """Coarse + fine NeRF with config-selected encoders. ``model`` picks
    the head: "" or "coarse" for coarse, "fine" for fine.
    ``tracing.counts["Network.calls"]`` counts forward calls of every
    instance: the plain MLP path's count, beside the fused kernel's
    launches."""

    def __init__(self, coarse: NeRFMLP, fine: NeRFMLP, xyz_encoder,
                 dir_encoder, use_viewdirs: bool = True):
        super().__init__()
        self.coarse, self.fine = coarse, fine
        self.xyz_encoder, self.dir_encoder = xyz_encoder, dir_encoder
        self.use_viewdirs = use_viewdirs

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor | None = None,
                model: str = "") -> torch.Tensor:
        """pts (..., 3), viewdirs broadcastable to (..., 3) -> raw (..., 4)."""
        tracing.counts["Network.calls"] += 1
        shape = pts.shape[:-1]
        pts_feat = self.xyz_encoder(pts.reshape(-1, pts.shape[-1]))
        view_feat = None
        if self.use_viewdirs and viewdirs is not None:
            dirs = viewdirs.expand(*shape, viewdirs.shape[-1])
            view_feat = self.dir_encoder(dirs.reshape(-1, dirs.shape[-1]))
        mlp = self.fine if model == "fine" else self.coarse
        return mlp(pts_feat, view_feat).reshape(*shape, 4)

    def density(self, pts: torch.Tensor, model: str = "fine") -> torch.Tensor:
        """Raw density (...) at ``pts`` (..., 3), queried with zero view
        directions (occupancy probing, mesh extraction)."""
        zero_dirs = pts.new_zeros(*pts.shape[:-1], 3)
        return self(pts, zero_dirs, model=model)[..., 3]


def make_network(cfg, generator: torch.Generator | None = None) -> Network:
    """The config's Network, initialised from ``generator`` (default: a
    CPU generator seeded with ``cfg.seed``): a hash-grid table first, then
    coarse, then fine. A top-level ``num_frames`` goes into the encoder
    sections that do not set their own, as in the JAX package (the
    reference's time-conditioned encoders read it globally)."""
    c = cfg.network
    if "num_frames" in cfg:
        for key in ("xyz_encoder", "dir_encoder"):
            enc = c.get(key)
            if enc is not None and "num_frames" not in enc:
                enc["num_frames"] = cfg.num_frames
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    use_viewdirs = as_bool(cfg.get("task_arg", {}).get("use_viewdirs", True),
                           "task_arg.use_viewdirs")
    dtype = getattr(torch, c.get("dtype", "bfloat16"))
    xyz_encoder = get_encoder(c.xyz_encoder, generator)
    dir_encoder = get_encoder(c.dir_encoder, generator)

    def mk():
        return NeRFMLP(
            in_dim=xyz_encoder.output_dim, view_dim=dir_encoder.output_dim,
            depth=c.nerf.D, width=c.nerf.W, view_depth=c.nerf.get("V_D", 1),
            skips=tuple(c.nerf.skips), use_viewdirs=use_viewdirs, dtype=dtype,
            density_bias=float(c.nerf.get("density_bias", 0.0)),
            generator=generator)

    return Network(mk(), mk(), xyz_encoder, dir_encoder, use_viewdirs)
