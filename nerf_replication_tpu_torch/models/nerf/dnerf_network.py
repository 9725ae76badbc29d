"""D-NeRF (Pumarola et al., CVPR 2021, arXiv:2011.13961, sec. 4; the
``DirectTemporalNeRF`` of github.com/albertpumarola/D-NeRF): a deformation
MLP ahead of the NeRF paper's canonical field, one model for the coarse and
the fine pass.

* :class:`DeformMLP`, Psi_t: ``dx = Psi_t(gamma(x) | gamma(t))``, ``depth``
  ReLU layers of ``width`` on the frequency encodings of the point (the
  xyz encoder's bands) and of the time (``time_freq`` bands), gamma(x)
  alone re-joined as ``[gamma(x), h]`` after each layer in ``skips``, and a
  linear 3-wide head. Frame t = 0 is the canonical one: there dx is 0 (a
  mask on t, so no host sync and no gradient into Psi_t from those rays).
* :class:`DNeRFNetwork`, Psi_x: the NeRFMLP of ``network.nerf`` on
  ``gamma(x + dx)`` and the view directions' encoding. ``coarse`` and
  ``fine`` are that one MLP (``use_two_models_for_fine`` off).

Precision: f32 parameters; Psi_t's hidden products take bf16 operands and
give bf16 outputs (f32 accumulation), as the NeRFMLP's do, and its head
takes bf16 operands into an f32 product, so dx is not rounded to bf16.

Every forward needs each point's time (``times``, broadcastable to the
points' leading shape); a D-NeRF without one raises. Under a torch
profiler Psi_t's forward is the span ``dnerf.deform`` (once per pass);
``tracing.counts["DNeRF.deform_points"]`` counts the points it moves and
``tracing.counts["DeformMLP.calls"]`` the forward calls of the
``nn.Module``. The training route of a bf16 Psi_t runs it on its own kernels
(``ops.deform_mlp``, through ``move``'s ``deform``), whose backward is the
span ``dnerf.deform_backward``; a float32 one, and every eval path, run
this ``nn.Module``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import tracing
from ..encoding.freq import freq_encode
from ..flax_init import lecun_normal_
from .network import NeRFMLP


class DeformMLP(nn.Module):
    """Psi_t: (gamma(x) (N, x_dim), gamma(t) (N, t_dim)) -> dx (N, 3) f32.
    Parameters ``pts.{i}`` and ``out``."""

    def __init__(self, x_dim: int, t_dim: int, depth: int = 8,
                 width: int = 256, skips: Sequence[int] = (4,),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.dtype = dtype
        dims = [x_dim + t_dim] + [width + (x_dim if i in self.skips else 0)
                                  for i in range(depth)]
        self.pts = nn.ModuleList(nn.Linear(dims[i], width)
                                 for i in range(depth))
        self.out = nn.Linear(dims[-1], 3)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)

    def forward(self, x_feat: torch.Tensor,
                t_feat: torch.Tensor) -> torch.Tensor:
        tracing.counts["DeformMLP.calls"] += 1
        dt = self.dtype
        x = x_feat.to(dt)
        h = torch.cat([x, t_feat.to(dt)], dim=-1)
        for i, layer in enumerate(self.pts):
            h = torch.relu(F.linear(h, layer.weight.to(dt),
                                    layer.bias.to(dt)))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        # bf16 operands, f32 product and output
        return (h.float() @ self.out.weight.to(dt).float().t()
                + self.out.bias)


class DNeRFNetwork(nn.Module):
    """Psi_t ahead of one canonical NeRFMLP, with the config's encoders.
    ``forward(pts, viewdirs, model, times) -> raw (..., 4)``; ``model``
    ("coarse" or "fine") picks nothing: both passes run the one MLP."""

    def __init__(self, deform: DeformMLP, canonical: NeRFMLP, xyz_encoder,
                 dir_encoder, time_freq: int, use_viewdirs: bool = True):
        super().__init__()
        self.deform, self.canonical = deform, canonical
        self.xyz_encoder, self.dir_encoder = xyz_encoder, dir_encoder
        self.time_freq = time_freq
        self.use_viewdirs = use_viewdirs

    @property
    def coarse(self) -> NeRFMLP:
        return self.canonical

    @property
    def fine(self) -> NeRFMLP:
        return self.canonical

    def move(self, pts: torch.Tensor, times, deform=None) -> torch.Tensor:
        """Points (..., 3) at ``times`` (broadcastable to their leading
        shape) -> their canonical positions x + dx, f32 (M, 3). ``deform``
        (p (M, 3), t (M, 1)) -> dx computes Psi_t in place of the
        ``nn.Module`` (the training route's kernels,
        ``ops.deform_mlp.make_train_deform``)."""
        if times is None:
            raise ValueError("a D-NeRF network needs each ray's time "
                             "(the batch's 'times')")
        shape = pts.shape[:-1]
        p = pts.reshape(-1, 3).float()
        t = torch.as_tensor(times, dtype=torch.float32, device=p.device)
        t = t.expand(shape).reshape(-1, 1)
        with tracing.span("dnerf.deform"):
            tracing.counts["DNeRF.deform_points"] += p.shape[0]
            if deform is None:
                dx = self.deform(self.xyz_encoder(p), freq_encode(
                    t, self.time_freq))
            else:
                dx = deform(p, t)
            return p + torch.where(t == 0.0, 0.0, dx)

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor | None = None,
                model: str = "", times=None) -> torch.Tensor:
        shape = pts.shape[:-1]
        pts_feat = self.xyz_encoder(self.move(pts, times))
        view_feat = None
        if self.use_viewdirs and viewdirs is not None:
            dirs = viewdirs.expand(*shape, viewdirs.shape[-1])
            view_feat = self.dir_encoder(dirs.reshape(-1, dirs.shape[-1]))
        return self.canonical(pts_feat, view_feat).reshape(*shape, 4)


def make_dnerf_network(cfg, xyz_encoder, dir_encoder, dtype, use_viewdirs,
                       generator: torch.Generator) -> DNeRFNetwork:
    """``network.deform`` (D, W, skips, time_freq) ahead of one NeRFMLP of
    ``network.nerf``; Psi_t's init is drawn first, then the canonical's."""
    c, d = cfg.network, cfg.network.deform
    time_freq = int(d.get("time_freq", 10))
    deform = DeformMLP(xyz_encoder.output_dim, 1 + 2 * time_freq,
                       depth=int(d.get("D", 8)), width=int(d.get("W", 256)),
                       skips=tuple(d.get("skips", (4,))), dtype=dtype,
                       generator=generator)
    canonical = NeRFMLP(
        in_dim=xyz_encoder.output_dim, view_dim=dir_encoder.output_dim,
        depth=c.nerf.D, width=c.nerf.W, view_depth=c.nerf.get("V_D", 1),
        skips=tuple(c.nerf.skips), use_viewdirs=use_viewdirs, dtype=dtype,
        density_bias=float(c.nerf.get("density_bias", 0.0)),
        generator=generator)
    return DNeRFNetwork(deform, canonical, xyz_encoder, dir_encoder,
                        time_freq, use_viewdirs)
