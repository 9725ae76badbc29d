"""Hierarchical volume renderer, eval and train paths.

The counterpart of nerf_replication_tpu/models/nerf/renderer/
volume_renderer.py: stratified coarse samples -> coarse MLP -> weights ->
inverse-CDF importance samples -> sorted union -> fine MLP -> composite.
PyTorch runs it eagerly, one ray chunk at a time for eval and one ray
batch per training step.

Training (``render_rays(..., generator, train=True)``) jitters the coarse
samples (``perturb``), draws the importance samples at random ``u`` from
the coarse weights with their gradient stopped, and adds ``raw_noise_std``
noise to the densities, all from one ``torch.Generator``. Its MLP is
:attr:`Renderer.train_apply`: the differentiable fused kernels
(ops/mlp_train.py) with ``network.use_pallas_mlp_train`` True, the port's
default, else the ``nn.Module`` with autograd (the JAX package's XLA arm).
A brick hash-grid NGP network trains through the ``nn.Module`` itself,
whose encoder runs the brick-encode CUDA kernels, whatever that flag says:
the JAX package has no fused train MLP for that family either
(``make_fused_train_apply`` returns None there, ops/pallas/mlp_train.py).

Not ported yet (ROADMAP.md item 3): ``render_image_fast``,
``make_frame_renderer``, ``fine_stage_ert`` and the ESS/ERT masks;
:meth:`RenderSettings.from_cfg` refuses configs that ask for them.
"""

from __future__ import annotations

import dataclasses

import torch

from ....config import as_bool
from ....ops import hashgrid_kernel, mlp_kernel, mlp_train
from ....ops.ray_ops import (
    composite,
    compute_weights,
    density_activation,
    sample_pdf,
    stratified_sample,
)
from . import ngp_renderer


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    N_samples: int = 64
    N_importance: int = 128
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True
    lindisp: bool = False
    perturb: bool = True           # jitter coarse samples in training
    raw_noise_std: float = 0.0     # density noise in training
    ray_chunk: int = 8192          # rays per eval chunk
    density_activation: str = "relu"
    finite_tail: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "RenderSettings":
        """Read from ``cfg.task_arg`` with a top-level fallback, as the JAX
        package does; flags are parsed strictly."""
        ta = cfg.get("task_arg", {})

        def get(k, d):
            return ta.get(k, cfg.get(k, d))

        if as_bool(get("fast_sampling", False), "fast_sampling") \
                or int(get("ert_segments", 1)) > 1:
            raise NotImplementedError(
                "fast_sampling / ert_segments are not ported yet: "
                "ROADMAP.md item 3")
        return cls(
            N_samples=int(get("N_samples", 64)),
            N_importance=int(get("N_importance", 128)),
            near=float(get("near", 2.0)),
            far=float(get("far", 6.0)),
            white_bkgd=as_bool(get("white_bkgd", True), "white_bkgd"),
            lindisp=as_bool(get("lindisp", False), "lindisp"),
            perturb=as_bool(get("perturb", True), "perturb"),
            raw_noise_std=float(get("raw_noise_std", 0.0)),
            ray_chunk=int(get("ray_chunk", 8192)),
            density_activation=str(get("density_activation", "relu")),
            finite_tail=as_bool(get("finite_tail", False), "finite_tail"),
        )


def fine_stage(apply_fn, rays_o, rays_d, viewdirs, t_coarse, w_c,
               s: RenderSettings, generator: torch.Generator | None = None,
               train: bool = False) -> dict:
    """Importance-resample from the coarse weights (their gradient
    stopped), sort the union of coarse and fine depths, run the fine MLP
    and composite. In training the CDF is sampled at random ``u`` and the
    densities get ``raw_noise_std`` noise, both from ``generator``."""
    gen = generator if train else None
    bins = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    t_fine = sample_pdf(bins, w_c[..., 1:-1].detach(), s.N_importance,
                        generator=gen)
    t_all, _ = torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1)
    pts = rays_o[:, None] + rays_d[:, None] * t_all[..., None]
    raw = apply_fn(pts, viewdirs[:, None], "fine")
    w_f, _, _ = compute_weights(
        raw[..., 3], t_all, activation=density_activation(s.density_activation),
        finite_tail=s.finite_tail, raw_noise_std=s.raw_noise_std,
        generator=gen)
    rgb, depth, acc = composite(torch.sigmoid(raw[..., :3]), w_f, t_all,
                                s.white_bkgd)
    return {"rgb": rgb, "depth": depth, "acc": acc}


def render_rays(apply_fn, rays_o: torch.Tensor, rays_d: torch.Tensor,
                s: RenderSettings, generator: torch.Generator | None = None,
                train: bool = False) -> dict:
    """Render a flat batch of rays (N, 3).
    ``apply_fn(pts, viewdirs, model) -> raw (..., 4)``. Deterministic
    unless ``train`` and a ``generator`` are given (the JAX package's
    ``key``). Returns rgb, depth, acc, plus the coarse composite as
    rgb_coarse/depth_coarse/acc_coarse when N_importance > 0."""
    gen = generator if train else None
    t_coarse = stratified_sample(rays_o.shape[0], s.N_samples, s.near, s.far,
                                 generator=gen if s.perturb else None,
                                 lindisp=s.lindisp, device=rays_o.device)
    pts = rays_o[:, None] + rays_d[:, None] * t_coarse[..., None]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    raw = apply_fn(pts, viewdirs[:, None], "")
    w_c, _, _ = compute_weights(
        raw[..., 3], t_coarse,
        activation=density_activation(s.density_activation),
        finite_tail=s.finite_tail, raw_noise_std=s.raw_noise_std,
        generator=gen)
    rgb_c, depth_c, acc_c = composite(torch.sigmoid(raw[..., :3]), w_c,
                                      t_coarse, s.white_bkgd)
    if s.N_importance <= 0:
        return {"rgb": rgb_c, "depth": depth_c, "acc": acc_c}
    out = fine_stage(apply_fn, rays_o, rays_d, viewdirs, t_coarse, w_c, s,
                     generator=gen, train=train)
    out.update(rgb_coarse=rgb_c, depth_coarse=depth_c, acc_coarse=acc_c)
    return out


class Renderer:
    """``Renderer(net).render(batch) -> (rgb, depth)``. ``net`` is a port
    Network holding its weights; rays go to the device of its
    parameters."""

    def __init__(self, net, cfg=None):
        self.net = net
        self.settings = (RenderSettings.from_cfg(cfg) if cfg is not None
                         else RenderSettings())
        self.apply_fn = net
        network_cfg = cfg.get("network", {}) if cfg is not None else {}
        self.fused_train = as_bool(
            network_cfg.get("use_pallas_mlp_train", True),
            "network.use_pallas_mlp_train")
        self._train_apply = None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def use_apply(self, apply_fn) -> "Renderer":
        """Route eval through a custom ``apply_fn(pts, viewdirs, model)``
        (e.g. ``ngp_renderer.make_ngp_eval_apply``); training keeps
        :attr:`train_apply`."""
        self.apply_fn = apply_fn
        return self

    def enable_fused_mlp(self) -> bool:
        """Route the MLP through the fused CUDA kernel
        (ops/mlp_kernel.py), with the weights packed now. On a CUDA
        network the kernel is built here, so a failed build raises.
        False when the architecture is not the one the kernel covers
        (``mlp_kernel.unsupported`` says what differs)."""
        fused = mlp_kernel.make_fused_apply(self.net)
        if fused is None:
            return False
        if self.device.type == "cuda":
            mlp_kernel.build()
        self.apply_fn = fused
        return True

    @property
    def train_apply(self):
        """The training apply, made at first use. A brick hash-grid NGP
        network: the ``nn.Module``, whose encoder runs the brick-encode
        kernels (built now on a CUDA network, so a failed build raises).
        Else the differentiable fused MLP kernels with
        ``network.use_pallas_mlp_train`` True (built now likewise; a
        network they do not cover raises), or the ``nn.Module`` with
        autograd."""
        if self._train_apply is None:
            if ngp_renderer.is_brick_ngp(self.net):
                if self.device.type == "cuda":
                    hashgrid_kernel.build()
                self._train_apply = self.net
            elif not self.fused_train:
                self._train_apply = self.net
            else:
                fused = mlp_train.make_fused_train_apply(self.net)
                if fused is None:
                    raise ValueError(
                        "network.use_pallas_mlp_train is on, but the fused "
                        "MLP kernels do not cover "
                        f"{mlp_kernel.unsupported(self.net)}; set "
                        "network.use_pallas_mlp_train False for the "
                        "nn.Module MLP")
                if self.device.type == "cuda":
                    mlp_train.build()
                self._train_apply = fused
        return self._train_apply

    @torch.inference_mode()
    def render_rays_batch(self, rays_o, rays_d) -> dict:
        """Flat (N, 3) rays (numpy or tensors) -> dict of (N, ...) tensors
        on the renderer's device, rendered ``ray_chunk`` rays at a time.
        The last chunk is padded to full size with rays whose direction is
        (1, 1, 1), so padding never divides by zero."""
        device = self.device
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=device)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=device)
        n = rays_o.shape[0]
        chunk = min(self.settings.ray_chunk, n)
        n_pad = (-n) % chunk
        ro = torch.nn.functional.pad(rays_o, (0, 0, 0, n_pad))
        rd = torch.nn.functional.pad(rays_d, (0, 0, 0, n_pad), value=1.0)
        parts = [render_rays(self.apply_fn, ro[i:i + chunk], rd[i:i + chunk],
                             self.settings)
                 for i in range(0, n + n_pad, chunk)]
        return {k: torch.cat([p[k] for p in parts])[:n] for k in parts[0]}

    def render(self, batch):
        """Reference-contract entry: ``batch`` holds rays_o/rays_d of shape
        (..., 3); returns (rgb (N, 3), depth (N,)) tensors."""
        out = self.render_rays_batch(
            torch.as_tensor(batch["rays_o"]).reshape(-1, 3),
            torch.as_tensor(batch["rays_d"]).reshape(-1, 3))
        return out["rgb"], out["depth"]
