"""NeRF loss module: renderer + MSE loss + PSNR.

The counterpart of nerf_replication_tpu/train/trainers/nerf.py:33-95:
fine-image MSE plus, with ``task_arg.coarse_loss`` (default True), the
coarse-image MSE; PSNR of the fine image. ``loss_fn`` returns
``(loss, (output, loss_stats, image_stats))``.
``random_bkgd``, which only the NGP configs use, is not ported yet.
"""

from __future__ import annotations

import torch

from ...config import as_bool
from ...models.nerf.renderer.volume_renderer import Renderer, render_rays
from ...registry import register


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


class NetworkWrapper:
    def __init__(self, net, cfg):
        self.net = net
        self.cfg = cfg
        self.renderer = Renderer(net, cfg=cfg)
        self.settings = self.renderer.settings
        ta = cfg.get("task_arg", {})
        self.coarse_loss = as_bool(ta.get("coarse_loss", True),
                                   "task_arg.coarse_loss")
        if as_bool(ta.get("random_bkgd", False), "task_arg.random_bkgd"):
            raise NotImplementedError(
                "task_arg.random_bkgd is not ported yet: ROADMAP.md item A.6 "
                "(random_bkgd, with the NGP configs of slice 3)")

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True):
        """One ray batch through :attr:`Renderer.train_apply`. Stochastic
        (jitter, random CDF samples, density noise) only with ``train`` and
        a ``generator``."""
        rays_o = batch["rays_o"].reshape(-1, 3)
        rays_d = batch["rays_d"].reshape(-1, 3)
        colors = batch["colors"].reshape(-1, 3)
        out = render_rays(self.renderer.train_apply, rays_o, rays_d,
                          self.settings, generator=generator, train=train)
        mse_fine = torch.mean((out["rgb"] - colors) ** 2)
        loss = mse_fine
        if self.coarse_loss and "rgb_coarse" in out:
            loss = loss + torch.mean((out["rgb_coarse"] - colors) ** 2)
        loss_stats = {"loss": loss.detach(), "color_mse": mse_fine.detach(),
                      "psnr": psnr_from_mse(mse_fine.detach())}
        return loss, (out, loss_stats, {})


@register("loss", "nerf", aliases=(
    "src.train.trainers.nerf", "nerf_replication_tpu.train.trainers.nerf"))
def _make_nerf_wrapper(cfg, network=None):
    return NetworkWrapper(network, cfg)
