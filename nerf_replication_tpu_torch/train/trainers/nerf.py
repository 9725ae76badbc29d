"""NeRF loss module: renderer + MSE loss + PSNR.

The counterpart of nerf_replication_tpu/train/trainers/nerf.py:33-95:
fine-image MSE plus, with ``task_arg.coarse_loss`` (default True), the
coarse-image MSE; PSNR of the fine image. ``loss_fn`` returns
``(loss, (output, loss_stats, image_stats))``.

``task_arg.random_bkgd`` (the NGP configs) composites every training ray
onto a random colour instead of white, which forces true zero density in
empty space where a white background lets the model hide white fog. The
loader's colours are composited onto white, so the batch's ``alpha``
recovers the premultiplied colour exactly. It applies in training with a
generator, a white-background renderer and ``alpha`` in the batch, as in
the JAX package (:51-54).

A batch's ``times`` (a dynamic scene's) go to the network with its rays:
a D-NeRF renders each ray at its time.
"""

from __future__ import annotations

import torch

from ...config import as_bool
from ...models.nerf.renderer.volume_renderer import Renderer, render_rays
from ...ops.ray_ops import draw
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
        self.random_bkgd = as_bool(ta.get("random_bkgd", False),
                                   "task_arg.random_bkgd")

    @staticmethod
    def draw_background(colors: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
        """One uniform random background colour a ray, shaped as
        ``colors`` (a data-parallel rank's: its rays' of the global
        batch's draw, ``ops.ray_ops.draw``)."""
        return draw(lambda sh, g: torch.rand(sh, generator=g,
                                             device=colors.device,
                                             dtype=colors.dtype),
                    colors.shape, generator)

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True):
        """One ray batch through :attr:`Renderer.train_apply`. Stochastic
        (jitter, random CDF samples, density noise) only with ``train`` and
        a ``generator``."""
        rays_o = batch["rays_o"].reshape(-1, 3)
        rays_d = batch["rays_d"].reshape(-1, 3)
        colors = batch["colors"].reshape(-1, 3)
        bg = None
        if (train and generator is not None and self.random_bkgd
                and "alpha" in batch and self.settings.white_bkgd):
            # drawn before the render, as the JAX package splits its key
            alpha = batch["alpha"].reshape(-1, 1)
            bg = self.draw_background(colors, generator)
            colors = (colors - (1.0 - alpha)) + bg * (1.0 - alpha)
        out = render_rays(self.renderer.train_apply, rays_o, rays_d,
                          self.settings, generator=generator, train=train,
                          times=batch.get("times"))

        def recompose(rgb, acc):
            """The white-composited ``rgb`` on the random background."""
            if bg is None:
                return rgb
            return rgb + (bg - 1.0) * (1.0 - acc[..., None])

        rgb_fine = recompose(out["rgb"], out["acc"])
        mse_fine = torch.mean((rgb_fine - colors) ** 2)
        loss = mse_fine
        if self.coarse_loss and "rgb_coarse" in out:
            rgb_coarse = recompose(out["rgb_coarse"], out["acc_coarse"])
            loss = loss + torch.mean((rgb_coarse - colors) ** 2)
        loss_stats = {"loss": loss.detach(), "color_mse": mse_fine.detach(),
                      "psnr": psnr_from_mse(mse_fine.detach())}
        return loss, (out, loss_stats, {})


@register("loss", "nerf", aliases=(
    "src.train.trainers.nerf", "nerf_replication_tpu.train.trainers.nerf"))
def _make_nerf_wrapper(cfg, network=None):
    return NetworkWrapper(network, cfg)
