"""img_fit loss module, the counterpart of
nerf_replication_tpu/train/trainers/img_fit.py (the loss wrapper the
reference's config names but its tree lacks): the MSE of the predicted
rgb, with PSNR as a stat. ``loss_fn`` returns ``(loss, (output,
loss_stats, image_stats))``; ``render_eval`` is the network's forward on a
whole image."""

from __future__ import annotations

import torch

from ...registry import register
from .nerf import psnr_from_mse


class NetworkWrapper:
    def __init__(self, net, cfg):
        self.net = net
        self.cfg = cfg

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True):
        out = self.net(batch)
        mse = torch.mean((out["rgb"] - batch["rgb"]) ** 2)
        loss_stats = {"loss": mse.detach(), "color_mse": mse.detach(),
                      "psnr": psnr_from_mse(mse.detach())}
        return mse, (out, loss_stats, {})

    @torch.no_grad()
    def render_eval(self, batch: dict) -> dict:
        return self.net(batch)


@register("loss", "img_fit", aliases=(
    "src.train.trainers.img_fit", "src.train.losses.img_fit",
    "nerf_replication_tpu.train.trainers.img_fit"))
def _make_img_fit_wrapper(cfg, network=None):
    return NetworkWrapper(network, cfg)
