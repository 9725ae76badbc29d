"""Network factory: ``cfg.network_module`` resolves through the port's
registry (the reference's module strings are registered aliases)."""

from __future__ import annotations

from ..registry import register, resolve


@register("network", "nerf", aliases=(
    "src.models.nerf.network", "nerf_replication_tpu.models.nerf.network"))
def _make_nerf(cfg):
    from .nerf.network import make_network as mk
    return mk(cfg)


@register("network", "img_fit", aliases=(
    "src.models.img_fit.network",
    "nerf_replication_tpu.models.img_fit.network"))
def _make_img_fit(cfg):
    from .img_fit.network import make_network as mk
    return mk(cfg)


def make_network(cfg):
    return resolve("network", cfg.network_module)(cfg)
