"""2D image-fitting network, the counterpart of
nerf_replication_tpu/models/img_fit/network.py: uv (..., 2) through the
frequency encoder, ``D`` ReLU layers of width ``W`` and a sigmoid RGB head;
``forward(batch)`` returns ``{"rgb": (..., 3) float32}``. Every product runs
in ``network.dtype`` (bfloat16 by default, as Flax's ``Dense(dtype=...)``
with float32 parameters), the output in float32. No TPU kernel lies on it,
so the layers are ``nn.Linear``: ``backbone.{i}`` and ``output``, the
state_dict keys ``params_from_jax`` makes of Flax's ``backbone_{i}`` and
``output``. Initialisation is Flax's, drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..encoding import get_encoder
from ..flax_init import dense


class ImgFitMLP(nn.Module):
    def __init__(self, uv_encoder, depth: int = 4, width: int = 128,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.uv_encoder = uv_encoder
        self.dtype = dtype
        dims = [uv_encoder.output_dim] + [width] * depth
        self.backbone = nn.ModuleList(
            dense(i, o, generator) for i, o in zip(dims[:-1], dims[1:]))
        self.output = dense(width, 3, generator)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, batch: dict) -> dict:
        uv = batch["uv"]
        shape = uv.shape[:-1]
        x = self.uv_encoder(uv.reshape(-1, uv.shape[-1])).to(self.dtype)
        for layer in self.backbone:
            x = torch.relu(self._dense(layer, x))
        rgb = torch.sigmoid(self._dense(self.output, x))
        return {"rgb": rgb.float().reshape(*shape, 3)}


def make_network(cfg, generator: torch.Generator | None = None) -> ImgFitMLP:
    """The config's ImgFitMLP, initialised from ``generator`` (default: a
    CPU generator seeded with ``cfg.seed``)."""
    c = cfg.network
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return ImgFitMLP(get_encoder(c.uv_encoder), depth=c.get("D", 4),
                     width=c.get("W", 128),
                     dtype=getattr(torch, c.get("dtype", "float32")),
                     generator=generator)
