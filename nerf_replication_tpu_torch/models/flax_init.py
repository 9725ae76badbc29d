"""Flax's initialisers, drawn from an explicit ``torch.Generator``.

``nn.Dense``: kernels ``lecun_normal`` (a normal truncated at +-2 sigma,
sigma = 1/sqrt(fan_in) / 0.87962566 so that the truncated variance is
1/fan_in), biases zero. The parameters the JAX package declares itself
(hash tables, latent codes) are uniform in a small interval.
"""

from __future__ import annotations

import torch
from torch import nn

# std of a unit normal truncated at +-2: lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` kernel and zero bias, in place."""
    std = layer.in_features ** -0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()


def dense(in_features: int, out_features: int,
          generator: torch.Generator) -> nn.Linear:
    """An ``nn.Linear`` initialised as Flax's ``nn.Dense``."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer, generator)
    return layer


def uniform_parameter(shape, generator: torch.Generator,
                      scale: float = 1e-4) -> nn.Parameter:
    """A float32 parameter drawn from U(-scale, scale)."""
    value = torch.empty(*shape)
    value.uniform_(-scale, scale, generator=generator)
    return nn.Parameter(value)
