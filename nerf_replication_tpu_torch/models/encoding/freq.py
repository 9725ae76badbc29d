"""Frequency (NeRF positional) encoding, as
nerf_replication_tpu/models/encoding/freq.py: identity first, then
[sin, cos] at bands 2^0 .. 2^(F-1). Output dim = input_dim * (1 + 2F)."""

from __future__ import annotations

import torch

from ...utils import tracing


def freq_encode(x: torch.Tensor, n_freqs: int,
                include_input: bool = True) -> torch.Tensor:
    """(..., D) -> (..., D * (include_input + 2 * n_freqs)), laid out
    ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]``, each over all D
    dims. Scaling by 2^i is exact in float32. Counts its calls
    (``tracing.counts["freq_encode.calls"]``): the kernels encode on chip,
    so a route on them makes none."""
    tracing.counts["freq_encode.calls"] += 1
    feats = [x] if include_input else []
    for i in range(n_freqs):
        xb = x * (2.0 ** i)
        feats += [torch.sin(xb), torch.cos(xb)]
    return torch.cat(feats, dim=-1)


class FrequencyEncoder:
    """Parameter-free encoder with ``output_dim``, as the JAX package's."""

    def __init__(self, input_dim: int = 3, freq: int = 10,
                 include_input: bool = True):
        self.input_dim = input_dim
        self.n_freqs = freq
        self.include_input = include_input
        self.output_dim = input_dim * (int(include_input) + 2 * freq)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return freq_encode(x, self.n_freqs, self.include_input)
