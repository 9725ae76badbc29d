"""Encoder dispatch: the config ``type`` names of
nerf_replication_tpu/models/encoding/__init__.py, the reference's
``cuda_*`` names as aliases. Parameter-free encoders (frequency, SH) are
callables with ``output_dim``; the parameterised ones (hash grids, their
composites, the D-NeRF family) are ``nn.Module``s."""

from __future__ import annotations

from ...config import as_bool
from .freq import FrequencyEncoder, freq_encode

_DNERF = ("dnerf", "dnerf_mlp_tensorf", "dnerf_ngp_mlp", "dnerf_ngp_tensorf",
          "cuda_dnerf_ngp_tensorf")


def get_encoder(enc_cfg, generator=None):
    """The encoder of ``enc_cfg``; a parameterised one draws its init from
    ``generator`` (a torch.Generator)."""
    t = enc_cfg.type
    if t == "frequency":
        return FrequencyEncoder(
            input_dim=enc_cfg.get("input_dim", 3),
            freq=enc_cfg.get("freq", 10),
            include_input=as_bool(enc_cfg.get("include_input", True),
                                  "include_input"),
        )
    if t == "sphere_harmonics":
        from .sh import SHEncoder
        return SHEncoder(degree=enc_cfg.get("degree", 4),
                         input_dim=enc_cfg.get("input_dim", 3))
    if t in ("hashgrid", "cuda_hashgrid", "grid_hash"):
        from .hashgrid import HashGridEncoder
        return HashGridEncoder.from_cfg(enc_cfg, generator=generator)
    if t in ("triplane", "cuda_triplane"):
        from .triplane import TriPlaneEncoder
        return TriPlaneEncoder.from_cfg(enc_cfg, generator)
    if t == "cuda_hashgrid_latent":
        from .hashgrid import HashLatentEncoder
        return HashLatentEncoder.from_cfg(enc_cfg, generator)
    if t == "cuda_hashgrid_4d":
        from .hashgrid import HashGrid4DEncoder
        return HashGrid4DEncoder.from_cfg(enc_cfg, generator)
    if t == "cuda_hashgrid_coef":
        from .hashgrid import HashCoefEncoder
        return HashCoefEncoder.from_cfg(enc_cfg, generator)
    if t == "cuda_motion2d":
        from .triplane import Motion2DEncoder
        return Motion2DEncoder.from_cfg(enc_cfg, generator)
    if t in _DNERF:
        from .dnerf import DNeRFEncoder
        return DNeRFEncoder.from_cfg(enc_cfg, variant=t, generator=generator)
    raise ValueError(f"unknown encoder type: {t!r}")


__all__ = ["get_encoder", "FrequencyEncoder", "freq_encode"]
