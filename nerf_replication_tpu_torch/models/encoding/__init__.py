"""Encoder dispatch: the config ``type`` names of
nerf_replication_tpu/models/encoding/__init__.py. The port has the
frequency and spherical-harmonics encoders and the brick backend of the
hash grid; every other name (and the hash grid's ``xla`` backend) raises
``NotImplementedError`` naming the ROADMAP.md item that ports it."""

from __future__ import annotations

from ...config import as_bool
from .freq import FrequencyEncoder, freq_encode

# type name -> the ROADMAP.md item (queue A) that ports it
_NOT_PORTED = {
    t: "A.12 (composite encoders)"
    for t in ("triplane", "cuda_triplane", "cuda_hashgrid_latent",
              "cuda_hashgrid_4d", "cuda_hashgrid_coef", "cuda_motion2d",
              "dnerf", "dnerf_mlp_tensorf", "dnerf_ngp_mlp",
              "dnerf_ngp_tensorf", "cuda_dnerf_ngp_tensorf")
}


def get_encoder(enc_cfg, generator=None):
    """The encoder of ``enc_cfg``; a hash grid draws its table's init from
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
    if t in _NOT_PORTED:
        raise NotImplementedError(
            f"encoder type {t!r} is not ported yet: ROADMAP.md item "
            f"{_NOT_PORTED[t]}")
    raise ValueError(f"unknown encoder type: {t!r}")


__all__ = ["get_encoder", "FrequencyEncoder", "freq_encode"]
