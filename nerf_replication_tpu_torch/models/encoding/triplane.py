"""Triplane / Motion2D encoders, as
nerf_replication_tpu/models/encoding/triplane.py: they live in hashgrid.py,
compositions of the 2-D hash grid."""

from .hashgrid import Motion2DEncoder, TriPlaneEncoder

__all__ = ["TriPlaneEncoder", "Motion2DEncoder"]
