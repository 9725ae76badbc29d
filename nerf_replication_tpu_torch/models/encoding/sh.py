"""Real spherical-harmonics direction encoder, as
nerf_replication_tpu/models/encoding/sh.py: degree 1-4 (the instant-ngp
convention for view directions), ``degree^2`` features, the directions
normalised by ``|d| + 1e-8`` first. Terms are multiplied in the JAX
package's order."""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions (..., 3) -> SH basis values (..., degree^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz, _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


class SHEncoder:
    """Parameter-free encoder with ``output_dim``, as the JAX package's."""

    def __init__(self, degree: int = 4, input_dim: int = 3):
        if not 1 <= degree <= 4:
            raise ValueError(f"SH degree must be 1-4, got {degree}")
        self.degree = degree
        self.input_dim = input_dim
        self.output_dim = degree ** 2

    def __call__(self, dirs: torch.Tensor) -> torch.Tensor:
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
        return sh_encode(dirs, self.degree)
