"""The layout shared by the backward kernels of the 8 x 256 MLPs (#5,
``mlp_train``, and D-NeRF's deformation, ``deform_mlp``;
csrc/mlp_bwd_tile.cuh): the point padding of the delta kernel, the
tile-order workspace planes, the partial sums' row counts and the group of
the two-pass reduction."""

from __future__ import annotations

import math

import torch

PAD = 128          # the delta kernel takes whole 128-point tiles
BIAS_ROWS = 64     # points per bias partial (one of a tile's two warpgroups)
CHUNK = 4096       # points per partial of the weight-gradient kernel
GROUP = 64         # points per group of a tile-order workspace plane


def two_pass_group(rows: int) -> int:
    """Rows summed per group in the first of the two reduction passes."""
    return max(1, math.ceil(math.sqrt(rows)))


def detile(buf: torch.Tensor, n: int, n_pad: int, cols: int):
    """A tile-order plane (64-point groups, each ``[col / 8][point][col %
    8]``) as the row-major (n, cols) matrix of its first ``n`` points."""
    return buf.view(n_pad // GROUP, cols // 8, GROUP, 8).permute(0, 2, 1, 3) \
        .reshape(n_pad, cols)[:n]


def planes_of(buf: torch.Tensor, columns, n: int, n_pad: int) -> list:
    """The consecutive tile-order planes of ``buf``, one of each width in
    ``columns``, de-tiled (:func:`detile`)."""
    out, at = [], 0
    for cols in columns:
        out.append(detile(buf[at:at + n_pad * cols], n, n_pad, cols))
        at += n_pad * cols
    return out
