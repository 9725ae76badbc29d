"""The bricked multi-level hash-grid table: its layout, brick ids and the
plain version of the training forward.

The counterpart of nerf_replication_tpu/ops/pallas/hashgrid_kernel.py
(layout :81-110, ``compute_brick_ids`` :120-146, the training forward's
numerics :181-213 and ``brick_encode_reference`` :359). Each level stores
bricks of 4^3 cells (5^3 = 125 vertices) as table rows of 256 lanes:
feature 0 of vertex ``v = vx*25 + vy*5 + vz`` at lane v, feature 1 at
lane 128 + v. Coarse levels store every brick; levels with more bricks
than ``2^log2_bricks`` hash the brick coordinate with the instant-ngp XOR
primes into a power-of-two range of rows.

The hash is uint32 arithmetic. PyTorch has no full uint32 arithmetic, so
it runs in int64 and is masked to 32 bits, which gives JAX's bits.

The training kernels themselves (the table gradient, TPU kernels #6/#7)
are not ported yet (ROADMAP.md queue B); the eval kernels are in
``eval_encode.py`` and ``fused_ngp.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BRICK = 4           # cells per brick side
BW = BRICK + 1      # vertices per brick side
BV = BW ** 3        # vertices per brick (125)
ROW = 256           # lanes per table row: [f0 x 125, pad | f1 x 125, pad]
# levels with at most this many rows are read as bf16 by the training
# forward (the TPU's one-hot "mxu" fetch); larger levels are read in f32
MXU_MAX_ROWS = 4096
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class BrickLayout(NamedTuple):
    """Static description of the bricked multi-level table."""
    scales: tuple          # cells per side, per level
    bsides: tuple          # bricks per side, per level
    offsets: tuple         # first table row per level (+ total at end)
    use_hash: tuple        # whether the level hashes brick coords
    n_rows: int            # total table rows


def make_brick_layout(n_levels: int, base_resolution: int,
                      finest_resolution: int, log2_bricks: int = 12,
                      per_level_scale: float = 2.0) -> BrickLayout:
    """The JAX package's layout, level by level: resolution
    ``ceil(base * b^l)``, bricks per side, rows ``min(bricks, 2^log2_bricks)``
    rounded up to a multiple of 128."""
    if finest_resolution and finest_resolution > 0 and n_levels > 1:
        b = (finest_resolution / base_resolution) ** (1.0 / (n_levels - 1))
    else:
        b = per_level_scale
    cap = 2 ** log2_bricks
    scales, bsides, offsets, use_hash = [], [], [0], []
    for i in range(n_levels):
        res = int(np.ceil(base_resolution * (b ** i)))
        bs = -(-res // BRICK)
        dense = bs ** 3
        n = int(np.ceil(min(dense, cap) / 128) * 128)
        scales.append(res)
        bsides.append(bs)
        use_hash.append(dense > cap)
        offsets.append(offsets[-1] + n)
    return BrickLayout(tuple(scales), tuple(bsides), tuple(offsets),
                       tuple(use_hash), offsets[-1])


def level_rows(layout: BrickLayout, level: int) -> int:
    return layout.offsets[level + 1] - layout.offsets[level]


def hash_range(layout: BrickLayout, level: int) -> int:
    """The power of two a hashed level's brick hash is reduced modulo: the
    largest that fits the level's rows."""
    return 1 << int(np.floor(np.log2(level_rows(layout, level))))


def compute_brick_ids(layout: BrickLayout, x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1] -> per-level LOCAL brick ids (N, L) int64."""
    ids = []
    for level, res in enumerate(layout.scales):
        bs = layout.bsides[level]
        bc = [torch.floor(x[:, a] * res).long().clamp(0, res - 1) // BRICK
              for a in range(3)]
        if layout.use_hash[level]:
            h = bc[0] ^ ((bc[1] * _PRIMES[1]) & _U32) \
                ^ ((bc[2] * _PRIMES[2]) & _U32)
            bid = h % hash_range(layout, level)
        else:
            bid = (bc[0] * bs + bc[1]) * bs + bc[2]
        ids.append(bid)
    return torch.stack(ids, dim=-1)


def corners():
    """The 8 trilinear corners' offsets ``(dx, dy, dz)`` in the kernels'
    order (corner c = 4 dx + 2 dy + dz)."""
    return [((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8)]


def level_geometry(x: torch.Tensor, res: int):
    """Per point of one level: the in-brick cell (N, 3) int64 and the
    fraction inside the cell (N, 3) f32, as ``_level_geometry`` (:149-172)
    computes them: ``cell = clip(floor(x * res), 0, res - 1)``."""
    pos = x * res
    cell = torch.clamp(torch.floor(pos), 0.0, res - 1.0)
    return cell.long() & (BRICK - 1), pos - cell


def corner_lane_weight(loc: torch.Tensor, frac: torch.Tensor, dx: int,
                       dy: int, dz: int):
    """One corner's lane ``v`` in the brick row (N,) and its trilinear
    weight (N,), the weight multiplied in the order x, y, z."""
    v = (loc[:, 0] + dx) * (BW * BW) + (loc[:, 1] + dy) * BW + (loc[:, 2] + dz)
    w = [frac[:, a] if d else 1.0 - frac[:, a]
         for a, d in enumerate((dx, dy, dz))]
    return v, w[0] * w[1] * w[2]


def brick_encode_reference(layout: BrickLayout, table: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], table (n_rows, 256) f32 -> (N, 2L) f32: the
    training forward ``brick_hash_encode`` in plain PyTorch. Levels of at
    most ``MXU_MAX_ROWS`` rows read the table rounded to bf16, as the TPU
    kernel's one-hot fetch does (:196-201); larger levels read it in f32.
    Trilinear weights and sums are f32, the corners summed in order.
    Differentiable in ``table``."""
    bid = compute_brick_ids(layout, x)
    feats = []
    for level, res in enumerate(layout.scales):
        rows = table[layout.offsets[level] + bid[:, level]]      # (N, 256)
        if level_rows(layout, level) <= MXU_MAX_ROWS:
            rows = rows.to(torch.bfloat16).float()
        loc, frac = level_geometry(x, res)
        f0 = f1 = torch.zeros_like(x[:, 0])
        for dx, dy, dz in corners():
            v, w = corner_lane_weight(loc, frac, dx, dy, dz)
            f0 = f0 + w * rows.gather(1, v[:, None])[:, 0]
            f1 = f1 + w * rows.gather(1, (128 + v)[:, None])[:, 0]
        feats += [f0, f1]
    return torch.stack(feats, dim=-1)


__all__ = ["BRICK", "BW", "BV", "ROW", "MXU_MAX_ROWS", "BrickLayout",
           "make_brick_layout", "compute_brick_ids", "brick_encode_reference",
           "level_rows", "hash_range"]
