"""The thread map of the two brick gather kernels (``csrc/brick_tile.cuh``:
the eval encode ``brick_encode_eval`` and the training forward
``brick_hash_encode``) in Python, and the sector counts that judge a
gather design.

A block takes a tile of consecutive points and groups of levels (the eval
encode 64 points and 2 groups, the training forward 32 points and a group
a level: :func:`block_shape`); thread t takes point ``t % tile`` of the
tile and the levels ``t // tile, t // tile + groups, ...``, so the lanes of
one table load are 32 consecutive points at one level. Each (point, level)
writes its two features into a shared tile of ``tile_stride(L)`` floats a
point; the block then stores the tile's contiguous ``count x 2L`` floats
in 16-byte groups. :func:`tile_writes` and :func:`tile_stores` repeat the
kernel's loops and index arithmetic, so the CPU tests can check that the
map covers every (point, level) once and stores every output once.

The card's L2 serves a gather in 32-byte sectors.
:func:`sectors_per_lookup` counts the distinct sectors that the loads of
one warp-wide request touch, over all requests, per (point, level): the
figure a design's table layout and thread map set (``chip_smoke.py``
prints it beside each brick kernel's time, for the present design and the
first one). It leaves out the SM's L1, which serves a sector again to a
later request of the same block, so it bounds the L2's traffic from
above.
"""

from __future__ import annotations

import torch

from .eval_encode import CELL_WORDS
from .hashgrid_kernel import (
    BW,
    ROW,
    BrickLayout,
    compute_brick_ids,
    corners,
    level_geometry,
)

WARP = 32
SECTOR = 32            # bytes the L2 serves a request in


def tile_stride(n_levels: int) -> int:
    """Floats between two points' features in the staged tile: 2L padded to
    an odd count of 8-byte words (brick::tile_stride)."""
    return 2 * (n_levels | 1)


def block_shape(kernel: str, n_levels: int) -> tuple[int, int]:
    """(points, level groups) a block of ``kernel`` takes: ``"eval"``
    (csrc/brick_encode_eval.cu: kTile, kGroups) or ``"fwd"``
    (csrc/brick_hash_encode.cu: kFwdTile, a warp a level)."""
    return {"eval": (64, 2), "fwd": (32, n_levels)}[kernel]


def tile_writes(n: int, n_levels: int, kernel: str):
    """Every (point, level) a launch of ``kernel`` over n points computes,
    as ``encode_tile``'s level loop visits it: tuples (block, warp, lane,
    step, point, level, word), ``step`` the loop's iteration, ``word`` the
    shared-tile float where its two features go."""
    tile, groups = block_shape(kernel, n_levels)
    stride = tile_stride(n_levels)
    for block in range(-(-n // tile)):
        first = block * tile
        count = min(tile, n - first)
        for thread in range(tile * groups):
            slot = thread % tile
            if slot >= count:
                continue
            levels = range(thread // tile, n_levels, groups)
            for step, level in enumerate(levels):
                yield (block, thread // WARP, thread % WARP, step,
                       first + slot, level, slot * stride + 2 * level)


def tile_stores(n: int, n_levels: int, kernel: str):
    """Every output float a launch of ``kernel`` stores, as
    ``encode_tile``'s copy-out computes it: tuples (block, output index,
    shared-tile float it holds)."""
    tile, _ = block_shape(kernel, n_levels)
    stride, feats = tile_stride(n_levels), 2 * n_levels
    for block in range(-(-n // tile)):
        first = block * tile
        total = min(tile, n - first) * feats
        base = first * feats
        for v in range(total // 4):
            q = 4 * v // feats
            j = 4 * v - q * feats
            a = q * stride + j
            j += 2
            if j == feats:
                j, q = 0, q + 1
            b = q * stride + j
            for k, word in enumerate((a, a + 1, b, b + 1)):
                yield block, base + 4 * v + k, word
        if total % 4:
            e = total - 2
            q = e // feats
            for k in range(2):
                yield block, base + e + k, q * stride + e - q * feats + k


def warp_level_units(n: int, n_levels: int) -> torch.Tensor:
    """(N, L) id of the warp-wide request each (point, level)'s loads go in
    when a warp takes 32 consecutive points at one level: this design's
    map for both kernels, and the first eval kernel's (a thread a point)."""
    i = torch.arange(n)[:, None]
    return (i // WARP) * n_levels + torch.arange(n_levels)[None, :]


def level_fastest_units(n: int, n_levels: int) -> torch.Tensor:
    """The same for the first training forward's map: a thread a (point,
    level), the level running fastest."""
    i = torch.arange(n)[:, None]
    return (i * n_levels + torch.arange(n_levels)[None, :]) // WARP


def corner_bytes(layout: BrickLayout, x: torch.Tensor,
                 table: str) -> torch.Tensor:
    """(N, L, K) byte offsets of the table words the encode of x reads, per
    (point, level), in one of the three layouts: ``"train"`` the f32
    training table (16 floats: f0 at lane v, f1 at 128 + v of a 1 KB row),
    ``"packed"`` the packed eval table (8 words of a 512-byte row), or
    ``"cells"`` the cell-corner table (the 8 words 8k .. 8k + 7 of a 2 KB
    row)."""
    bid = compute_brick_ids(layout, x)
    per_level = []
    for level, res in enumerate(layout.scales):
        row = layout.offsets[level] + bid[:, level]
        loc, _ = level_geometry(x, res)
        if table == "cells":
            k = loc[:, 0] * 16 + loc[:, 1] * 4 + loc[:, 2]
            words = (row * CELL_WORDS + 8 * k)[:, None] + torch.arange(
                8, device=x.device)
        else:
            lane = loc[:, 0] * BW * BW + loc[:, 1] * BW + loc[:, 2]
            offs = torch.tensor([dx * BW * BW + dy * BW + dz
                                 for dx, dy, dz in corners()],
                                device=x.device)
            v = lane[:, None] + offs
            if table == "train":
                words = torch.cat([row[:, None] * ROW + v,
                                   row[:, None] * ROW + 128 + v], dim=1)
            elif table == "packed":
                words = row[:, None] * (ROW // 2) + v
            else:
                raise ValueError(f"unknown table layout {table!r}")
        per_level.append(4 * words)
    return torch.stack(per_level, dim=1)


def sectors_per_lookup(byte_offsets: torch.Tensor,
                       units: torch.Tensor) -> float:
    """Distinct 32-byte sectors that the loads of each warp-wide request
    touch, summed over the requests, per lookup: ``byte_offsets`` (..., K)
    the K byte offsets a lookup (a point at a level) reads, ``units`` (...)
    the request each lookup's loads go in. Sectors are counted from offset
    0: the tables are allocated 256-byte aligned."""
    sectors = byte_offsets // SECTOR
    keys = units.to(sectors.device)[..., None] * (int(sectors.max()) + 1) \
        + sectors
    return torch.unique(keys).numel() / units.numel()


__all__ = ["SECTOR", "block_shape", "corner_bytes", "level_fastest_units",
           "sectors_per_lookup", "tile_stores", "tile_stride", "tile_writes",
           "warp_level_units"]
