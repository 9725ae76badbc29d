"""Forward-only bricked hash-grid encode for eval: the CUDA kernel, its
wrapper, its plain PyTorch version, and the two tables it reads from.

Replaces the TPU Pallas kernels of ``brick_encode_eval``
(nerf_replication_tpu/ops/pallas/eval_encode.py): ``_eval_kernel_v2``
(the all-"mxu" lane-parallel variant, :202) and ``_eval_kernel`` (scalar
row copies for large levels, :245). Which of the two the TPU takes is a
fetch strategy of its memory system (``mxu_max_rows``, ``blk``); both
compute the same function, so one CUDA kernel (``csrc/brick_encode_eval.cu``)
stands for both and the port's signature has neither argument.

The table is packed as :func:`pack_eval_table` packs it: one 32-bit word
per vertex holds feature 0's bf16 bits in its high half and feature 1's
in its low half, so one word per trilinear corner gives both features.
The kernel reads it rearranged by :func:`pack_cell_table`: for each cell
of a brick, the words of its 8 corners side by side, so that a level's
corners are one aligned 32-byte sector of the card's L2 (in the packed
table they span ~3.5). The cell table is 4x the packed one, since
neighbouring cells share vertices; it is built once per table, as the
packed table is. Numerics are the training forward's: table values are
bf16, the trilinear weights and sums f32. The plain versions sum the
corners in the kernel's order with the kernel's roundings, so all three
(the kernel, its plain version over the cell table and
:func:`brick_encode_eval_reference` over the packed table) agree bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import tracing
from . import _build
from .hashgrid_kernel import (
    BrickLayout,
    check_points,
    compute_brick_ids,
    corner_lane_weight,
    corners,
    kernel_levels,
    level_geometry,
)

WORDS = 128          # 32-bit words per packed row
CELL_WORDS = 512     # words per cell-table row: 64 cells x 8 corners


def _bf16_bits(t: torch.Tensor) -> torch.Tensor:
    """f32 -> its bf16 rounding's 16 bits, as int64 in [0, 65535]."""
    return t.float().to(torch.bfloat16).view(torch.int16).long() & 0xFFFF


def pack_eval_table(table: torch.Tensor) -> torch.Tensor:
    """(n_rows, 256) f32 training table -> (n_rows, 128) int32 holding the
    bits of JAX's uint32 packing: bf16(f0) << 16 | bf16(f1)."""
    word = (_bf16_bits(table[:, :WORDS]) << 16) | _bf16_bits(table[:, WORDS:])
    return word.to(torch.int32).contiguous()   # wraps to the same 32 bits


def unpack_f0_f1(words: torch.Tensor):
    """Packed words (int32) -> (f0, f1) f32: the high half as a float, and
    the low half shifted up."""
    f0 = (words & -65536).view(torch.float32)
    f1 = (words.long() << 16).to(torch.int32).view(torch.float32)
    return f0, f1


def pack_cell_table(packed: torch.Tensor) -> torch.Tensor:
    """(n_rows, 128) int32 packed table -> (n_rows, 512) int32 cell-corner
    table: cell k = lx*16 + ly*4 + lz of a brick holds the words of its
    corners c = 0..7 (:func:`corners` order) at words 8k .. 8k + 7. A copy
    of words, on the packed table's device."""
    lane = torch.tensor([lx * 25 + ly * 5 + lz for lx in range(4)
                         for ly in range(4) for lz in range(4)])
    corner = torch.tensor([dx * 25 + dy * 5 + dz for dx, dy, dz in corners()])
    index = (lane[:, None] + corner[None, :]).reshape(-1)
    return packed[:, index.to(packed.device)].contiguous()


def _encode_plain(layout: BrickLayout, words: torch.Tensor,
                  x: torch.Tensor, cells: bool = False) -> torch.Tensor:
    """The kernel's arithmetic (csrc/brick_encode.cuh) in PyTorch, from the
    packed table or, with ``cells``, the cell-corner table."""
    bid = compute_brick_ids(layout, x)
    flat = words.reshape(-1)
    feats = []
    for level, res in enumerate(layout.scales):
        row = layout.offsets[level] + bid[:, level]
        loc, frac = level_geometry(x, res)
        if cells:
            base = row * CELL_WORDS + 8 * (loc[:, 0] * 16 + loc[:, 1] * 4
                                           + loc[:, 2])
        f0 = f1 = torch.zeros_like(x[:, 0])
        for c, (dx, dy, dz) in enumerate(corners()):
            v, w = corner_lane_weight(loc, frac, dx, dy, dz)
            hi, lo = unpack_f0_f1(flat[base + c] if cells
                                  else flat[row * WORDS + v])
            f0 = f0 + w * hi
            f1 = f1 + w * lo
        feats += [f0, f1]
    return torch.stack(feats, dim=-1)


def brick_encode_eval_reference(layout: BrickLayout, packed_table: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """The function in plain PyTorch from the packed table, the oracle of
    the kernel and of :func:`pack_cell_table`. x (N, 3) in [0,1] -> (N,
    2L)."""
    tracing.counts["brick_encode_eval_reference.calls"] += 1
    return _encode_plain(layout, packed_table, x.float())


def brick_encode_cells_reference(layout: BrickLayout, cells: torch.Tensor,
                                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function read from the
    cell-corner table, word for word as the kernel reads it."""
    tracing.counts["brick_encode_cells_reference.calls"] += 1
    return _encode_plain(layout, cells, x.float(), cells=True)


def check_table(layout: BrickLayout, packed: torch.Tensor,
                device: torch.device) -> None:
    if packed.dtype != torch.int32 or tuple(packed.shape) != (
            layout.n_rows, WORDS) or not packed.is_contiguous() \
            or packed.device != device:
        raise ValueError(f"brick kernels: the packed table must be a "
                         f"contiguous int32 ({layout.n_rows}, {WORDS}) tensor "
                         f"on {device}")


def check_cells(layout: BrickLayout, cells: torch.Tensor,
                device: torch.device) -> None:
    """The kernel reads a cell's 32 bytes with two 16-byte loads: the cell
    table must be contiguous and 16-byte aligned."""
    if cells.dtype != torch.int32 or tuple(cells.shape) != (
            layout.n_rows, CELL_WORDS) or not cells.is_contiguous() \
            or cells.device != device or cells.data_ptr() % 16:
        raise ValueError(f"brick_encode_eval: the cell table must be a "
                         f"contiguous, 16-byte aligned int32 "
                         f"({layout.n_rows}, {CELL_WORDS}) tensor on {device}")


@functools.cache
def _kernel():
    lib = _build.load("brick_encode_eval")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.brick_encode_eval.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr]
    lib.brick_encode_eval.restype = i32
    return lib


def build() -> None:
    """Build and load the kernel now, so that a failed build raises here."""
    _kernel()


def brick_encode_eval(layout: BrickLayout, cells: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], cells (n_rows, 512) int32 (see
    :func:`pack_cell_table`) -> (N, 2L) f32 features ``[f0, f1]`` per level.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return brick_encode_cells_reference(layout, cells, x)
    if x.device.type != "cuda":
        raise ValueError(f"brick_encode_eval: unsupported device {x.device}")
    n = check_points(x)
    check_cells(layout, cells, x.device)
    levels = kernel_levels(layout)
    out = torch.empty((n, 2 * len(layout.scales)), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.brick_encode_eval(
            x.data_ptr(), cells.data_ptr(), out.data_ptr(), n,
            ctypes.byref(levels), len(layout.scales),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "brick_encode_eval")
    tracing.counts["brick_encode_eval.launches"] += 1
    return out


__all__ = ["pack_eval_table", "pack_cell_table", "unpack_f0_f1",
           "brick_encode_eval", "brick_encode_eval_reference",
           "brick_encode_cells_reference", "build", "check_cells"]
