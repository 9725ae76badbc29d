"""Forward-only bricked hash-grid encode from the packed eval table: the
CUDA kernel, its wrapper and its plain PyTorch version.

Replaces the TPU Pallas kernels of ``brick_encode_eval``
(nerf_replication_tpu/ops/pallas/eval_encode.py): ``_eval_kernel_v2``
(the all-"mxu" lane-parallel variant, :202) and ``_eval_kernel`` (scalar
row copies for large levels, :245). Which of the two the TPU takes is a
fetch strategy of its memory system (``mxu_max_rows``, ``blk``); both
compute the same function, so one CUDA kernel (``csrc/brick_encode_eval.cu``)
stands for both and the port's signature has neither argument.

The table is packed as :func:`pack_eval_table` packs it: one 32-bit word
per vertex holds feature 0's bf16 bits in its high half and feature 1's
in its low half, so one load per trilinear corner gives both features
(8 loads a level). Numerics are the training forward's: table values are
bf16, the trilinear weights and sums f32. The plain version sums the
corners in the kernel's order with the kernel's roundings, so the two
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .hashgrid_kernel import (
    BrickLayout,
    compute_brick_ids,
    corner_lane_weight,
    corners,
    hash_range,
    level_geometry,
)

MAX_LEVELS = 16      # brick::kMaxLevels in csrc/brick_encode.cuh
WORDS = 128          # 32-bit words per packed row


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


def _encode_plain(layout: BrickLayout, packed: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic (csrc/brick_encode.cuh) in PyTorch."""
    bid = compute_brick_ids(layout, x)
    flat = packed.reshape(-1)
    feats = []
    for level, res in enumerate(layout.scales):
        base = (layout.offsets[level] + bid[:, level]) * WORDS
        loc, frac = level_geometry(x, res)
        f0 = f1 = torch.zeros_like(x[:, 0])
        for dx, dy, dz in corners():
            v, w = corner_lane_weight(loc, frac, dx, dy, dz)
            hi, lo = unpack_f0_f1(flat[base + v])
            f0 = f0 + w * hi
            f1 = f1 + w * lo
        feats += [f0, f1]
    return torch.stack(feats, dim=-1)


def brick_encode_eval_reference(layout: BrickLayout, packed_table: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x (N, 3) in [0,1] -> (N, 2L)."""
    brick_encode_eval_reference.calls += 1
    return _encode_plain(layout, packed_table, x.float())


brick_encode_eval_reference.calls = 0


class Levels(ctypes.Structure):
    """``brick::Levels`` of csrc/brick_encode.cuh, passed by pointer."""
    _fields_ = [("res", ctypes.c_float * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("bside", ctypes.c_int * MAX_LEVELS),
                ("hash_mask", ctypes.c_uint32 * MAX_LEVELS)]


@functools.cache
def kernel_levels(layout: BrickLayout) -> Levels:
    """The layout as the kernels read it: per level its resolution, first
    row, bricks per side, and ``hash_range - 1`` (0 for a dense level)."""
    if len(layout.scales) > MAX_LEVELS:
        raise ValueError(f"brick kernels: at most {MAX_LEVELS} levels")
    lv = Levels()
    for level, res in enumerate(layout.scales):
        lv.res[level] = float(res)
        lv.offset[level] = layout.offsets[level]
        lv.bside[level] = layout.bsides[level]
        lv.hash_mask[level] = (hash_range(layout, level) - 1
                               if layout.use_hash[level] else 0)
    return lv


def check_table(layout: BrickLayout, packed: torch.Tensor,
                device: torch.device) -> None:
    if packed.dtype != torch.int32 or tuple(packed.shape) != (
            layout.n_rows, WORDS) or not packed.is_contiguous() \
            or packed.device != device:
        raise ValueError(f"brick kernels: the packed table must be a "
                         f"contiguous int32 ({layout.n_rows}, {WORDS}) tensor "
                         f"on {device}")


def check_points(x: torch.Tensor) -> int:
    n = x.shape[0]
    if x.dtype != torch.float32 or tuple(x.shape) != (n, 3) \
            or not x.is_contiguous():
        raise ValueError(f"brick kernels: x must be a contiguous float32 "
                         f"({n}, 3) tensor")
    if n >= 2 ** 31 // (2 * MAX_LEVELS):
        raise ValueError(f"brick kernels: {n} points exceed the int32 index")
    return n


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


def brick_encode_eval(layout: BrickLayout, packed_table: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], packed_table (n_rows, 128) int32 (see
    :func:`pack_eval_table`) -> (N, 2L) f32 features ``[f0, f1]`` per level.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return brick_encode_eval_reference(layout, packed_table, x)
    if x.device.type != "cuda":
        raise ValueError(f"brick_encode_eval: unsupported device {x.device}")
    n = check_points(x)
    check_table(layout, packed_table, x.device)
    levels = kernel_levels(layout)
    out = torch.empty((n, 2 * len(layout.scales)), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.brick_encode_eval(
            x.data_ptr(), packed_table.data_ptr(), out.data_ptr(), n,
            ctypes.byref(levels), len(layout.scales),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "brick_encode_eval")
    brick_encode_eval.launches += 1
    return out


brick_encode_eval.launches = 0


def encode_flops_per_point(layout: BrickLayout) -> int:
    """f32 multiplies and adds of the encode per point: per level and axis
    the position, the fraction and 1 - fraction; per corner two weight
    products and a multiply-add for each feature."""
    return len(layout.scales) * (3 * 3 + 8 * 6)


__all__ = ["pack_eval_table", "unpack_f0_f1", "brick_encode_eval",
           "brick_encode_eval_reference", "kernel_levels", "build",
           "encode_flops_per_point"]
