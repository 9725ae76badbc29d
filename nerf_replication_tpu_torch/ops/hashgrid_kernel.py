"""The bricked multi-level hash-grid table: its layout, brick ids, and the
training encode with its table gradient (CUDA kernels, wrappers, plain
PyTorch versions and the ``autograd.Function`` that joins them).

The counterpart of nerf_replication_tpu/ops/pallas/hashgrid_kernel.py
(layout :81-110, ``compute_brick_ids`` :120-146, the forward's numerics
:181-213, the backward's :216-265, the ``custom_vjp`` :291-354 and
``brick_encode_reference`` :359). Each level stores bricks of 4^3 cells
(5^3 = 125 vertices) as table rows of 256 lanes: feature 0 of vertex
``v = vx*25 + vy*5 + vz`` at lane v, feature 1 at lane 128 + v. Coarse
levels store every brick; levels with more bricks than ``2^log2_bricks``
hash the brick coordinate with the instant-ngp XOR primes into a
power-of-two range of rows.

The hash is uint32 arithmetic. PyTorch has no full uint32 arithmetic, so
it runs in int64 and is masked to 32 bits, which gives JAX's bits.

``brick_hash_encode`` (TPU kernel ``_brick_fwd_impl``) and
``brick_hash_encode_bwd`` (``_brick_bwd``) launch
``csrc/brick_hash_encode.cu`` for CUDA tensors and take the plain versions
below for CPU tensors. Numerics are the TPU kernels': on levels of at most
``MXU_MAX_ROWS`` rows the forward reads the table rounded to bf16 and the
backward rounds every point's per-corner contribution ``w * g`` to bf16
(the one-hot matmuls' operand type there); larger levels stay f32; every
weight and sum is f32. The gradient kernel adds with ``atomicAdd``, so its
f32 sums come in an order that changes from run to run and it is not
bit-reproducible (the TPU kernel, single-threaded, is). The eval kernels
are in ``eval_encode.py`` and ``fused_ngp.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import tracing
from . import _build

BRICK = 4           # cells per brick side
BW = BRICK + 1      # vertices per brick side
BV = BW ** 3        # vertices per brick (125)
ROW = 256           # lanes per table row: [f0 x 125, pad | f1 x 125, pad]
# levels with at most this many rows are read as bf16 by the training
# forward and get bf16 contributions in its backward (the TPU's one-hot
# "mxu" fetch); larger levels are f32 both ways
MXU_MAX_ROWS = 4096
MAX_LEVELS = 16     # brick::kMaxLevels in csrc/brick_encode.cuh
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


def _bf16_levels(layout: BrickLayout) -> list[bool]:
    """Per level: whether it takes the bf16 branch (at most
    ``MXU_MAX_ROWS`` rows)."""
    return [level_rows(layout, level) <= MXU_MAX_ROWS
            for level in range(len(layout.scales))]


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 (ties to even), back in f32."""
    return t.to(torch.bfloat16).float()


def brick_encode_reference(layout: BrickLayout, table: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], table (n_rows, 256) f32 -> (N, 2L) f32: the
    training forward ``brick_hash_encode`` in plain PyTorch. Levels of at
    most ``MXU_MAX_ROWS`` rows read the table rounded to bf16, as the TPU
    kernel's one-hot fetch does (:196-201); larger levels read it in f32.
    Trilinear weights and sums are f32, the corners summed in order."""
    tracing.counts["brick_encode_reference.calls"] += 1
    bid = compute_brick_ids(layout, x)
    feats = []
    for level, (res, bf16) in enumerate(zip(layout.scales,
                                            _bf16_levels(layout))):
        rows = table[layout.offsets[level] + bid[:, level]]      # (N, 256)
        if bf16:
            rows = _round_bf16(rows)
        loc, frac = level_geometry(x, res)
        f0 = f1 = torch.zeros_like(x[:, 0])
        for dx, dy, dz in corners():
            v, w = corner_lane_weight(loc, frac, dx, dy, dz)
            f0 = f0 + w * rows.gather(1, v[:, None])[:, 0]
            f1 = f1 + w * rows.gather(1, (128 + v)[:, None])[:, 0]
        feats += [f0, f1]
    return torch.stack(feats, dim=-1)


def _corner_updates(layout: BrickLayout, x: torch.Tensor, g: torch.Tensor):
    """Every (flat table index (N,), contribution (N,) f32) pair of the
    table gradient: per level, corner and feature ``w * g``, rounded to
    bf16 on the levels that take the bf16 branch."""
    bid = compute_brick_ids(layout, x)
    for level, (res, bf16) in enumerate(zip(layout.scales,
                                            _bf16_levels(layout))):
        base = (layout.offsets[level] + bid[:, level]) * ROW
        loc, frac = level_geometry(x, res)
        for dx, dy, dz in corners():
            v, w = corner_lane_weight(loc, frac, dx, dy, dz)
            for f in range(2):
                c = w * g[:, 2 * level + f]
                yield base + 128 * f + v, (_round_bf16(c) if bf16 else c)


def brick_encode_bwd_reference(layout: BrickLayout, x: torch.Tensor,
                               g: torch.Tensor,
                               sum_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """x (N, 3) in [0,1], g (N, 2L) f32 -> dtable (n_rows, 256): the table
    gradient of ``brick_hash_encode`` (``_bwd_kernel`` :216-265) in plain
    PyTorch. Per level and corner the contribution ``w * g`` is f32, then
    rounded to bf16 where the level has at most ``MXU_MAX_ROWS`` rows (the
    TPU kernel casts the point's contribution row to bf16 for its one-hot
    matmul; a point's 8 corners fall on 8 different lanes, so rounding per
    corner is the same); the contributions are summed with ``index_add_``
    in ``sum_dtype`` (f32 as the TPU kernel; f64 for an order-free
    yardstick). Padding lanes and rows stay exactly zero."""
    tracing.counts["brick_encode_bwd_reference.calls"] += 1
    g = g.float()
    dtable = torch.zeros(layout.n_rows * ROW, dtype=sum_dtype,
                         device=x.device)
    for index, c in _corner_updates(layout, x, g):
        dtable.index_add_(0, index, c.to(sum_dtype))
    return dtable.view(layout.n_rows, ROW)


def live_entries(layout: BrickLayout) -> torch.Tensor:
    """(n_rows, 256) bool: the table entries a point can reach. False on
    the padding: lanes 125-127 and 253-255 of every row, and the rows that
    round a level up to a multiple of 128 (beyond its bricks, or beyond
    its hash range)."""
    live = torch.zeros(layout.n_rows, ROW, dtype=torch.bool)
    for level, bside in enumerate(layout.bsides):
        used = (hash_range(layout, level) if layout.use_hash[level]
                else bside ** 3)
        rows = slice(layout.offsets[level], layout.offsets[level] + used)
        live[rows, :BV] = True
        live[rows, 128:128 + BV] = True
    return live


def touched_entries(layout: BrickLayout, x: torch.Tensor) -> int:
    """How many different table entries the encode of ``x`` reads (and its
    gradient writes): what a kernel's bound counts as table bytes."""
    seen = torch.zeros(layout.n_rows * ROW, dtype=torch.bool, device=x.device)
    for index, _ in _corner_updates(layout, x, torch.zeros(
            x.shape[0], 2 * len(layout.scales), device=x.device)):
        seen[index] = True
    return int(seen.sum())


def encode_flops_per_point(layout: BrickLayout) -> int:
    """f32 multiplies and adds of the encode, and of its table gradient,
    per point: per level and axis the position, the fraction and 1 -
    fraction; per corner two weight products and a multiply and an add for
    each feature."""
    return len(layout.scales) * (3 * 3 + 8 * 6)


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
    lib = _build.load("brick_hash_encode")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.brick_hash_encode_fwd.argtypes = [ptr, ptr, ptr, i32, ptr, i32,
                                          ctypes.c_uint32, ptr]
    lib.brick_hash_encode_bwd.argtypes = [ptr, ptr, i64, i64, ptr, i64, i32,
                                          ptr, i32, ctypes.c_uint32, ptr]
    lib.brick_hash_encode_fwd.restype = lib.brick_hash_encode_bwd.restype = i32
    return lib


def build() -> None:
    """Build and load the kernels now, so that a failed build raises here."""
    _kernel()


def _bf16_mask(layout: BrickLayout) -> int:
    return sum(1 << level for level, bf16 in enumerate(_bf16_levels(layout))
               if bf16)


def brick_hash_encode(layout: BrickLayout, table: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], table (n_rows, 256) f32 (the parameter itself, no
    repack) -> (N, 2L) f32 features ``[f0, f1]`` per level: the training
    forward. CUDA tensors launch the kernel; CPU tensors take the plain
    version. Not differentiable by itself: :class:`BrickHashEncodeFn`."""
    if x.device.type == "cpu":
        return brick_encode_reference(layout, table, x)
    if x.device.type != "cuda":
        raise ValueError(f"brick_hash_encode: unsupported device {x.device}")
    n = check_points(x)
    if table.dtype != torch.float32 or tuple(table.shape) != (
            layout.n_rows, ROW) or not table.is_contiguous() \
            or table.device != x.device:
        raise ValueError(f"brick_hash_encode: the table must be a contiguous "
                         f"float32 ({layout.n_rows}, {ROW}) tensor on "
                         f"{x.device}")
    levels = kernel_levels(layout)
    out = torch.empty((n, 2 * len(layout.scales)), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.brick_hash_encode_fwd(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            ctypes.byref(levels), len(layout.scales), _bf16_mask(layout),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "brick_hash_encode")
    tracing.counts["brick_hash_encode.launches"] += 1
    return out


def brick_hash_encode_bwd(layout: BrickLayout, x: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], g (N, 2L) f32 of any strides -> dtable (n_rows,
    256) f32, the table gradient of :func:`brick_hash_encode`. CUDA tensors
    launch the kernel (it zeroes the table, then adds with ``atomicAdd``:
    f32 sums in an order that differs from run to run); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return brick_encode_bwd_reference(layout, x, g)
    if x.device.type != "cuda":
        raise ValueError(f"brick_hash_encode_bwd: unsupported device "
                         f"{x.device}")
    n = check_points(x)
    n_feat = 2 * len(layout.scales)
    if g.dtype != torch.float32 or tuple(g.shape) != (n, n_feat) \
            or g.device != x.device:
        raise ValueError(f"brick_hash_encode_bwd: g must be a float32 "
                         f"({n}, {n_feat}) tensor on {x.device}")
    levels = kernel_levels(layout)
    dtable = torch.empty((layout.n_rows, ROW), dtype=torch.float32,
                         device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.brick_hash_encode_bwd(
            x.data_ptr(), g.data_ptr(), g.stride(0), g.stride(1),
            dtable.data_ptr(), dtable.numel(), n, ctypes.byref(levels),
            len(layout.scales), _bf16_mask(layout),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "brick_hash_encode_bwd")
    tracing.counts["brick_hash_encode_bwd.launches"] += 1
    return dtable


class BrickHashEncodeFn(torch.autograd.Function):
    """``brick_hash_encode`` with its table gradient, the counterpart of
    the ``custom_vjp`` (:291-354): ``apply(layout, table, x)``. The
    gradient to ``x`` is None (the JAX package returns zeros: the brick
    backend has ``input_grad=False``)."""

    @staticmethod
    def forward(ctx, layout, table, x):
        ctx.layout = layout
        ctx.save_for_backward(x)
        return brick_hash_encode(layout, table, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return None, brick_hash_encode_bwd(ctx.layout, x, g), None


__all__ = ["BRICK", "BW", "BV", "ROW", "MXU_MAX_ROWS", "MAX_LEVELS",
           "BrickLayout", "BrickHashEncodeFn", "Levels", "make_brick_layout",
           "compute_brick_ids", "brick_encode_reference",
           "brick_encode_bwd_reference", "brick_hash_encode",
           "brick_hash_encode_bwd", "build", "check_points",
           "encode_flops_per_point", "kernel_levels", "level_rows",
           "live_entries",
           "hash_range", "touched_entries"]
