"""Fused brick encode + NGP MLP eval: the CUDA kernel, its wrapper and its
plain PyTorch version, in the TPU kernel's two arms.

Replaces the TPU Pallas kernel of ``fused_ngp_eval``
(nerf_replication_tpu/ops/pallas/fused_ngp.py:258): one pass per point
through the multi-level brick encode (csrc/brick_encode.cuh, shared with
eval_encode.py) and the whole NGP MLP, so that features and activations
never leave the chip. Up to 16 levels (32 encoded features), as the TPU
kernel's ``8 * L <= 128``.

- The f32 arm (default) is the TPU kernel's ``precision=HIGHEST``. The
  kernel multiplies in 3xTF32 on the tensor cores (each operand split into
  two TF32 parts, three products summed in f32), which keeps f32's
  accuracy where one TF32 product would keep three digits
  (:func:`matmul_3xtf32` emulates it in PyTorch). The plain version
  multiplies in f32 and must not run in TF32
  (``torch.backends.cuda.matmul.allow_tf32`` False).
- The bf16 arm (``mlp_bf16=True``, reference ``fused_ngp.py:165-171``):
  every weight and bias rounded to bf16, every activation, feature and SH
  operand rounded to bf16 before its product, f32 accumulation. Its plain
  version multiplies the rounded operands in f32, so each product is
  exact, as on the tensor cores.

What bounds it: about 36 kFLOP a point for the hard_ngp MLP (D=3, W=64)
against 92 bytes of input and output, so the tensor cores (three TF32
products a multiply-add on the f32 arm) and, beside them, the encode's
table gathers. Each block stages one branch's weight image in shared
memory once; a warp runs 32 points at a time through the MLP on
``mma.sync`` tiles with its activations in registers; see
csrc/fused_ngp.cu.

As in the TPU kernel, the skip concat ``[x, h]`` and the view concat
``[feature, sh]`` are split matmuls. :func:`extract_mlp_weights` gives
JAX's operands (kernels (in, out), biases (1, out)); the plain versions read
one flat f32 pack of them (:func:`pack_mlp_weights`) and the kernel reads
an image of that pack for its arm (:func:`weight_image`: the matrices as
tensor-core fragments), so the CPU tests check both.
``combined_gather`` (a Mosaic layout choice) is not part of the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import tracing
from . import _build
from .eval_encode import _bf16_bits, _encode_plain, check_table
from .hashgrid_kernel import (
    BrickLayout,
    _round_bf16,
    check_points,
    encode_flops_per_point,
    kernel_levels,
)

# what the CUDA kernel covers (csrc/fused_ngp.cu)
KERNEL_WIDTH = 64
KERNEL_SH = 16
KERNEL_FEATS = 32          # the kernel's x rows: up to 16 levels x 2
RGB_COLS = 4               # RGB head columns, padded
BIAS1_PAD = 4              # the density head's single bias, padded
KERNEL_WARPS, TILE = 8, 32           # warps a block, points a warp's tile
SMEM_LIMIT = 232_448                 # dynamic shared memory a block may use
# the K-row order, within each block of 8, of a matrix that reads an
# activation on the f32 arm: accumulator columns 2t, 2t + 1 are A-fragment
# columns t, t + 4
TF32_ROWS = (0, 2, 4, 6, 1, 3, 5, 7)


@dataclasses.dataclass(frozen=True)
class MLPOps:
    """One branch's weights: ``ops``, JAX's operands in its kernel order;
    ``flat``, the pack the plain versions read; ``image`` and
    ``image_bf16``, the kernel's weight images of its two arms (None where
    the kernel does not cover the MLP)."""

    ops: tuple
    flat: torch.Tensor
    width: int
    n_feat: int
    n_sh: int
    image: torch.Tensor | None = None
    image_bf16: torch.Tensor | None = None


def feat_pad(n_feat: int) -> int:
    """Rows the pack gives the encoded features: 24 (12 levels) or 32 (16),
    the kernel's two sizes; a multiple of 8 for a wider encode (the plain
    version only)."""
    return max(24, -(-n_feat // 8) * 8)


def mlp_meta(depth: int, skips) -> tuple:
    """``(trunk kinds, head_split)``: trunk layer i is "split" when it
    reads ``[x, h]`` (a skip after layer i - 1); the heads read ``[x, h]``
    when the last layer skips."""
    trunk = tuple("split" if i > 0 and (i - 1) in skips else "plain"
                  for i in range(depth))
    return trunk, (depth - 1) in skips


def extract_mlp_weights(state: dict, n_feat: int, depth: int, skips,
                        view_depth: int):
    """A NeRFMLP state_dict (``nn.Linear`` weights (out, in)) -> (MLPOps,
    meta), as nerf_replication_tpu/ops/pallas/fused_ngp.py:58-96: the
    layer after a skip is split at the concat boundary (``k[:n_feat]`` for
    x, which comes first), ``views.0`` at the feature width, then SH.
    ``meta`` is ``(trunk kinds, head_split)``."""
    if view_depth != 1:
        raise ValueError("fused NGP eval supports view_depth == 1")

    def kernel(name):
        return state[f"{name}.weight"].detach().float().t().contiguous()

    def bias(name):
        return state[f"{name}.bias"].detach().float()[None]

    meta = mlp_meta(depth, skips)
    trunk, head_split = meta
    ops = []
    for i, kind in enumerate(trunk):
        k = kernel(f"pts.{i}")
        ops += ([k[:n_feat], k[n_feat:]] if kind == "split" else [k]) \
            + [bias(f"pts.{i}")]
    for name in ("alpha", "feature"):
        k = kernel(name)
        ops += ([k[:n_feat], k[n_feat:]] if head_split else [k]) + [bias(name)]
    width = state["feature.weight"].shape[0]
    kv = kernel("views.0")
    ops += [kv[:width], kv[width:], bias("views.0"), kernel("rgb"),
            bias("rgb")]
    n_sh = kv.shape[0] - width
    flat = pack_mlp_weights(ops, meta, n_feat)
    images = {}
    if unsupported_mlp(width, n_feat, n_sh, depth, view_depth, skips) is None:
        images = {"image": weight_image(flat, meta, n_feat, False),
                  "image_bf16": weight_image(flat, meta, n_feat, True)}
    return MLPOps(tuple(ops), flat, width, n_feat, n_sh, **images), meta


def pack_mlp_weights(ops, meta, n_feat: int) -> torch.Tensor:
    """JAX-order operands -> one flat f32 pack in the kernel's order
    (:func:`pack_segments`): every matrix (in, out) row-major, its bias
    after it; x rows padded with zeros to :func:`feat_pad`; the density
    head as a vector and its bias padded to 4; the RGB head's columns and
    bias padded to 4."""
    width, n_sh = ops[-5].shape[0], ops[-4].shape[0]
    segs = pack_segments(meta, n_feat, width, n_sh)
    return torch.cat([
        torch.nn.functional.pad(
            op, (0, cols - op.shape[1], 0, rows - op.shape[0])).reshape(-1)
        for op, (rows, cols, _) in zip(ops, segs, strict=True)]).contiguous()


def pack_segments(meta, n_feat: int, width: int = KERNEL_WIDTH,
                  n_sh: int = KERNEL_SH) -> list:
    """The pack's parts in order, one for each of JAX's operands,
    ``(rows, cols, reads)``: ``reads`` is what a matrix that the tensor
    cores multiply reads ("x", the encoded features; "h", an activation;
    "sh"), None for a vector (biases and the two heads, which the kernel
    sums in f32 on the CUDA cores). The view layer is ``width // 2`` wide,
    as in NeRFMLP."""
    trunk, head_split = meta
    pad_x, views = feat_pad(n_feat), width // 2
    segs = []
    for i, kind in enumerate(trunk):
        if i == 0 or kind == "split":
            segs.append((pad_x, width, "x"))
        if i > 0:
            segs.append((width, width, "h"))
        segs.append((1, width, None))
    segs += [(pad_x, 1, None)] if head_split else []
    segs += [(width, 1, None), (1, BIAS1_PAD, None)]
    segs += [(pad_x, width, "x")] if head_split else []
    segs += [(width, width, "h"), (1, width, None),
             (width, views, "h"), (n_sh, views, "sh"), (1, views, None),
             (views, RGB_COLS, None), (1, RGB_COLS, None)]
    return segs


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fragment_index(k: int, n: int, step: int, device):
    """(rows base (k / step, 1, 1), columns (1, n / 8, 32), t (32,)) of
    the B fragments of a (k, n) matrix, per K block, n-tile and lane."""
    lane = torch.arange(32, device=device)
    rows = torch.arange(0, k, step, device=device)[:, None, None]
    cols = torch.arange(0, n, 8, device=device)[None, :, None] + lane // 4
    return rows, cols, lane % 4


def _tf32_fragments(m: torch.Tensor, permute: bool) -> torch.Tensor:
    """(k, n) f32 -> the f32 arm's fragments: [k / 8][n / 8][lane] of
    (big(b0), big(b1), small(b0), small(b1)), b0 at K row t and b1 at t + 4
    of the block, in :data:`TF32_ROWS` order where ``permute``."""
    rows, cols, t = _fragment_index(*m.shape, 8, m.device)
    order = torch.tensor(TF32_ROWS if permute else range(8), device=m.device)
    v0, v1 = m[rows + order[t], cols], m[rows + order[t + 4], cols]
    b0, b1 = _tf32(v0), _tf32(v1)
    return torch.stack([b0, b1, _tf32(v0 - b0), _tf32(v1 - b1)],
                       dim=-1).reshape(-1)


def _bf16_fragments(m: torch.Tensor) -> torch.Tensor:
    """(k, n) f32 -> the bf16 arm's fragments, K padded with zeros to a
    multiple of 16: [k / 16][n / 16][lane] of (b0, b1 of n-tile 2j, b0, b1
    of n-tile 2j + 1), each a word of two bf16 (K rows 2t, 2t + 1 for b0,
    2t + 8, 2t + 9 for b1; the lower row in the low half). Words are
    returned as f32 bit patterns."""
    k, n = m.shape
    m = torch.nn.functional.pad(m, (0, 0, 0, -(-k // 16) * 16 - k))
    bits = _bf16_bits(m)
    rows, cols, t = _fragment_index(*m.shape, 16, m.device)

    def word(r):
        return bits[rows + r, cols] | (bits[rows + r + 1, cols] << 16)

    w = torch.stack([word(2 * t), word(2 * t + 8)], dim=-1)
    w = w.view(w.shape[0], n // 16, 2, 32, 2).permute(0, 1, 3, 2, 4)
    return w.reshape(-1).to(torch.int32).view(torch.float32)


def weight_image(flat: torch.Tensor, meta, n_feat: int,
                 mlp_bf16: bool) -> torch.Tensor:
    """The kernel's weight image of an arm (csrc/fused_ngp.cu), 32-bit
    words in the pack's order: each matrix as its arm's fragments (TF32
    rows permuted where it reads an activation), each vector as it is (f32
    arm) or rounded to bf16 (bf16 arm)."""
    parts, at = [], 0
    for rows, cols, reads in pack_segments(meta, n_feat):
        seg = flat[at:at + rows * cols].view(rows, cols)
        at += rows * cols
        if reads is None:
            parts.append((_round_bf16(seg) if mlp_bf16 else seg).reshape(-1))
        elif mlp_bf16:
            parts.append(_bf16_fragments(seg))
        else:
            parts.append(_tf32_fragments(seg, reads == "h"))
    if at != flat.numel():
        raise ValueError(f"fused NGP pack: read {at} of {flat.numel()} floats")
    return torch.cat(parts).contiguous()


def shared_memory_bytes(meta, n_feat: int, mlp_bf16: bool = False) -> int:
    """The kernel's dynamic shared memory for an MLP: its weight image and
    each warp's tile of points (features, SH, 4 words of padding)."""
    words = 0
    for rows, cols, reads in pack_segments(meta, n_feat):
        if reads is None:
            words += rows * cols
        else:
            words += (-(-rows // 16) * 16 * cols // 2 if mlp_bf16
                      else 2 * rows * cols)
    x_cols = 32 if mlp_bf16 else feat_pad(n_feat)
    return 4 * (words + KERNEL_WARPS * TILE * (x_cols + KERNEL_SH + 4))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every product of the plain MLP, in one place so that chip_smoke.py
    and the tests can swap in another precision (a control, or
    :func:`matmul_3xtf32`)."""
    return a @ b


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 arm's products as the kernel forms them, in f32 PyTorch
    (TF32 rounding by bit masks; every product of two TF32 values is exact
    in f32): ``small(a) . big(b) + big(a) . small(b)``, then ``+ big(a) .
    big(b)``."""
    a_big, b_big = _tf32(a), _tf32(b)
    return (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big)) \
        + a_big @ b_big


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, the control of :func:`matmul_3xtf32`."""
    return _tf32(a) @ _tf32(b)


def _round_bias(b: torch.Tensor) -> torch.Tensor:
    """A bias of the bf16 arm: rounded to bf16, as the TPU kernel's
    ``nxt()`` casts every operand it loads, biases too (in one place, so
    that a test's control can leave the biases in f32)."""
    return _round_bf16(b)


def _mlp_plain(w: MLPOps, meta, x: torch.Tensor, sh: torch.Tensor,
               mlp_bf16: bool = False):
    """The kernel's MLP on its pack (csrc/fused_ngp.cu, same order of
    terms): each layer sums x's part, then h's, then adds its bias. With
    ``mlp_bf16`` every operand of every product, and every bias, is rounded
    to bf16 first (the products of the rounded values are exact in f32)."""
    trunk, head_split = meta
    flat, width = w.flat, w.width
    views = w.ops[-2].shape[0]              # the RGB head's input width
    pad_x = feat_pad(w.n_feat)
    xp = torch.nn.functional.pad(x, (0, pad_x - x.shape[1]))
    rnd = _round_bf16 if mlp_bf16 else (lambda t: t)
    at = 0

    def mm(a, b):
        return _matmul(rnd(a), rnd(b))

    def take(rows, cols):
        nonlocal at
        m = flat[at:at + rows * cols].view(rows, cols)
        at += rows * cols
        return m

    def bias(cols):
        return _round_bias(take(1, cols)) if mlp_bf16 else take(1, cols)

    h = None
    for i, kind in enumerate(trunk):
        acc = mm(xp, take(pad_x, width)) if kind == "split" or i == 0 else 0.0
        if i > 0:
            acc = acc + mm(h, take(width, width))
        h = torch.relu(acc + bias(width))
    sigma = mm(xp, take(pad_x, 1)) if head_split else 0.0
    sigma = sigma + mm(h, take(width, 1)) + bias(BIAS1_PAD)[:, :1]
    feat = mm(xp, take(pad_x, width)) if head_split else 0.0
    feat = feat + mm(h, take(width, width)) + bias(width)
    g = mm(feat, take(width, views)) + mm(sh, take(w.n_sh, views))
    g = torch.relu(g + bias(views))
    rgb = mm(g, take(views, RGB_COLS)) + bias(RGB_COLS)
    if at != flat.numel():
        raise ValueError(f"fused NGP pack: read {at} of {flat.numel()} floats")
    return torch.cat([rgb[:, :3], sigma], dim=-1)


def fused_ngp_eval_reference(layout: BrickLayout, meta, packed_table,
                             weight_ops: MLPOps, x: torch.Tensor,
                             sh: torch.Tensor,
                             mlp_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the eval encode's plain
    arithmetic, then the MLP on the pack, in f32 or on bf16 operands."""
    tracing.counts["fused_ngp_eval_reference.calls"] += 1
    feat = _encode_plain(layout, packed_table, x.float())
    return _mlp_plain(weight_ops, meta, feat, sh.float(), mlp_bf16)


def unsupported_mlp(width: int, n_feat: int, n_sh: int, depth: int,
                    view_depth: int, skips=()) -> str | None:
    """What of an MLP the CUDA kernel does not cover, or None."""
    if width != KERNEL_WIDTH:
        return f"width {width} (the kernel takes {KERNEL_WIDTH})"
    if n_feat > KERNEL_FEATS:
        return (f"{n_feat} encoded features (the kernel takes at most "
                f"{KERNEL_FEATS})")
    if n_sh != KERNEL_SH:
        return f"{n_sh} direction features (the kernel takes {KERNEL_SH})"
    if view_depth != 1:
        return f"view_depth {view_depth} (the kernel takes 1)"
    if not 1 <= depth <= 32:
        return f"depth {depth} (the kernel takes 1 to 32)"
    smem = shared_memory_bytes(mlp_meta(depth, skips), n_feat)
    if smem > SMEM_LIMIT:
        return (f"depth {depth} with skips {list(skips)} (its weights and "
                f"tiles need {smem} B of shared memory, over {SMEM_LIMIT})")
    return None


def _split_mask(meta) -> int:
    """Bit i - 1 set when trunk layer i reads ``[x, h]``."""
    return sum(1 << (i - 1) for i, kind in enumerate(meta[0])
               if i > 0 and kind == "split")


@functools.cache
def _kernel():
    lib = _build.load("fused_ngp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ngp_eval.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, ptr,
                                   i32, i32, i32, ctypes.c_uint, i32, i32,
                                   ptr]
    lib.fused_ngp_eval.restype = i32
    return lib


def build() -> None:
    """Build and load the kernel now, so that a failed build raises here."""
    _kernel()


def fused_ngp_eval(layout: BrickLayout, meta, packed_table: torch.Tensor,
                   weight_ops: MLPOps, x: torch.Tensor, sh: torch.Tensor,
                   mlp_bf16: bool = False) -> torch.Tensor:
    """x (N, 3) in [0,1], sh (N, n_sh) per-point direction features,
    packed_table (n_rows, 128) int32, ``weight_ops`` from
    :func:`extract_mlp_weights` -> raw (N, 4) f32 ``[rgb, sigma]``; with
    ``mlp_bf16`` the MLP on bf16 operands (the TPU kernel's second arm).

    CUDA tensors launch the kernel (``tracing.counts`` keeps the f32 arm's
    under ``"fused_ngp_eval.launches"``, the bf16 arm's under
    ``"fused_ngp_eval.bf16_launches"``); CPU tensors take the plain
    version.
    """
    if x.device.type == "cpu":
        return fused_ngp_eval_reference(layout, meta, packed_table,
                                        weight_ops, x, sh, mlp_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ngp_eval: unsupported device {x.device}")
    n = check_points(x)
    check_table(layout, packed_table, x.device)
    n_feat = 2 * len(layout.scales)
    image = weight_ops.image_bf16 if mlp_bf16 else weight_ops.image
    reason = unsupported_mlp(weight_ops.width, n_feat, weight_ops.n_sh,
                             len(meta[0]), 1)
    if reason is None and weight_ops.n_feat != n_feat:
        reason = f"weights made for {weight_ops.n_feat} encoded features"
    if reason is None and image is None:
        reason = ("these weights: extract_mlp_weights made no kernel image "
                  "for them (unsupported_mlp with their skips says why)")
    if reason is not None:
        raise ValueError(f"fused_ngp_eval: the kernel does not cover {reason}")
    if sh.dtype != torch.float32 or tuple(sh.shape) != (n, KERNEL_SH) \
            or not sh.is_contiguous() or sh.device != x.device \
            or sh.data_ptr() % 16:
        raise ValueError(f"fused_ngp_eval: sh must be a 16-byte aligned "
                         f"contiguous float32 ({n}, {KERNEL_SH}) tensor on "
                         f"{x.device}")
    if image.dtype != torch.float32 or image.dim() != 1 \
            or not image.is_contiguous() or image.device != x.device \
            or image.numel() % 4 or image.data_ptr() % 16:
        raise ValueError("fused_ngp_eval: the weight image must be a "
                         f"16-byte aligned contiguous 32-bit vector on "
                         f"{x.device}")
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.fused_ngp_eval(
            x.data_ptr(), sh.data_ptr(), out.data_ptr(), n,
            packed_table.data_ptr(), ctypes.byref(kernel_levels(layout)),
            len(layout.scales), image.data_ptr(), image.numel(),
            feat_pad(n_feat), len(meta[0]), _split_mask(meta), int(meta[1]),
            int(mlp_bf16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "fused_ngp_eval")
    if mlp_bf16:
        tracing.counts["fused_ngp_eval.bf16_launches"] += 1
    else:
        tracing.counts["fused_ngp_eval.launches"] += 1
    return out


def flops_per_point(layout: BrickLayout, weight_ops: MLPOps) -> int:
    """f32 operations of one point: the encode's, then 2 per multiply-add
    of the MLP's unpadded matrices (JAX's operands)."""
    return encode_flops_per_point(layout) + mlp_flops_per_point(weight_ops)


def mlp_flops_per_point(weight_ops: MLPOps) -> int:
    """2 per multiply-add of the MLP's unpadded matrices."""
    return 2 * sum(t.shape[0] * t.shape[1] for t in weight_ops.ops
                   if t.shape[0] > 1)


__all__ = ["MLPOps", "extract_mlp_weights", "pack_mlp_weights",
           "pack_segments", "weight_image", "shared_memory_bytes",
           "matmul_3xtf32", "matmul_tf32", "fused_ngp_eval",
           "fused_ngp_eval_reference", "unsupported_mlp", "build",
           "flops_per_point", "mlp_flops_per_point"]
