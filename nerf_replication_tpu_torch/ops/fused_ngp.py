"""Fused brick encode + NGP MLP eval: the CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces the TPU Pallas kernel of ``fused_ngp_eval``
(nerf_replication_tpu/ops/pallas/fused_ngp.py:258): one pass per point
through the multi-level brick encode (csrc/brick_encode.cuh, shared with
eval_encode.py) and the whole NGP MLP, so that features and activations
never leave the chip. The MLP is float32 throughout, as the TPU kernel's
``precision=HIGHEST``: the kernel multiplies on the CUDA cores with
``fmaf`` (TF32 would keep about three digits, bf16 tensor cores would
change the function), and the plain version's products must not run in
TF32 (``torch.backends.cuda.matmul.allow_tf32`` False).

What bounds it: about 36 kFLOP a point for the hard_ngp MLP (D=3, W=64)
against 92 bytes of input and output, so the f32 rate of the CUDA cores
(67 TFLOP/s on an H100 SXM). Each block stages one branch's weights
(~73.6 KB of f32) once in shared memory and walks over points, one point
a thread with its activations in registers; see csrc/fused_ngp.cu.

As in the TPU kernel, the skip concat ``[x, h]`` and the view concat
``[feature, sh]`` are split matmuls. :func:`extract_mlp_weights` gives
JAX's operands (kernels (in, out), biases (1, out)); the kernel and the
plain version read one flat f32 pack of them (:func:`pack_mlp_weights`),
so the CPU tests check the pack too.
``mlp_bf16`` (the TPU's bf16 MLP for the frame path) and
``combined_gather`` (a Mosaic layout choice) are not part of the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .eval_encode import _encode_plain, check_table
from .hashgrid_kernel import (
    BrickLayout,
    check_points,
    encode_flops_per_point,
    kernel_levels,
)

# what the CUDA kernel covers (csrc/fused_ngp.cu)
KERNEL_WIDTH = 64
KERNEL_SH = 16
KERNEL_FEATS = 24          # the kernel's x rows: up to 12 levels x 2
RGB_COLS = 4               # RGB head columns, padded
BIAS1_PAD = 4              # the density head's single bias, padded


@dataclasses.dataclass(frozen=True)
class MLPOps:
    """One branch's weights: ``ops``, JAX's operands in its kernel order,
    and ``flat``, the pack the CUDA kernel and the plain version read."""

    ops: tuple
    flat: torch.Tensor
    width: int
    n_feat: int
    n_sh: int


def feat_pad(n_feat: int) -> int:
    """Rows the pack gives the encoded features: the kernel's width, or a
    multiple of 4 for a wider encode (the plain version only)."""
    return max(KERNEL_FEATS, -(-n_feat // 4) * 4)


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

    ops, trunk = [], []
    for i in range(depth):
        k = kernel(f"pts.{i}")
        if i > 0 and (i - 1) in skips:
            ops += [k[:n_feat], k[n_feat:], bias(f"pts.{i}")]
            trunk.append("split")
        else:
            ops += [k, bias(f"pts.{i}")]
            trunk.append("plain")
    head_split = (depth - 1) in skips
    for name in ("alpha", "feature"):
        k = kernel(name)
        ops += ([k[:n_feat], k[n_feat:]] if head_split else [k]) + [bias(name)]
    width = state["feature.weight"].shape[0]
    kv = kernel("views.0")
    ops += [kv[:width], kv[width:], bias("views.0"), kernel("rgb"),
            bias("rgb")]
    meta = (tuple(trunk), head_split)
    n_sh = kv.shape[0] - width
    flat = pack_mlp_weights(ops, meta, n_feat)
    return MLPOps(tuple(ops), flat, width, n_feat, n_sh), meta


def pack_mlp_weights(ops, meta, n_feat: int) -> torch.Tensor:
    """JAX-order operands -> one flat f32 pack in the kernel's order: every
    matrix (in, out) row-major, its bias after it; x rows padded with
    zeros to :func:`feat_pad`; the density head as a vector and its bias
    padded to 4; the RGB head's columns and bias padded to 4."""
    trunk, head_split = meta
    pad_x = feat_pad(n_feat)
    it = iter(ops)
    parts = []

    def x_rows(k):
        return torch.nn.functional.pad(k, (0, 0, 0, pad_x - k.shape[0]))

    for i, kind in enumerate(trunk):
        if i == 0:                                # reads x alone
            parts.append(x_rows(next(it)))
        elif kind == "split":                     # reads [x, h]
            parts += [x_rows(next(it)), next(it)]
        else:
            parts.append(next(it))
        parts.append(next(it))                                 # bias
    for cols in (1, None):                                     # alpha, feature
        if head_split:
            parts.append(x_rows(next(it)))
        parts.append(next(it))
        b = next(it)
        parts.append(torch.nn.functional.pad(b, (0, BIAS1_PAD - 1))
                     if cols == 1 else b)
    parts += [next(it), next(it), next(it)]                    # views
    parts += [torch.nn.functional.pad(next(it), (0, RGB_COLS - 3)),
              torch.nn.functional.pad(next(it), (0, RGB_COLS - 3))]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every product of the plain MLP, in one place so that chip_smoke.py
    can swap in a lower-precision one for its controls."""
    return a @ b


def _mlp_plain(w: MLPOps, meta, x: torch.Tensor, sh: torch.Tensor):
    """The kernel's MLP on its pack (csrc/fused_ngp.cu, same order of
    terms): each layer sums x's part, then h's, then adds its bias."""
    trunk, head_split = meta
    flat, width = w.flat, w.width
    views = w.ops[-2].shape[0]              # the RGB head's input width
    pad_x = feat_pad(w.n_feat)
    xp = torch.nn.functional.pad(x, (0, pad_x - x.shape[1]))
    at = 0

    def take(rows, cols):
        nonlocal at
        m = flat[at:at + rows * cols].view(rows, cols)
        at += rows * cols
        return m

    h = None
    for i, kind in enumerate(trunk):
        acc = _matmul(xp, take(pad_x, width)) if kind == "split" or i == 0 \
            else 0.0
        if i > 0:
            acc = acc + _matmul(h, take(width, width))
        h = torch.relu(acc + take(1, width))
    sigma = _matmul(xp, take(pad_x, 1)) if head_split else 0.0
    sigma = sigma + _matmul(h, take(width, 1)) + take(1, BIAS1_PAD)[:, :1]
    feat = _matmul(xp, take(pad_x, width)) if head_split else 0.0
    feat = feat + _matmul(h, take(width, width)) + take(1, width)
    g = _matmul(feat, take(width, views)) + _matmul(sh, take(w.n_sh, views))
    g = torch.relu(g + take(1, views))
    rgb = _matmul(g, take(views, RGB_COLS)) + take(1, RGB_COLS)
    if at != flat.numel():
        raise ValueError(f"fused NGP pack: read {at} of {flat.numel()} floats")
    return torch.cat([rgb[:, :3], sigma], dim=-1)


def fused_ngp_eval_reference(layout: BrickLayout, meta, packed_table,
                             weight_ops: MLPOps, x: torch.Tensor,
                             sh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the eval encode's plain
    arithmetic, then the MLP in f32 on the kernel's pack."""
    fused_ngp_eval_reference.calls += 1
    feat = _encode_plain(layout, packed_table, x.float())
    return _mlp_plain(weight_ops, meta, feat, sh.float())


fused_ngp_eval_reference.calls = 0


def unsupported_mlp(width: int, n_feat: int, n_sh: int, depth: int,
                    view_depth: int) -> str | None:
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
                                   i32, i32, i32, ctypes.c_uint, i32, ptr]
    lib.fused_ngp_eval.restype = i32
    return lib


def build() -> None:
    """Build and load the kernel now, so that a failed build raises here."""
    _kernel()


def fused_ngp_eval(layout: BrickLayout, meta, packed_table: torch.Tensor,
                   weight_ops: MLPOps, x: torch.Tensor,
                   sh: torch.Tensor) -> torch.Tensor:
    """x (N, 3) in [0,1], sh (N, n_sh) per-point direction features,
    packed_table (n_rows, 128) int32, ``weight_ops`` from
    :func:`extract_mlp_weights` -> raw (N, 4) f32 ``[rgb, sigma]``.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_ngp_eval_reference(layout, meta, packed_table,
                                        weight_ops, x, sh)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ngp_eval: unsupported device {x.device}")
    n = check_points(x)
    check_table(layout, packed_table, x.device)
    n_feat = 2 * len(layout.scales)
    reason = unsupported_mlp(weight_ops.width, n_feat, weight_ops.n_sh,
                             len(meta[0]), 1)
    if reason is None and weight_ops.n_feat != n_feat:
        reason = f"weights made for {weight_ops.n_feat} encoded features"
    if reason is not None:
        raise ValueError(f"fused_ngp_eval: the kernel does not cover {reason}")
    if sh.dtype != torch.float32 or tuple(sh.shape) != (n, KERNEL_SH) \
            or not sh.is_contiguous() or sh.device != x.device \
            or sh.data_ptr() % 16:
        raise ValueError(f"fused_ngp_eval: sh must be a 16-byte aligned "
                         f"contiguous float32 ({n}, {KERNEL_SH}) tensor on "
                         f"{x.device}")
    flat = weight_ops.flat
    if flat.dtype != torch.float32 or flat.dim() != 1 \
            or not flat.is_contiguous() or flat.device != x.device \
            or flat.numel() % 4 or flat.data_ptr() % 16:
        raise ValueError("fused_ngp_eval: the weight pack must be a "
                         f"16-byte aligned contiguous float32 vector on "
                         f"{x.device}")
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.fused_ngp_eval(
            x.data_ptr(), sh.data_ptr(), out.data_ptr(), n,
            packed_table.data_ptr(), ctypes.byref(kernel_levels(layout)),
            len(layout.scales), flat.data_ptr(), flat.numel(),
            KERNEL_FEATS, len(meta[0]), _split_mask(meta), int(meta[1]),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "fused_ngp_eval")
    fused_ngp_eval.launches += 1
    return out


fused_ngp_eval.launches = 0


def flops_per_point(layout: BrickLayout, weight_ops: MLPOps) -> int:
    """f32 operations of one point: the encode's, then 2 per multiply-add
    of the MLP's unpadded matrices (JAX's operands)."""
    macs = sum(t.shape[0] * t.shape[1] for t in weight_ops.ops
               if t.shape[0] > 1)
    return encode_flops_per_point(layout) + 2 * macs


__all__ = ["MLPOps", "extract_mlp_weights", "pack_mlp_weights",
           "fused_ngp_eval", "fused_ngp_eval_reference", "unsupported_mlp",
           "build", "flops_per_point"]
