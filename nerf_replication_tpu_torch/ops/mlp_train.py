"""Differentiable fused NeRF MLP: the training path's forward and backward
kernels, their wrappers and plain versions, and the autograd glue.

The counterpart of nerf_replication_tpu/ops/pallas/mlp_train.py, whose
``fused_nerf_mlp_diff`` is a custom VJP of two Pallas kernels: the forward
(``_fwd_impl``, :168, the body of ``fused_nerf_mlp``) and the backward
(``_diff_bwd``, :225, ``_bwd_kernel``). Here:

* :class:`FusedNeRFMLPFn` is the ``torch.autograd.Function``: its forward
  launches ``mlp_kernel.fused_nerf_mlp`` (csrc/fused_nerf_mlp.cu), its
  backward :func:`fused_nerf_mlp_bwd` (csrc/fused_nerf_mlp_bwd.cu). On CPU
  tensors both take their plain versions.
* :func:`pack_params_torch` packs a branch's f32 parameters every step,
  differentiably, so the kernels' gradients of the packs reach the
  ``nn.Linear`` parameters (``pack_params_jnp``, mlp_train.py:249-278).
* :func:`make_fused_train_apply` is the training ``apply_fn``; encoders
  stay in PyTorch (``freq_encode``), as they stay in XLA on the TPU.

Numerics (mlp_train.py:14-19): bf16 operands and f32 accumulation both
ways, f32 master weights cast to bf16 for the products, ReLU masks from the
recomputed activations, bias gradients summed from f32 deltas, weight
gradients from bf16 deltas. Input gradients are zero by contract: sample
positions and directions carry none in NeRF training.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build, mlp_kernel
from .mlp_kernel import (
    ALPHA_PAD,
    HALF,
    RGB_COLS,
    WIDTH,
    PackedMLP,
    _bf16,
    _take,
)

PAD = 128          # the delta kernel takes whole 128-point tiles
BIAS_ROWS = 64     # points per bias partial (one of a tile's two warpgroups)
CHUNK = 4096       # points per partial of the weight-gradient kernel


def pack_params_torch(mlp, in_dim: int, view_dim: int):
    """A NeRFMLP's parameters -> the (f32 weight pack, f32 bias pack) of
    the kernels' layout, differentiable with respect to the parameters."""
    state = mlp.state_dict(keep_vars=True)
    return mlp_kernel.pack_tensors(lambda n: state[f"{n}.weight"],
                                   lambda n: state[f"{n}.bias"], in_dim,
                                   view_dim, mlp.depth, mlp.skips[0])


def _round_delta(d: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding of a delta before a product."""
    return _bf16(d)


def _sigma_into_trunk(d_sigma: torch.Tensor, w_alpha: torch.Tensor):
    """The density head's path into the last trunk layer: d_sigma . w_alpha^T."""
    return d_sigma @ w_alpha.t()


def _unpack(packed: PackedMLP):
    """The pack's matrices (f32, (in, out)) and biases by name."""
    d = packed.depth
    shapes = mlp_kernel.pack_matrices(d, packed.skip)
    w, at = {}, 0
    for name, rows, cols in shapes:
        w[name], at = _take(packed.w, at, rows, cols)
    sizes = [(str(i), WIDTH) for i in range(d)] + [
        ("feat", WIDTH), ("alpha", ALPHA_PAD), ("v", HALF), ("rgb", RGB_COLS)]
    b, at = {}, 0
    for name, size in sizes:
        b[name] = packed.b[at:at + size].to(w["0"].dtype)
        at += size
    return shapes, w, sizes, b


def weight_grads(planes: dict, x: torch.Tensor, v: torch.Tensor,
                 packed: PackedMLP) -> torch.Tensor:
    """The weight-pack gradient as the products A^T . D of the planes
    (see :func:`backward_planes`), in the planes' dtype: the sums the
    weight-gradient kernel computes."""
    depth, skip = packed.depth, packed.skip
    h, d = planes["h"], planes["d"]
    gw = {"0": x.t() @ d[0]}
    for i in range(1, depth):
        if i == skip + 1:
            gw[f"{i}x"] = x.t() @ d[i]
        gw[str(i)] = h[i - 1].t() @ d[i]
    grad_af = h[depth - 1].t() @ planes["d_af"]
    gw["feat"], gw["alpha"] = grad_af[:, :WIDTH], grad_af[:, WIDTH:WIDTH + 1]
    gw["vf"] = planes["feat"].t() @ planes["d_gpre"]
    gw["vd"] = v.t() @ planes["d_gpre"]
    gw["rgb"] = planes["g_act"].t() @ planes["d_rgb"]
    shapes, _, _, _ = _unpack(packed)
    return torch.cat([gw[name].reshape(-1) for name, _, _ in shapes])


def backward_planes(packed: PackedMLP, x: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor):
    """The plain backward up to the weight-gradient products, with the TPU
    kernel's rounding points written out (mlp_train.py:54-145): the forward
    recomputed as ``fused_nerf_mlp_reference`` does, deltas re-rounded to
    bf16 (``_round_delta``) before each product with a transposed weight
    and for the weight gradients, ReLU masks from the f32 activations,
    bias gradients from the f32 deltas. Returns (planes, bias-pack
    gradient); the planes are what the backward kernel writes to its
    workspace: bf16-valued activations h[0..depth-1], feat, g_act and
    deltas d[0..depth-1], d_af = [d_feat | d_sigma | 0] (N, 272), d_gpre,
    d_rgb (N, 16)."""
    depth, skip = packed.depth, packed.skip
    _, w, sizes, b = _unpack(packed)
    dt = w["0"].dtype   # f32 (``_take``'s)
    x, v, g = x.to(dt), v.to(dt), g.to(dt)
    rd = _round_delta

    hs = [torch.relu(x @ w["0"] + b["0"])]
    for i in range(1, depth):
        acc = _bf16(hs[-1]) @ w[str(i)]
        if i == skip + 1:
            acc = acc + x @ w[f"{i}x"]
        hs.append(torch.relu(acc + b[str(i)]))
    feat = _bf16(hs[-1]) @ w["feat"] + b["feat"]
    g_act = torch.relu(_bf16(feat) @ w["vf"] + v @ w["vd"] + b["v"])

    gb, d = {}, [None] * depth
    d_rgb = F.pad(g[:, :3], (0, RGB_COLS - 3))
    d_sigma = g[:, 3:4]
    gb["rgb"] = d_rgb.sum(0)
    d_gpre = torch.where(g_act > 0, rd(d_rgb) @ w["rgb"].t(), 0.0)
    gb["v"] = d_gpre.sum(0)
    d_feat = rd(d_gpre) @ w["vf"].t()
    gb["feat"] = d_feat.sum(0)
    gb["alpha"] = F.pad(d_sigma.sum(0), (0, ALPHA_PAD - 1))
    d_h = rd(d_feat) @ w["feat"].t() + _sigma_into_trunk(rd(d_sigma),
                                                         w["alpha"])
    for i in range(depth - 1, -1, -1):
        d_pre = torch.where(hs[i] > 0, d_h, 0.0)
        gb[str(i)] = d_pre.sum(0)
        d[i] = rd(d_pre)
        if i > 0:
            d_h = d[i] @ w[str(i)].t()
    planes = {"h": [_bf16(h) for h in hs], "feat": _bf16(feat),
              "g_act": _bf16(g_act), "d": d,
              "d_af": F.pad(torch.cat([rd(d_feat), rd(d_sigma)], dim=1),
                            (0, ALPHA_PAD - 1)),
              "d_gpre": rd(d_gpre), "d_rgb": rd(d_rgb)}
    return planes, torch.cat([gb[name] for name, _ in sizes])


def fused_nerf_mlp_bwd_reference(packed: PackedMLP, x: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor,
                                 keep: dict | None = None):
    """Plain PyTorch version of the backward kernel (see
    :func:`backward_planes`): bf16 x (N, 64), v (N, 32), f32 g (N, 4) ->
    (f32 weight-pack gradient, f32 bias-pack gradient). With ``keep``,
    stores the planes there as ``keep["planes"]``."""
    tracing.counts["fused_nerf_mlp_bwd_reference.calls"] += 1
    planes, grad_b = backward_planes(packed, x, v, g)
    if keep is not None:
        keep["planes"] = planes
    dt = planes["d_rgb"].dtype
    return weight_grads(planes, x.to(dt), v.to(dt), packed), grad_b


@functools.cache
def _kernel():
    lib = _build.load("fused_nerf_mlp_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_nerf_mlp_bwd.argtypes = (
        [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, i32]   # x .. skip
        + [ptr] * 8                                          # act .. grad_b
        + [i64, i64, i32, i32, i32, ptr])                    # e_w .. stream
    lib.fused_nerf_mlp_bwd.restype = i32
    lib.fused_nerf_mlp_bwd_delta_smem_bytes.argtypes = [i32]
    return lib


def build() -> None:
    """Build (both sources concurrently) and load the forward and backward
    kernels now, so that a failed build raises here."""
    _build.build_all(["fused_nerf_mlp", "fused_nerf_mlp_bwd"])
    mlp_kernel.build()
    _kernel()


def shared_memory_bytes(depth: int) -> dict:
    """Dynamic shared memory of one block of the backward's delta kernel
    (for a ``depth``-layer trunk) and of its weight-gradient kernel."""
    lib = _kernel()
    return {"delta": lib.fused_nerf_mlp_bwd_delta_smem_bytes(depth),
            "wgrad": lib.fused_nerf_mlp_bwd_wgrad_smem_bytes()}


def _two_pass_group(rows: int) -> int:
    """Rows summed per group in the first of the two reduction passes."""
    return max(1, math.ceil(math.sqrt(rows)))


def workspace_planes(act: torch.Tensor, dlt: torch.Tensor, n: int,
                     n_pad: int, depth: int) -> dict:
    """Views of the backward kernel's workspaces as the planes of
    :func:`backward_planes` (first ``n`` rows)."""
    plane = n_pad * WIDTH
    h = act[:(depth + 1) * plane].view(depth + 1, n_pad, WIDTH)[:, :n]
    d = dlt[:depth * plane].view(depth, n_pad, WIDTH)[:, :n]
    rest = dlt[depth * plane:]
    af, at = WIDTH + ALPHA_PAD, n_pad * (WIDTH + ALPHA_PAD)
    return {"h": list(h[:depth]), "feat": h[depth],
            "g_act": act[(depth + 1) * plane:].view(n_pad, HALF)[:n],
            "d": list(d), "d_af": rest[:at].view(n_pad, af)[:n],
            "d_gpre": rest[at:at + n_pad * HALF].view(n_pad, HALF)[:n],
            "d_rgb": rest[at + n_pad * HALF:].view(n_pad, RGB_COLS)[:n]}


def fused_nerf_mlp_bwd(packed: PackedMLP, x: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, keep: dict | None = None):
    """Gradients of the f32 weight and bias packs from bf16 features x
    (N, 64), v (N, 32) and the f32 cotangent g (N, 4) of the raw output.
    With ``keep``, stores the kernel's workspace there as
    ``keep["planes"]`` (see :func:`workspace_planes`), for checks.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_nerf_mlp_bwd_reference(packed, x, v, g, keep)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {x.device}")
    n = mlp_kernel.check_features(x, v)
    mlp_kernel.check_pack(packed, x.device)
    if g.dtype != torch.float32 or tuple(g.shape) != (n, 4) \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"fused kernel: g must be a contiguous float32 "
                         f"({n}, 4) tensor on {x.device}")
    kw = dict(dtype=torch.float32, device=x.device)
    e_w, e_b = packed.w.numel(), packed.b.numel()
    if n == 0:
        return torch.zeros(e_w, **kw), torch.zeros(e_b, **kw)
    d = packed.depth
    n_pad = -(-n // PAD) * PAD
    x_pad = F.pad(x, (0, 0, 0, n_pad - n)).contiguous()
    v_pad = F.pad(v, (0, 0, 0, n_pad - n)).contiguous()
    bf = dict(dtype=torch.bfloat16, device=x.device)
    act = torch.empty((d + 1) * n_pad * WIDTH + n_pad * HALF, **bf)
    dlt = torch.empty(d * n_pad * WIDTH
                      + n_pad * (WIDTH + ALPHA_PAD + HALF + RGB_COLS), **bf)
    chunks, bias_rows = -(-n_pad // CHUNK), n_pad // BIAS_ROWS
    group_w, group_b = _two_pass_group(chunks), _two_pass_group(bias_rows)
    part_w = torch.empty(chunks * e_w, **kw)
    tmp_w = torch.empty(-(-chunks // group_w) * e_w, **kw)
    part_b = torch.empty(bias_rows * e_b, **kw)
    tmp_b = torch.empty(-(-bias_rows // group_b) * e_b, **kw)
    grad_w, grad_b = torch.empty(e_w, **kw), torch.empty(e_b, **kw)
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.fused_nerf_mlp_bwd(
            x_pad.data_ptr(), v_pad.data_ptr(), g.data_ptr(), n, n_pad,
            packed.img.data_ptr(), packed.img_t.data_ptr(),
            packed.b.data_ptr(), d, packed.skip, act.data_ptr(),
            dlt.data_ptr(), part_w.data_ptr(), tmp_w.data_ptr(),
            part_b.data_ptr(), tmp_b.data_ptr(),
            grad_w.data_ptr(), grad_b.data_ptr(), e_w, e_b, CHUNK, group_w,
            group_b, torch.cuda.current_stream(x.device).cuda_stream)
    mlp_kernel.check_launch(err, "fused_nerf_mlp_bwd")
    tracing.counts["fused_nerf_mlp_bwd.launches"] += 1
    if keep is not None:
        keep["planes"] = workspace_planes(act, dlt, n, n_pad, d)
    return grad_w, grad_b


class FusedNeRFMLPFn(torch.autograd.Function):
    """raw (N, 4) = MLP(x, v) with f32 packs ``w``, ``b`` as the
    differentiable inputs; x, v get zero gradients."""

    @staticmethod
    def forward(ctx, w, b, x, v, depth: int, skip: int):
        packed = PackedMLP(w=w.detach().to(torch.bfloat16).contiguous(),
                           b=b.detach().contiguous(), depth=depth, skip=skip)
        ctx.packed = packed
        ctx.save_for_backward(x, v)
        return mlp_kernel.fused_nerf_mlp(packed, x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        grad_w, grad_b = fused_nerf_mlp_bwd(ctx.packed, x, v,
                                            g.float().contiguous())
        zx = torch.zeros_like(x) if ctx.needs_input_grad[2] else None
        zv = torch.zeros_like(v) if ctx.needs_input_grad[3] else None
        return grad_w, grad_b, zx, zv, None, None


def fused_nerf_mlp_diff(mlp, x: torch.Tensor, v: torch.Tensor, in_dim: int,
                        view_dim: int) -> torch.Tensor:
    """One branch through the differentiable kernels: bf16 features x
    (N, 64), v (N, 32) -> raw (N, 4), with gradients to ``mlp``'s
    parameters."""
    w, b = pack_params_torch(mlp, in_dim, view_dim)
    return FusedNeRFMLPFn.apply(w, b, x, v, mlp.depth, mlp.skips[0])


def make_fused_train_apply(net):
    """Training ``apply_fn(pts, viewdirs, model) -> raw (..., 4)`` that runs
    both branches of ``net`` (a port Network) through the differentiable
    kernels. None exactly where ``mlp_kernel.unsupported(net)`` names a
    part of the network that the kernels do not cover."""
    if mlp_kernel.unsupported(net) is not None:
        return None
    xyz, dirs = net.xyz_encoder, net.dir_encoder

    def apply_fn(pts, viewdirs, model=""):
        shape = pts.shape[:-1]
        p = pts.reshape(-1, 3).float()
        d = viewdirs.expand(*shape, 3).reshape(-1, 3).float()
        x, v = mlp_kernel.encode_features(p, d, xyz.n_freqs, dirs.n_freqs)
        mlp = net.fine if model == "fine" else net.coarse
        raw = fused_nerf_mlp_diff(mlp, x, v, xyz.output_dim, dirs.output_dim)
        return raw.reshape(*shape, 4)

    return apply_fn


__all__ = ["pack_params_torch", "fused_nerf_mlp_bwd",
           "fused_nerf_mlp_bwd_reference", "backward_planes", "weight_grads",
           "workspace_planes", "FusedNeRFMLPFn",
           "fused_nerf_mlp_diff", "make_fused_train_apply", "build"]
