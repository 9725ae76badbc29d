"""Differentiable fused NeRF MLP: the training path's forward and backward
kernels, their wrappers and plain versions, and the autograd glue.

The counterpart of nerf_replication_tpu/ops/pallas/mlp_train.py, whose
``fused_nerf_mlp_diff`` is a custom VJP of two Pallas kernels: the forward
(``_fwd_impl``, :168, the body of ``fused_nerf_mlp``) and the backward
(``_diff_bwd``, :225, ``_bwd_kernel``). Here:

* :class:`FusedNeRFMLPFn` is the ``torch.autograd.Function``. The
  training route hands it raw points and directions (N, 3): its forward
  launches ``mlp_kernel.fused_nerf_mlp_enc`` (#1, csrc/fused_nerf_mlp.cu,
  which encodes its tiles on chip), its backward :func:`fused_nerf_mlp_bwd`
  in the encode arm (csrc/fused_nerf_mlp_bwd.cu: the delta kernel encodes
  its tiles too, and an encoding-gradient kernel takes the points' f32
  gradient through the encoding), so the encoded features never reach
  device memory. Handed encoded features (N, 64) and (N, 32)
  (:func:`fused_nerf_mlp_diff`, the counterpart of the JAX package's), it
  launches ``mlp_kernel.fused_nerf_mlp`` and the features-in arm. On CPU
  tensors both take their plain versions, which encode with
  ``freq_encode``.
* The ``nn.Linear`` parameters are its inputs: their packs
  (``pack_params_jnp``, mlp_train.py:249-278) are one concatenation and
  two gathers (``tile_mlp.packer``), made once a parameter version, and
  its backward maps the packs' gradients back by the inverse gather.
* :func:`make_fused_train_apply` is the training ``apply_fn``. On the TPU
  the encoders stay in XLA; here the kernels encode.

Numerics (mlp_train.py:14-19): bf16 operands and f32 accumulation both
ways, f32 master weights cast to bf16 for the products, ReLU masks from the
recomputed activations, bias gradients summed from f32 deltas, weight
gradients from bf16 deltas. The encoded points' gradient dL/dx = d_0 .
W_0^T + d_{skip+1} . W_ix^T (f32, from the same bf16 deltas) is formed when
x needs one, as a D-NeRF's moved points do (the backward kernel's input
gradient arm), and only then: a NeRF's sample positions carry none. On the
training route it goes on to the points in f32 through the encoding
(:func:`encode_grad_reference` is its plain version), unrounded. The
directions' gradient is zero by contract.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build, deform_mlp, mlp_kernel, tile_mlp
from .mlp_kernel import ALPHA_PAD, RGB_COLS, V_DIM, WIDTH, X_DIM
from .tile_mlp import Pack, _bf16, _round_delta


def _sigma_into_trunk(d_sigma: torch.Tensor, w_alpha: torch.Tensor):
    """The density head's path into the last trunk layer: d_sigma . w_alpha^T."""
    return d_sigma @ w_alpha.t()


def weight_grads(planes: dict, x: torch.Tensor, v: torch.Tensor,
                 packed: Pack) -> torch.Tensor:
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
    return torch.cat([gw[m.name].reshape(-1) for m in packed.layout.weights])


def backward_planes(packed: Pack, x: torch.Tensor, v: torch.Tensor,
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
    w, b = tile_mlp.unpack(packed)
    dt = w["0"].dtype   # f32 (``tile_mlp.unpack``'s)
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
    return planes, torch.cat([gb[m.name] for m in packed.layout.biases])


def input_grad(planes: dict, packed: Pack) -> torch.Tensor:
    """The encoded points' gradient (N, 64) from the planes' bf16 deltas:
    d_0 . W_0^T + d_{skip+1} . W_ix^T, the products the kernel's input
    gradient arm computes."""
    w, _ = tile_mlp.unpack(packed)
    s = packed.skip + 1
    d = planes["d"]
    return d[s] @ w[f"{s}x"].t() + d[0] @ w["0"].t()


def encode_grad_reference(p: torch.Tensor, gx: torch.Tensor,
                          n_freqs: int) -> torch.Tensor:
    """Plain PyTorch version of the encoding-gradient kernel: dL/dp (N, 3)
    of the points from dL/dx (N, >= 3 (1 + 2 F)) of their frequency
    encoding (``freq_encode``'s layout): g[d] + sum over the bands b of
    2^b (cos(2^b p_d) g[sin col] - sin(2^b p_d) g[cos col]), bands in
    increasing order, in p's dtype and never rounded to bf16."""
    tracing.counts["encode_grad_reference.calls"] += 1
    gx = gx.to(p.dtype)
    gp = gx[:, :3]
    for b in range(n_freqs):
        scale = 2.0 ** b
        sn, cs = torch.sin(p * scale), torch.cos(p * scale)
        gp = gp + scale * (cs * gx[:, 3 + 6 * b:6 + 6 * b]
                           - sn * gx[:, 6 + 6 * b:9 + 6 * b])
    return gp


def _is_points(x: torch.Tensor) -> bool:
    """Raw (N, 3) points, which the encode arm encodes, and not encoded
    features."""
    return x.dim() == 2 and x.shape[1] == 3


def fused_nerf_mlp_bwd_reference(packed: Pack, x: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor,
                                 keep: dict | None = None,
                                 with_input_grad: bool = False):
    """Plain PyTorch version of the backward kernels (see
    :func:`backward_planes`): bf16 x (N, 64), v (N, 32), f32 g (N, 4) ->
    (f32 weight-pack gradient, f32 bias-pack gradient), and with
    ``with_input_grad`` the f32 gradient of x (:func:`input_grad`).
    Handed f32 points and directions (N, 3) for x and v, encodes them
    first (``mlp_kernel._encode``, with ``mlp_kernel.bands`` of the
    layout), and the input gradient is then the points' (N, 3), through
    the encoding in f32 (:func:`encode_grad_reference`). With ``keep``,
    stores the planes there as ``keep["planes"]``, and the encoded points'
    gradient as ``keep["grad_x"]``."""
    tracing.counts["fused_nerf_mlp_bwd_reference.calls"] += 1
    pts = x if _is_points(x) else None
    if pts is not None:
        xyz_freqs, view_freqs = mlp_kernel.bands(packed.layout)
        x = mlp_kernel._encode(pts, xyz_freqs, X_DIM)
        v = mlp_kernel._encode(v, view_freqs, V_DIM)
    planes, grad_b = backward_planes(packed, x, v, g)
    if keep is not None:
        keep["planes"] = planes
    dt = planes["d_rgb"].dtype
    grads = (weight_grads(planes, x.to(dt), v.to(dt), packed), grad_b)
    if with_input_grad:
        gx = input_grad(planes, packed)
        if keep is not None:
            keep["grad_x"] = gx
        grads += (gx if pts is None
                  else encode_grad_reference(pts, gx, xyz_freqs),)
    return grads


@functools.cache
def _kernel():
    lib = _build.load("fused_nerf_mlp_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_nerf_mlp_bwd.argtypes = (
        [ptr] * 4 + [i32, i32]                               # x .. view_freqs
        + [ptr, i32, i32, ptr, ptr, ptr, i32, i32]           # g .. skip
        + [ptr] * 9                                          # act .. grad_x
        + [i64, i64, i32, i32, i32, ptr]                     # e_w .. stream
        + [ctypes.POINTER(i64)])                             # bulk_bytes
    lib.fused_nerf_mlp_bwd.restype = i32
    lib.nerf_encode_grad.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
    lib.nerf_encode_grad.restype = i32
    lib.fused_nerf_mlp_bwd_delta_smem_bytes.argtypes = [i32]
    return lib


def build(net=None) -> None:
    """Build (every source concurrently) and load the forward and backward
    kernels now, so that a failed build raises here; with ``net``, also
    those of its bf16 deformation MLP where it has one."""
    deform = net is not None and deform_mlp.runs_on_kernels(net)
    _build.build_all(["fused_nerf_mlp", "fused_nerf_mlp_bwd"]
                     + ([deform_mlp.SOURCE] if deform else []))
    mlp_kernel.build()
    _kernel()
    if deform:
        deform_mlp.build()


def shared_memory_bytes(depth: int) -> dict:
    """Dynamic shared memory of one block of the backward's delta kernel
    (for a ``depth``-layer trunk) and of its weight-gradient kernel."""
    lib = _kernel()
    return {"delta": lib.fused_nerf_mlp_bwd_delta_smem_bytes(depth),
            "wgrad": lib.fused_nerf_mlp_bwd_wgrad_smem_bytes()}


def fused_nerf_mlp_bwd(packed: Pack, x: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, keep: dict | None = None,
                       with_input_grad: bool = False):
    """Gradients of the f32 weight and bias packs from bf16 features x
    (N, 64), v (N, 32) and the f32 cotangent g (N, 4) of the raw output,
    and with ``with_input_grad`` the f32 gradient of x (N, 64), which the
    delta kernel's input gradient arm forms. Handed f32 points and
    directions (N, 3) for x and v, the delta kernel encodes its tiles
    itself (the encode arm, with ``mlp_kernel.bands`` of the layout), and
    the input gradient is the points' (N, 3): the encoding-gradient kernel
    (:func:`encode_grad`) takes dL/dx on through the encoding in f32. With
    ``keep``, stores the
    kernel's workspace there as ``keep["planes"]`` (see
    ``tile_mlp.workspace_planes``), and with ``with_input_grad`` dL/dx as
    ``keep["grad_x"]``, for checks. Counts the launch (and the
    input-gradient, encode-arm and encoding-gradient launches apart), and
    the bytes its workspace's bulk copies move as the C launcher reports
    them, in ``tracing.counts``.

    CUDA tensors launch the kernels; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_nerf_mlp_bwd_reference(packed, x, v, g, keep,
                                            with_input_grad)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {x.device}")
    points = _is_points(x)
    if points:
        bands = mlp_kernel.bands(packed.layout)
        n = mlp_kernel.check_points(x, v, *bands)
        if n >= 2 ** 31 // WIDTH:
            raise ValueError(f"fused kernel: {n} points exceed the int32 "
                             f"index")
    else:
        bands = (0, 0)
        n = mlp_kernel.check_features(x, v)
    tile_mlp.check_pack(packed, x.device)
    if g.dtype != torch.float32 or tuple(g.shape) != (n, 4) \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"fused kernel: g must be a contiguous float32 "
                         f"({n}, 4) tensor on {x.device}")
    kw = dict(dtype=torch.float32, device=x.device)
    in_cols = 3 if points else X_DIM
    if n == 0:
        empty = (torch.zeros(packed.w.numel(), **kw),
                 torch.zeros(packed.b.numel(), **kw))
        return empty + ((torch.zeros(0, in_cols, **kw),) if with_input_grad
                        else ())
    n_pad = tile_mlp.padded(n)
    if points:   # the delta kernel encodes the points, masking rows past n
        features, inputs = (None, None), (x, v)
    else:
        features = tuple(F.pad(t, (0, 0, 0, n_pad - n)).contiguous()
                         for t in (x, v))
        inputs = (None, None)
    buffers, sizes = tile_mlp.backward_workspace(packed, n_pad, x.device)
    grad_x = torch.empty(n_pad, X_DIM, **kw) if with_input_grad else None
    lib = _kernel()
    moved = ctypes.c_longlong(0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        err = lib.fused_nerf_mlp_bwd(
            *map(ptr, features), *map(ptr, inputs), *bands, g.data_ptr(), n,
            n_pad, packed.img.data_ptr(), packed.img_t.data_ptr(),
            packed.b.data_ptr(), packed.depth, packed.skip,
            *(buf.data_ptr() for buf in buffers), ptr(grad_x), *sizes, torch.cuda.current_stream(x.device).cuda_stream,
            ctypes.byref(moved))
    _build.check_launch(lib, err, "fused_nerf_mlp_bwd")
    tracing.counts["fused_nerf_mlp_bwd.launches"] += 1
    tracing.counts["fused_nerf_mlp_bwd.bulk_bytes"] += moved.value
    if points:
        tracing.counts["fused_nerf_mlp_bwd.encode_launches"] += 1
    act, dlt, *_, grad_w, grad_b = buffers
    if keep is not None:
        keep["planes"] = tile_mlp.workspace_planes(packed.layout, act, dlt,
                                                   n, n_pad)
    if grad_x is None:
        return grad_w, grad_b
    tracing.counts["fused_nerf_mlp_bwd.input_grad_launches"] += 1
    if keep is not None:
        keep["grad_x"] = grad_x[:n]
    if not points:
        return grad_w, grad_b, grad_x[:n]
    return grad_w, grad_b, encode_grad(x, grad_x[:n], bands[0])


def encode_grad(pts: torch.Tensor, gx: torch.Tensor,
                n_freqs: int) -> torch.Tensor:
    """dL/dp (N, 3) f32 of points (N, 3) f32 from the f32 gradient dL/dx
    (N, 64) of their frequency encoding with ``n_freqs`` bands (the input
    gradient arm's), in f32 and never rounded to bf16. CUDA tensors launch
    the encoding-gradient kernel (csrc/fused_nerf_mlp_bwd.cu) on the
    current stream and count it
    (``"fused_nerf_mlp_bwd.encode_grad_launches"``); CPU tensors take
    :func:`encode_grad_reference`."""
    if pts.device.type == "cpu":
        return encode_grad_reference(pts, gx, n_freqs)
    n = pts.shape[0]
    for name, t, cols in (("pts", pts, 3), ("gx", gx, X_DIM)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, cols) \
                or not t.is_contiguous() or t.device.type != "cuda" \
                or t.device != pts.device:
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"float32 ({n}, {cols}) CUDA tensor")
    if n_freqs < 0 or 3 * (1 + 2 * n_freqs) > X_DIM:
        raise ValueError(f"fused kernel: {n_freqs} bands do not fit "
                         f"{X_DIM} columns")
    gp = torch.empty(n, 3, dtype=torch.float32, device=pts.device)
    if n == 0:
        return gp
    lib = _kernel()
    with torch.cuda.device(pts.device):
        err = lib.nerf_encode_grad(
            pts.data_ptr(), gx.data_ptr(), n, n_freqs, gp.data_ptr(),
            torch.cuda.current_stream(pts.device).cuda_stream)
    _build.check_launch(lib, err, "nerf_encode_grad")
    tracing.counts["fused_nerf_mlp_bwd.encode_grad_launches"] += 1
    return gp


class FusedNeRFMLPFn(torch.autograd.Function):
    """raw (N, 4) = MLP(x, v) with the branch's parameters ``params`` (in
    the layout's order) as the differentiable inputs and ``packed`` their
    pack. x and v are f32 points and directions (N, 3), which the kernels
    encode on chip with the bands of the pack's layout (the training
    route), or bf16 encoded features (N, 64) and (N, 32). x gets its
    gradient where it needs one (the backward's input gradient arm's f32
    dL/dx; for points, taken on through the encoding by the
    encoding-gradient kernel, unrounded; bf16 features get it rounded to
    their dtype), v a zero one. Only x and v are saved for the backward. The backward maps
    the packs' gradients back to the parameters by ``inverse``
    (``tile_mlp.pack_index``)."""

    @staticmethod
    def forward(ctx, packed: Pack, inverse: torch.Tensor, x, v, *params):
        ctx.packed, ctx.inverse = packed, inverse
        ctx.shapes = [q.shape for q in params]
        if _is_points(x):
            x, v = x.float().contiguous(), v.float().contiguous()
            out = mlp_kernel.fused_nerf_mlp_enc(
                packed, x, v, *mlp_kernel.bands(packed.layout))
        else:
            out = mlp_kernel.fused_nerf_mlp(packed, x, v)
        ctx.save_for_backward(x, v)
        return out

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        want_x = ctx.needs_input_grad[2]
        grad_w, grad_b, *gx = fused_nerf_mlp_bwd(
            ctx.packed, x, v, g.float().contiguous(), with_input_grad=want_x)
        gx = gx[0] if want_x else None
        zv = torch.zeros_like(v) if ctx.needs_input_grad[3] else None
        return (None, None, gx, zv) + tile_mlp.param_grads(
            grad_w, grad_b, ctx.inverse, ctx.shapes)


def _fused_branch(pack_of, mlp, x: torch.Tensor, v: torch.Tensor):
    packed, inverse, params = pack_of(dict(mlp.named_parameters()))
    return FusedNeRFMLPFn.apply(packed, inverse, x, v, *params)


def fused_nerf_mlp_diff(mlp, x: torch.Tensor, v: torch.Tensor, in_dim: int,
                        view_dim: int) -> torch.Tensor:
    """One branch through the differentiable kernels, packed now: bf16
    features x (N, 64), v (N, 32) -> raw (N, 4), with gradients to
    ``mlp``'s parameters (and to x where it needs one)."""
    lay = mlp_kernel.layout(mlp.depth, mlp.skips[0], in_dim, view_dim)
    return _fused_branch(tile_mlp.packer(lay), mlp, x, v)


def train_unsupported(net) -> str | None:
    """What of ``net`` the training route's kernels do not cover: the
    canonical MLP's (``mlp_kernel.unsupported``), then a bf16 deformation
    MLP's (``deform_mlp.unsupported``); None when they cover all of it."""
    return mlp_kernel.unsupported(net) or deform_mlp.unsupported(net)


def make_fused_train_apply(net):
    """Training ``apply_fn(pts, viewdirs, model) -> raw (..., 4)`` that runs
    both branches of ``net`` (a port Network) through the differentiable
    kernels, handing them the points and directions (N, 3), which they
    encode on chip. For a D-NeRF, ``apply_fn(pts, viewdirs, model, times)``
    moves the points through its deformation MLP and runs the kernels on x
    + dx, whose f32 gradient the backward's input gradient arm and the
    encoding-gradient kernel return: the one path by which the deformation
    learns. A bf16 deformation MLP runs on its own kernels
    (``deform_mlp.make_train_deform``), a float32 one as the ``nn.Module``
    under autograd. Each MLP is packed once a parameter version
    (``tile_mlp.packer``): a D-NeRF's one canonical MLP once for both
    passes. None exactly where :func:`train_unsupported` names a part of
    the network that the kernels do not cover."""
    if train_unsupported(net) is not None:
        return None
    move = getattr(net, "move", None)
    deform = deform_mlp.make_train_deform(net)
    coarse = tile_mlp.packer(mlp_kernel.layout_of(net))
    packers = {"coarse": coarse, "fine": coarse if net.fine is net.coarse
               else tile_mlp.packer(mlp_kernel.layout_of(net))}

    def apply_fn(pts, viewdirs, model="", times=None):
        shape = pts.shape[:-1]
        p = pts if move is None else move(pts, times, deform)
        p = p.reshape(-1, 3).float().contiguous()
        d = viewdirs.expand(*shape, 3).reshape(-1, 3).float().contiguous()
        branch = "fine" if model == "fine" else "coarse"
        raw = _fused_branch(packers[branch], getattr(net, branch), p, d)
        return raw.reshape(*shape, 4)

    return apply_fn


__all__ = ["fused_nerf_mlp_bwd", "fused_nerf_mlp_bwd_reference",
           "encode_grad", "encode_grad_reference", "backward_planes",
           "weight_grads", "input_grad", "FusedNeRFMLPFn",
           "fused_nerf_mlp_diff", "train_unsupported",
           "make_fused_train_apply", "build"]
