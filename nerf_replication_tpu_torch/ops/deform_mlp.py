"""D-NeRF's deformation MLP Psi_t on the training path: its CUDA kernels
(csrc/fused_deform_mlp.cu), their wrappers and plain versions, the weight
pack, and the autograd Function that takes the place of the ``nn.Module``
(``models.nerf.dnerf_network.DeformMLP``) under autograd.

No TPU kernel computes Psi_t: the JAX package runs it in XLA. Here it is
the canonical MLP's kind of network (an 8 x 256 trunk with gamma(x)
re-joined after layer ``skip``), so it runs on the same tile core:

* :func:`fused_deform_mlp`: raw points p (N, 3) and times t (N,) -> dx
  (N, 3) f32, the encodings computed in the kernel;
* :func:`fused_deform_mlp_bwd`: the f32 gradients of the weight and bias
  packs from p, t and the cotangent g of dx, recomputing the forward
  (p and t carry no gradient);
* :class:`FusedDeformMLPFn` ties the two to autograd, with the
  ``nn.Linear`` parameters ``deform.pts.{i}`` and ``deform.out`` as its
  inputs (the state dict stays as it is): their packs (:func:`layout`)
  are one concatenation and two gathers (``tile_mlp.packer``), made once
  a parameter version, and its backward maps the packs' gradients back by
  the inverse gather.

Numerics, as the ``nn.Module``'s in bf16: bf16 operands and f32
accumulation, f32 master weights cast to bf16, bf16 hidden activations
(f32 bias and ReLU first), a head of bf16 operands with an f32 product and
output. Backward: the head's path into the trunk, g . W_out^T, in f32,
masked and rounded once to bf16 (where autograd rounds it); deltas
re-rounded to bf16 before each product; bias gradients from the f32 deltas
(the head's from g); weight gradients from the bf16 planes, W_out's from
bf16(g). CPU tensors take the plain versions, which write these rounding
points out.

The route (:func:`make_train_deform`): a D-NeRF whose deformation is bf16
and of a shape the kernels cover (:func:`unsupported`) trains it through
:class:`FusedDeformMLPFn` when ``network.use_pallas_mlp_train`` is on; a
float32 one keeps the ``nn.Module``. The eval paths keep the module.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..models.encoding.freq import FrequencyEncoder
from ..utils import tracing
from . import _build, tile_mlp
from .mlp_kernel import V_DIM, WIDTH, X_DIM, _encode
from .tile_mlp import Pack, _bf16, _round_delta

T_DIM = V_DIM      # encoded times, padded (the kernels' v tile)
OUT_COLS = 16      # the 3-wide head, padded
MAX_DEPTH = 8      # the delta kernel's mask bits fit beside its buffers
SOURCE = "fused_deform_mlp"


@functools.cache
def layout(depth: int, skip: int, x_dim: int,
           t_dim: int) -> tile_mlp.Layout:
    """Psi_t's packs (csrc/fused_deform_mlp.cu) for a ``depth``-layer trunk
    with gamma(x) re-joined after layer ``skip``, on ``x_dim`` encoded
    point and ``t_dim`` time features: W0x and W0t (``pts.0`` split at
    ``x_dim`` columns), W_1 .. W_{depth-1} (the skip layer's split at
    ``x_dim`` into W_ix and W_i), W_out; b_0 .. b_{depth-1}, b_out. The
    forward image stages W_out in one slab; the transposed one only the
    trunk's W_i^T (i >= 1), the rest as in the pack."""
    if x_dim > X_DIM or t_dim > T_DIM or not 0 <= skip < depth - 1:
        raise ValueError(f"deformation kernel: encoded widths {x_dim}/"
                         f"{t_dim} (at most {X_DIM}/{T_DIM}), skip {skip} "
                         f"at depth {depth}")
    mat, vec, s = tile_mlp.matrix, tile_mlp.vector, skip + 1
    weights = [mat("0x", X_DIM, WIDTH, "pts.0.weight", keep=(x_dim, WIDTH),
                   slab_t=0),
               mat("0t", T_DIM, WIDTH, "pts.0.weight", col0=x_dim,
                   keep=(t_dim, WIDTH), slab_t=0)]
    for i in range(1, depth):
        if i == s:
            weights.append(mat(f"{i}x", X_DIM, WIDTH, f"pts.{i}.weight",
                               keep=(x_dim, WIDTH), slab_t=0))
        weights.append(mat(str(i), WIDTH, WIDTH, f"pts.{i}.weight",
                           col0=x_dim if i == s else 0))
    weights.append(mat("out", WIDTH, OUT_COLS, "out.weight", keep=(WIDTH, 3),
                       slab=WIDTH, slab_t=0))
    biases = [vec(str(i), WIDTH, f"pts.{i}.bias") for i in range(depth)] + [
        vec("out", OUT_COLS, "out.bias", keep=3)]
    act = (("h", WIDTH),) * depth + (("x", X_DIM), ("v", T_DIM))
    dlt = (("d", WIDTH),) * depth + (("d_out", OUT_COLS),)
    return tile_mlp.Layout(depth, skip, tuple(weights), tuple(biases), act,
                           dlt)


def layout_of(net) -> tile_mlp.Layout:
    """The layout of ``net``'s (a D-NeRF's) deformation MLP."""
    deform = net.deform
    return layout(deform.depth, deform.skips[0], net.xyz_encoder.output_dim,
                  1 + 2 * net.time_freq)


def _head_into_trunk(g: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The head's path into the last trunk layer: g . W_out^T, K = 3, f32."""
    return g @ w_out[:, :3].t()


def encode_inputs(p: torch.Tensor, t: torch.Tensor, xyz_freqs: int,
                  time_freqs: int):
    """Points (N, 3) and times (N,) -> the kernels' bf16-valued f32 inputs
    gamma(x) (N, 64) and gamma(t) (N, 32), zero-padded."""
    return (_encode(p, xyz_freqs, X_DIM),
            _encode(t.reshape(-1, 1), time_freqs, T_DIM))


def _trunk(packed: Pack, x: torch.Tensor, v: torch.Tensor):
    """The trunk's f32 activations (after bias and ReLU, before the bf16
    rounding the next product applies), from bf16-valued x and v."""
    w, b = tile_mlp.unpack(packed)
    hs = [torch.relu(x @ w["0x"] + v @ w["0t"] + b["0"])]
    for i in range(1, packed.depth):
        acc = _bf16(hs[-1]) @ w[str(i)]
        if i == packed.skip + 1:
            acc = acc + x @ w[f"{i}x"]
        hs.append(torch.relu(acc + b[str(i)]))
    return hs, w, b


def fused_deform_mlp_reference(packed: Pack, p: torch.Tensor,
                               t: torch.Tensor, xyz_freqs: int,
                               time_freqs: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, with its rounding
    points: (N, 3), (N,) f32 -> dx (N, 3) f32. f32 matmuls must not run in
    TF32 (``torch.backends.cuda.matmul.allow_tf32`` False, the default)."""
    tracing.counts["fused_deform_mlp_reference.calls"] += 1
    x, v = encode_inputs(p, t, xyz_freqs, time_freqs)
    hs, w, b = _trunk(packed, x, v)
    return (_bf16(hs[-1]) @ w["out"])[:, :3] + b["out"][:3]


def weight_grads(planes: dict, x: torch.Tensor, v: torch.Tensor,
                 packed: Pack) -> torch.Tensor:
    """The weight-pack gradient as the products A^T . D of the planes
    (:func:`backward_planes`) and the encodings x, v, in their dtype: the
    sums the weight-gradient kernel computes."""
    h, d = planes["h"], planes["d"]
    gw = {"0x": x.t() @ d[0], "0t": v.t() @ d[0]}
    for i in range(1, packed.depth):
        if i == packed.skip + 1:
            gw[f"{i}x"] = x.t() @ d[i]
        gw[str(i)] = h[i - 1].t() @ d[i]
    gw["out"] = h[-1].t() @ planes["d_out"]
    return torch.cat([gw[m.name].reshape(-1) for m in packed.layout.weights])


def backward_planes(packed: Pack, x: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor):
    """The plain backward up to the weight-gradient products from the
    encodings x, v (:func:`encode_inputs`), with the kernels' rounding
    points written out: the forward recomputed as
    :func:`fused_deform_mlp_reference` does, the head's path g . W_out^T
    in f32, ReLU masks from the f32 activations, bias gradients from the
    f32 deltas, deltas rounded to bf16 (``_round_delta``) before each
    product. Returns (planes, bias-pack gradient); the planes are what the
    delta kernel writes to its workspace: bf16-valued activations
    h[0..depth-1], the encodings x, v, deltas d[0..depth-1] and d_out =
    bf16(g) padded to 16 columns."""
    hs, w, _ = _trunk(packed, x, v)
    g = g.float()
    rd = _round_delta
    gb, d = {"out": F.pad(g.sum(0), (0, OUT_COLS - 3))}, [None] * packed.depth
    d_h = _head_into_trunk(g, w["out"])
    for i in range(packed.depth - 1, -1, -1):
        d_pre = torch.where(hs[i] > 0, d_h, 0.0)
        gb[str(i)] = d_pre.sum(0)
        d[i] = rd(d_pre)
        if i > 0:
            d_h = d[i] @ w[str(i)].t()
    planes = {"h": [_bf16(h) for h in hs], "x": x, "v": v, "d": d,
              "d_out": rd(F.pad(g, (0, OUT_COLS - 3)))}
    return planes, torch.cat([gb[m.name] for m in packed.layout.biases])


def fused_deform_mlp_bwd_reference(packed: Pack, p: torch.Tensor,
                                   t: torch.Tensor, g: torch.Tensor,
                                   xyz_freqs: int, time_freqs: int,
                                   keep: dict | None = None):
    """Plain PyTorch version of the backward kernels (see
    :func:`backward_planes`): f32 p (N, 3), t (N,), g (N, 3) -> (f32
    weight-pack gradient, f32 bias-pack gradient). With ``keep``, stores
    the planes there as ``keep["planes"]``."""
    tracing.counts["fused_deform_mlp_bwd_reference.calls"] += 1
    x, v = encode_inputs(p, t, xyz_freqs, time_freqs)
    planes, grad_b = backward_planes(packed, x, v, g)
    if keep is not None:
        keep["planes"] = planes
    return weight_grads(planes, x, v, packed), grad_b


@functools.cache
def _kernel():
    lib = _build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_deform_mlp.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, i32,
                                     i32, i32, ptr]
    lib.fused_deform_mlp.restype = i32
    lib.fused_deform_mlp_bwd.argtypes = (
        [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32]
        + [ptr] * 8                                          # act .. grad_b
        + [i64, i64, i32, i32, i32, ptr])                    # e_w .. stream
    lib.fused_deform_mlp_bwd.restype = i32
    lib.fused_deform_mlp_bwd_delta_smem_bytes.argtypes = [i32]
    return lib


def build() -> None:
    """Build and load the kernels now, so that a failed build raises here."""
    _kernel()


def shared_memory_bytes(depth: int) -> dict:
    """Dynamic shared memory of a block of the forward kernel and of the
    delta kernel (for a ``depth``-layer trunk)."""
    lib = _kernel()
    return {"forward": lib.fused_deform_mlp_smem_bytes(),
            "delta": lib.fused_deform_mlp_bwd_delta_smem_bytes(depth)}


def _check_inputs(packed: Pack, p: torch.Tensor, t: torch.Tensor,
                  xyz_freqs: int, time_freqs: int) -> int:
    """The number of points; raises on inputs the kernels do not take."""
    n = p.shape[0]
    if p.dtype != torch.float32 or tuple(p.shape) != (n, 3) \
            or not p.is_contiguous():
        raise ValueError(f"deformation kernel: p must be a contiguous "
                         f"float32 ({n}, 3) tensor")
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
            or not t.is_contiguous() or t.device != p.device:
        raise ValueError(f"deformation kernel: t must be a contiguous "
                         f"float32 ({n},) tensor on {p.device}")
    tile_mlp.check_pack(packed, p.device)
    if 3 * (1 + 2 * xyz_freqs) > X_DIM or 1 + 2 * time_freqs > T_DIM:
        raise ValueError(f"deformation kernel: at most "
                         f"{(X_DIM // 3 - 1) // 2} point and "
                         f"{(T_DIM - 1) // 2} time bands")
    if n >= 2 ** 31 // WIDTH:
        raise ValueError(f"deformation kernel: {n} points exceed the int32 "
                         f"index")
    return n


def fused_deform_mlp(packed: Pack, p: torch.Tensor, t: torch.Tensor,
                     xyz_freqs: int, time_freqs: int) -> torch.Tensor:
    """Points p (N, 3) at times t (N,), f32 -> dx (N, 3) f32, the encodings
    and every layer in one kernel.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if p.device.type == "cpu":
        return fused_deform_mlp_reference(packed, p, t, xyz_freqs,
                                          time_freqs)
    if p.device.type != "cuda":
        raise ValueError(f"deformation kernel: unsupported device {p.device}")
    n = _check_inputs(packed, p, t, xyz_freqs, time_freqs)
    out = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(p.device):
        err = lib.fused_deform_mlp(
            p.data_ptr(), t.data_ptr(), out.data_ptr(), n,
            packed.img.data_ptr(), packed.b.data_ptr(), packed.depth,
            packed.skip, xyz_freqs, time_freqs,
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check_launch(lib, err, "fused_deform_mlp")
    tracing.counts["fused_deform_mlp.launches"] += 1
    return out


def fused_deform_mlp_bwd(packed: Pack, p: torch.Tensor,
                         t: torch.Tensor, g: torch.Tensor, xyz_freqs: int,
                         time_freqs: int, keep: dict | None = None):
    """Gradients of the f32 weight and bias packs from the points p (N, 3),
    their times t (N,) and the f32 cotangent g (N, 3) of dx. With ``keep``,
    stores the kernel's workspace there as ``keep["planes"]`` (see
    ``tile_mlp.workspace_planes``), for checks.

    CUDA tensors launch the kernels; CPU tensors take the plain version.
    """
    if p.device.type == "cpu":
        return fused_deform_mlp_bwd_reference(packed, p, t, g, xyz_freqs,
                                              time_freqs, keep)
    if p.device.type != "cuda":
        raise ValueError(f"deformation kernel: unsupported device {p.device}")
    n = _check_inputs(packed, p, t, xyz_freqs, time_freqs)
    if g.dtype != torch.float32 or tuple(g.shape) != (n, 3) \
            or not g.is_contiguous() or g.device != p.device:
        raise ValueError(f"deformation kernel: g must be a contiguous "
                         f"float32 ({n}, 3) tensor on {p.device}")
    if n == 0:
        kw = dict(dtype=torch.float32, device=p.device)
        return (torch.zeros(packed.w.numel(), **kw),
                torch.zeros(packed.b.numel(), **kw))
    n_pad = tile_mlp.padded(n)
    buffers, sizes = tile_mlp.backward_workspace(packed, n_pad, p.device)
    lib = _kernel()
    with torch.cuda.device(p.device):
        err = lib.fused_deform_mlp_bwd(
            p.data_ptr(), t.data_ptr(), g.data_ptr(), n, n_pad,
            packed.img.data_ptr(), packed.img_t.data_ptr(),
            packed.b.data_ptr(), packed.depth, packed.skip, xyz_freqs,
            time_freqs, *(buf.data_ptr() for buf in buffers), *sizes,
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check_launch(lib, err, "fused_deform_mlp_bwd")
    tracing.counts["fused_deform_mlp_bwd.launches"] += 1
    act, dlt, *_, grad_w, grad_b = buffers
    if keep is not None:
        keep["planes"] = tile_mlp.workspace_planes(packed.layout, act, dlt,
                                                   n, n_pad)
    return grad_w, grad_b


class FusedDeformMLPFn(torch.autograd.Function):
    """dx (N, 3) = Psi_t(p, t) with the deformation's parameters ``params``
    (in the layout's order) as the differentiable inputs and ``packed``
    their packs; p and t get no gradient. The forward keeps only
    p and t for the backward, which recomputes the rest under the span
    ``dnerf.deform_backward`` and maps the packs' gradients back to the
    parameters by ``inverse`` (``tile_mlp.pack_index``)."""

    @staticmethod
    def forward(ctx, packed: Pack, inverse: torch.Tensor, p, t,
                xyz_freqs: int, time_freqs: int, *params):
        ctx.packed, ctx.inverse = packed, inverse
        ctx.freqs, ctx.shapes = (xyz_freqs, time_freqs), [q.shape
                                                          for q in params]
        ctx.save_for_backward(p, t)
        return fused_deform_mlp(packed, p, t, xyz_freqs, time_freqs)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        with tracing.span("dnerf.deform_backward"):
            grad_w, grad_b = fused_deform_mlp_bwd(
                ctx.packed, p, t, g.float().contiguous(), *ctx.freqs)
            grads = tile_mlp.param_grads(grad_w, grad_b, ctx.inverse,
                                         ctx.shapes)
        return (None,) * 6 + grads


def unsupported(net) -> str | None:
    """What of ``net``'s bf16 deformation MLP the kernels do not cover, or
    None (also where it has none, or a float32 one, which the ``nn.Module``
    runs)."""
    deform = getattr(net, "deform", None)
    if deform is None or deform.dtype != torch.bfloat16:
        return None
    if deform.width != WIDTH:
        return (f"the deformation's width {deform.width} (the kernels take "
                f"{WIDTH})")
    if len(deform.skips) != 1 or not 0 <= deform.skips[0] < deform.depth - 1:
        return (f"the deformation's skips {list(deform.skips)} at depth "
                f"{deform.depth} (the kernels take one that feeds a trunk "
                f"layer)")
    if deform.depth > MAX_DEPTH:
        return (f"the deformation's depth {deform.depth} (the kernels take "
                f"at most {MAX_DEPTH})")
    xyz = net.xyz_encoder
    if not (isinstance(xyz, FrequencyEncoder) and xyz.include_input
            and xyz.input_dim == 3 and xyz.output_dim <= X_DIM):
        return ("the deformation's point encoder (the kernels take a 3-D "
                f"frequency encoder of at most {X_DIM} columns)")
    t_dim = 1 + 2 * net.time_freq
    if t_dim > T_DIM:
        return (f"the deformation's {net.time_freq} time bands (the kernels "
                f"take at most {(T_DIM - 1) // 2})")
    return None


def runs_on_kernels(net) -> bool:
    """Whether the training route runs ``net``'s deformation MLP on the
    kernels: a bf16 one of a shape they cover."""
    deform = getattr(net, "deform", None)
    return (deform is not None and deform.dtype == torch.bfloat16
            and unsupported(net) is None)


def make_train_deform(net):
    """The training route's Psi_t for ``DNeRFNetwork.move``: a function (p
    (M, 3), t (M, 1)) -> dx (M, 3) through :class:`FusedDeformMLPFn`; None
    where the ``nn.Module`` runs it (no deformation MLP, or a float32 one).
    Raises where the deformation is bf16 and :func:`unsupported` names a
    part of it the kernels do not cover. The packs are made once a
    parameter version (``tile_mlp.packer``), so the passes of a training
    step share them."""
    deform = getattr(net, "deform", None)
    if deform is None or deform.dtype != torch.bfloat16:
        return None
    reason = unsupported(net)
    if reason is not None:
        raise ValueError(f"deformation kernels: {reason}")
    freqs = (net.xyz_encoder.n_freqs, net.time_freq)
    pack_of = tile_mlp.packer(layout_of(net))

    def deform_fn(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        packed, inverse, params = pack_of(dict(deform.named_parameters()))
        return FusedDeformMLPFn.apply(packed, inverse, p.contiguous(),
                                      t.reshape(-1).contiguous(), *freqs,
                                      *params)

    return deform_fn


__all__ = ["layout", "layout_of", "fused_deform_mlp",
           "fused_deform_mlp_reference",
           "fused_deform_mlp_bwd", "fused_deform_mlp_bwd_reference",
           "backward_planes", "weight_grads", "encode_inputs",
           "FusedDeformMLPFn",
           "unsupported", "runs_on_kernels", "make_train_deform", "build"]
