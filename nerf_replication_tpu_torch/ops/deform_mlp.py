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
  inputs (the state dict stays as it is): their packs are one
  concatenation and two gathers (:func:`pack_index`), made once a
  parameter version, and its backward maps the packs' gradients back by
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
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..models.encoding.freq import FrequencyEncoder
from ..utils import tracing
from . import _build, mlp_kernel
from .bwd_workspace import BIAS_ROWS, CHUNK, PAD, planes_of, two_pass_group
from .mlp_kernel import (SLAB_K, V_DIM, WIDTH, X_DIM, _bf16, _encode,
                         _slab_order)

T_DIM = V_DIM      # encoded times, padded (the kernels' v tile)
OUT_COLS = 16      # the 3-wide head, padded
MAX_DEPTH = 8      # the delta kernel's mask bits fit beside its buffers
SOURCE = "fused_deform_mlp"


def pack_matrices(depth: int, skip: int):
    """The weight pack's members in order: (name, rows, cols)."""
    shapes = [("0x", X_DIM, WIDTH), ("0t", T_DIM, WIDTH)]
    for i in range(1, depth):
        if i == skip + 1:
            shapes.append((f"{i}x", X_DIM, WIDTH))
        shapes.append((str(i), WIDTH, WIDTH))
    return shapes + [("out", WIDTH, OUT_COLS)]


def bias_sizes(depth: int):
    """The bias pack's members in order: (name, size)."""
    return [(str(i), WIDTH) for i in range(depth)] + [("out", OUT_COLS)]


@functools.cache
def image_index(depth: int, skip: int, transposed: bool) -> torch.Tensor:
    """The permutation ``perm`` with ``image = pack[perm]`` (int64, on the
    CPU): the forward image, every matrix in K-slabs of at most SLAB_K rows
    (the head in one), or the transposed one, the trunk's W_i^T (i >= 1) in
    slabs of SLAB_K rows and every other matrix as in the pack
    (csrc/fused_deform_mlp.cu). Every matrix keeps its offset."""
    parts, at = [], 0
    for name, rows, cols in pack_matrices(depth, skip):
        idx = torch.arange(at, at + rows * cols).view(rows, cols)
        at += rows * cols
        trunk = name.isdigit() and name != "0"
        if not transposed:
            parts.append(_slab_order(idx, rows if name == "out"
                                     else min(rows, SLAB_K)))
        elif trunk:
            parts.append(_slab_order(idx.t(), SLAB_K))
        else:
            parts.append(idx.reshape(-1))
    return torch.cat(parts)


@functools.cache
def _image_index_on(depth, skip, transposed, device):
    return image_index(depth, skip, transposed).to(device)


@dataclasses.dataclass(frozen=True)
class DeformPack:
    """Psi_t's weights in the kernels' layout: ``w`` a flat bf16 pack of
    (in, out) row-major matrices (:func:`pack_matrices`), ``b`` a flat f32
    pack of biases (:func:`bias_sizes`). ``img`` and ``img_t`` are the
    images of ``w`` the kernels read, made at first use."""

    w: torch.Tensor
    b: torch.Tensor
    depth: int
    skip: int

    def _image(self, transposed: bool) -> torch.Tensor:
        perm = _image_index_on(self.depth, self.skip, transposed,
                               self.w.device)
        if perm.numel() != self.w.numel():
            raise ValueError(f"deformation kernel: a pack of "
                             f"{self.w.numel()} weights does not fit depth "
                             f"{self.depth}, skip {self.skip}")
        return self.w[perm]

    @functools.cached_property
    def img(self) -> torch.Tensor:
        return self._image(False)

    @functools.cached_property
    def img_t(self) -> torch.Tensor:
        return self._image(True)


def parameters_in_order(deform) -> list:
    """A DeformMLP's parameters in the order :func:`pack_params_torch`
    concatenates them: every weight ((out, in), row-major), then every
    bias, each of ``pts.0 .. pts.{depth-1}`` and then ``out``."""
    layers = [*deform.pts, deform.out]
    return [m.weight for m in layers] + [m.bias for m in layers]


@functools.cache
def pack_index(depth: int, skip: int, x_dim: int, t_dim: int):
    """(w_index, b_index, inverse), int64 on the CPU: each element of the
    weight and bias packs as a position in the concatenation of
    :func:`parameters_in_order` with one zero appended, whose position
    (the last) every padding element takes; and each parameter element's
    position in the packs' concatenation (every one has exactly one), the
    gather that maps the packs' gradients back. ``pts.0`` splits at
    ``x_dim`` columns into W0x and W0t, the skip layer at ``x_dim`` into
    W_ix and W_i; each block is the transpose of its columns, (in, out)."""
    fan_in = [x_dim + t_dim] + [WIDTH + (x_dim if i == skip + 1 else 0)
                                for i in range(1, depth)] + [WIDTH]
    fan_out = [WIDTH] * depth + [3]
    at, w_at = 0, []
    for o, i in zip(fan_out, fan_in):
        w_at.append(at)
        at += o * i
    b_at = []
    for o in fan_out:
        b_at.append(at)
        at += o
    zero = at

    def block(layer, rows, cols, col0, valid_rows, valid_cols):
        # pack block [k][n] = weight of ``layer`` [n][col0 + k]
        idx = torch.full((rows, cols), zero, dtype=torch.int64)
        k = torch.arange(valid_rows)[:, None]
        n = torch.arange(valid_cols)[None, :]
        idx[:valid_rows, :valid_cols] = w_at[layer] + n * fan_in[layer] \
            + col0 + k
        return idx.reshape(-1)

    parts = [block(0, X_DIM, WIDTH, 0, x_dim, WIDTH),
             block(0, T_DIM, WIDTH, x_dim, t_dim, WIDTH)]
    for i in range(1, depth):
        if i == skip + 1:
            parts.append(block(i, X_DIM, WIDTH, 0, x_dim, WIDTH))
        parts.append(block(i, WIDTH, WIDTH, x_dim if i == skip + 1 else 0,
                           WIDTH, WIDTH))
    parts.append(block(depth, WIDTH, OUT_COLS, 0, WIDTH, 3))
    b_index = [torch.arange(b_at[i], b_at[i] + WIDTH) for i in range(depth)]
    b_index.append(torch.tensor([b_at[depth] + j if j < 3 else zero
                                 for j in range(OUT_COLS)]))
    w_index, b_index = torch.cat(parts), torch.cat(b_index)
    inverse = torch.full((zero + 1,), -1, dtype=torch.int64)
    inverse[b_index] = w_index.numel() + torch.arange(b_index.numel())
    inverse[w_index] = torch.arange(w_index.numel())
    return w_index, b_index, inverse[:zero]


@functools.cache
def _pack_index_on(depth, skip, x_dim, t_dim, device):
    return tuple(i.to(device) for i in pack_index(depth, skip, x_dim,
                                                  t_dim)) + (
        torch.zeros(1, device=device),)


def _pack_index_of(deform, x_dim: int, t_dim: int):
    params = parameters_in_order(deform)
    if tuple(params[0].shape) != (WIDTH, x_dim + t_dim) \
            or x_dim > X_DIM or t_dim > T_DIM:
        raise ValueError(f"deformation kernel: pts.0 is "
                         f"{tuple(params[0].shape)}, encoded widths "
                         f"{x_dim}/{t_dim} (at most {X_DIM}/{T_DIM})")
    return params, _pack_index_on(deform.depth, deform.skips[0], x_dim,
                                  t_dim, params[0].device)


def pack_params_torch(deform, x_dim: int, t_dim: int):
    """A DeformMLP's parameters -> its (f32 weight pack, f32 bias pack), by
    one concatenation and two gathers (:func:`pack_index`), differentiable
    with respect to the parameters."""
    params, (w_index, b_index, _, zero) = _pack_index_of(deform, x_dim,
                                                         t_dim)
    flat = torch.cat([q.reshape(-1) for q in params] + [zero])
    return flat[w_index], flat[b_index]


def _unpack(packed: DeformPack):
    """The pack's matrices (f32, (in, out)) and biases by name."""
    w, at = {}, 0
    for name, rows, cols in pack_matrices(packed.depth, packed.skip):
        w[name], at = mlp_kernel._take(packed.w, at, rows, cols)
    b, at = {}, 0
    for name, size in bias_sizes(packed.depth):
        b[name] = packed.b[at:at + size].float()
        at += size
    return w, b


def _round_delta(d: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding of a delta before a product."""
    return _bf16(d)


def _head_into_trunk(g: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The head's path into the last trunk layer: g . W_out^T, K = 3, f32."""
    return g @ w_out[:, :3].t()


def encode_inputs(p: torch.Tensor, t: torch.Tensor, xyz_freqs: int,
                  time_freqs: int):
    """Points (N, 3) and times (N,) -> the kernels' bf16-valued f32 inputs
    gamma(x) (N, 64) and gamma(t) (N, 32), zero-padded."""
    return (_encode(p, xyz_freqs, X_DIM),
            _encode(t.reshape(-1, 1), time_freqs, T_DIM))


def _trunk(packed: DeformPack, x: torch.Tensor, v: torch.Tensor):
    """The trunk's f32 activations (after bias and ReLU, before the bf16
    rounding the next product applies), from bf16-valued x and v."""
    w, b = _unpack(packed)
    hs = [torch.relu(x @ w["0x"] + v @ w["0t"] + b["0"])]
    for i in range(1, packed.depth):
        acc = _bf16(hs[-1]) @ w[str(i)]
        if i == packed.skip + 1:
            acc = acc + x @ w[f"{i}x"]
        hs.append(torch.relu(acc + b[str(i)]))
    return hs, w, b


def fused_deform_mlp_reference(packed: DeformPack, p: torch.Tensor,
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
                 packed: DeformPack) -> torch.Tensor:
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
    return torch.cat([gw[name].reshape(-1) for name, _, _ in
                      pack_matrices(packed.depth, packed.skip)])


def backward_planes(packed: DeformPack, x: torch.Tensor, v: torch.Tensor,
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
    return planes, torch.cat([gb[name] for name, _ in
                              bias_sizes(packed.depth)])


def fused_deform_mlp_bwd_reference(packed: DeformPack, p: torch.Tensor,
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


def _check_launch(err: int, name: str) -> None:
    _build.check_launch(_kernel(), err, name)


def _check_inputs(packed: DeformPack, p: torch.Tensor, t: torch.Tensor,
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
    mlp_kernel.check_pack(packed, p.device)
    if 3 * (1 + 2 * xyz_freqs) > X_DIM or 1 + 2 * time_freqs > T_DIM:
        raise ValueError(f"deformation kernel: at most "
                         f"{(X_DIM // 3 - 1) // 2} point and "
                         f"{(T_DIM - 1) // 2} time bands")
    if n >= 2 ** 31 // WIDTH:
        raise ValueError(f"deformation kernel: {n} points exceed the int32 "
                         f"index")
    return n


def fused_deform_mlp(packed: DeformPack, p: torch.Tensor, t: torch.Tensor,
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
    _check_launch(err, "fused_deform_mlp")
    tracing.counts["fused_deform_mlp.launches"] += 1
    return out


def workspace_columns(depth: int) -> tuple:
    """The column counts of the delta kernel's workspace planes, in order:
    activations (h_0 .. h_{depth-1}, x, v) and deltas (d_0 .. d_{depth-1},
    d_out)."""
    return ((WIDTH,) * depth + (X_DIM, T_DIM),
            (WIDTH,) * depth + (OUT_COLS,))


def workspace_planes(act: torch.Tensor, dlt: torch.Tensor, n: int,
                     n_pad: int, depth: int) -> dict:
    """The delta kernel's workspaces, de-tiled, as the row-major planes of
    :func:`backward_planes` (first ``n`` rows)."""
    a_cols, d_cols = workspace_columns(depth)
    a = planes_of(act, a_cols, n, n_pad)
    d = planes_of(dlt, d_cols, n, n_pad)
    return {"h": a[:depth], "x": a[depth], "v": a[depth + 1],
            "d": d[:depth], "d_out": d[depth]}


def fused_deform_mlp_bwd(packed: DeformPack, p: torch.Tensor,
                         t: torch.Tensor, g: torch.Tensor, xyz_freqs: int,
                         time_freqs: int, keep: dict | None = None):
    """Gradients of the f32 weight and bias packs from the points p (N, 3),
    their times t (N,) and the f32 cotangent g (N, 3) of dx. With ``keep``,
    stores the kernel's workspace there as ``keep["planes"]`` (see
    :func:`workspace_planes`), for checks.

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
    kw = dict(dtype=torch.float32, device=p.device)
    e_w, e_b = packed.w.numel(), packed.b.numel()
    if n == 0:
        return torch.zeros(e_w, **kw), torch.zeros(e_b, **kw)
    d = packed.depth
    n_pad = -(-n // PAD) * PAD
    bf = dict(dtype=torch.bfloat16, device=p.device)
    a_cols, d_cols = workspace_columns(d)
    act = torch.empty(n_pad * sum(a_cols), **bf)
    dlt = torch.empty(n_pad * sum(d_cols), **bf)
    chunks = -(-n_pad // CHUNK)
    bias_rows = n_pad // BIAS_ROWS
    group_w = two_pass_group(chunks)
    group_b = two_pass_group(bias_rows)
    part_w = torch.empty(chunks * e_w, **kw)
    tmp_w = torch.empty(-(-chunks // group_w) * e_w, **kw)
    part_b = torch.empty(bias_rows * e_b, **kw)
    tmp_b = torch.empty(-(-bias_rows // group_b) * e_b, **kw)
    grad_w, grad_b = torch.empty(e_w, **kw), torch.empty(e_b, **kw)
    lib = _kernel()
    with torch.cuda.device(p.device):
        err = lib.fused_deform_mlp_bwd(
            p.data_ptr(), t.data_ptr(), g.data_ptr(), n, n_pad,
            packed.img.data_ptr(), packed.img_t.data_ptr(),
            packed.b.data_ptr(), d, packed.skip, xyz_freqs, time_freqs,
            act.data_ptr(), dlt.data_ptr(), part_w.data_ptr(),
            tmp_w.data_ptr(), part_b.data_ptr(), tmp_b.data_ptr(),
            grad_w.data_ptr(), grad_b.data_ptr(), e_w, e_b, CHUNK,
            group_w, group_b,
            torch.cuda.current_stream(p.device).cuda_stream)
    _check_launch(err, "fused_deform_mlp_bwd")
    tracing.counts["fused_deform_mlp_bwd.launches"] += 1
    if keep is not None:
        keep["planes"] = workspace_planes(act, dlt, n, n_pad, d)
    return grad_w, grad_b


class FusedDeformMLPFn(torch.autograd.Function):
    """dx (N, 3) = Psi_t(p, t) with the deformation's parameters ``params``
    (:func:`parameters_in_order`) as the differentiable inputs and
    ``packed`` their packs; p and t get no gradient. The forward keeps only
    p and t for the backward, which recomputes the rest under the span
    ``dnerf.deform_backward`` and maps the packs' gradients back to the
    parameters by ``inverse`` (:func:`pack_index`)."""

    @staticmethod
    def forward(ctx, packed: DeformPack, inverse: torch.Tensor, p, t,
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
            flat = torch.cat([grad_w, grad_b])[ctx.inverse]
        grads = flat.split([s.numel() for s in ctx.shapes])
        return (None,) * 6 + tuple(q.view(s) for q, s in
                                   zip(grads, ctx.shapes))


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
    part of it the kernels do not cover. The packs are made from the
    parameters as they are at a call, and made again only when one has
    changed (its storage or its version: the optimizer's step, a loaded
    state), so the passes of a training step share them."""
    deform = getattr(net, "deform", None)
    if deform is None or deform.dtype != torch.bfloat16:
        return None
    reason = unsupported(net)
    if reason is not None:
        raise ValueError(f"deformation kernels: {reason}")
    x_dim, t_dim = net.xyz_encoder.output_dim, 1 + 2 * net.time_freq
    freqs = (net.xyz_encoder.n_freqs, net.time_freq)
    made = {}

    def deform_fn(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        params, (w_index, b_index, inverse, zero) = _pack_index_of(
            deform, x_dim, t_dim)
        key = tuple((q.data_ptr(), q._version) for q in params)
        if made.get("key") != key:
            with torch.no_grad():
                flat = torch.cat([q.reshape(-1) for q in params] + [zero])
                made.update(key=key, packed=DeformPack(
                    w=flat[w_index].to(torch.bfloat16), b=flat[b_index],
                    depth=deform.depth, skip=deform.skips[0]))
        return FusedDeformMLPFn.apply(made["packed"], inverse,
                                      p.contiguous(),
                                      t.reshape(-1).contiguous(), *freqs,
                                      *params)

    return deform_fn


__all__ = ["DeformPack", "parameters_in_order", "pack_index",
           "pack_params_torch",
           "fused_deform_mlp", "fused_deform_mlp_reference",
           "fused_deform_mlp_bwd", "fused_deform_mlp_bwd_reference",
           "backward_planes", "weight_grads", "encode_inputs",
           "workspace_columns", "workspace_planes", "FusedDeformMLPFn",
           "unsupported", "runs_on_kernels", "make_train_deform", "build"]
