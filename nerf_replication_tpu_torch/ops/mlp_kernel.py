"""Fused NeRF-MLP forward: the CUDA kernels, their wrappers and their plain
PyTorch versions.

Replaces the TPU Pallas kernels ``fused_nerf_mlp_enc_t``
(nerf_replication_tpu/ops/pallas/mlp_kernel.py:279) and
``fused_nerf_mlp_enc`` (:220), which the JAX renderer reaches through
``make_fused_apply`` for frequency encoders, and ``fused_nerf_mlp``
(:94), whose body the training forward runs
(nerf_replication_tpu/ops/pallas/mlp_train.py:168). The kernels live in
``csrc/fused_nerf_mlp.cu`` on the tile core of ``csrc/nerf_mlp_tile.cuh``;
they are compute-bound (about 1.19 MFLOP per point) and keep every
activation of a 128-point tile in shared memory, so device memory sees only
the inputs and the (N, 4) output. The weights reach them as an "image" of
the canonical pack, permuted once on the host into the order the tensor
cores read from shared memory (:func:`weight_image`), so that each slab of
a matrix is one contiguous run for a bulk copy.

* :func:`fused_nerf_mlp_enc` encodes raw points and directions in the
  kernel (the eval path);
* :func:`fused_nerf_mlp` takes encoded bf16 features (N, 64) and (N, 32)
  (the training path, ops/mlp_train.py).

Only the canonical architecture is covered, as on the TPU: width 256, one
skip, one 128-wide view layer, frequency encoders with at most 10 point
and 4 direction bands (63 -> 64 and 27 -> 32 encoded columns).

Each wrapper launches its kernel for CUDA tensors and uses its plain
version only for tensors on the CPU. Both count their calls in
``utils.tracing.counts`` (``"<name>.launches"`` / ``"<name>.calls"``), and
so does the plain ``nn.Module`` MLP (``"Network.calls"``), so a run can
show which path it went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..models.encoding.freq import FrequencyEncoder, freq_encode
from ..utils import tracing
from . import _build

WIDTH = 256
HALF = WIDTH // 2
X_DIM = 64       # encoded point features, padded to a multiple of 16
V_DIM = 32       # encoded direction features, padded
RGB_COLS = 16    # RGB head outputs, padded
ALPHA_PAD = 16   # density-head bias, padded
SLAB_K = 64      # weight rows per shared-memory stage of the kernels


def pack_matrices(depth: int, skip: int):
    """The canonical weight pack's members in order: (name, rows, cols)."""
    shapes = [("0", X_DIM, WIDTH)]
    for i in range(1, depth):
        if i == skip + 1:
            shapes.append((f"{i}x", X_DIM, WIDTH))
        shapes.append((str(i), WIDTH, WIDTH))
    return shapes + [("feat", WIDTH, WIDTH), ("alpha", WIDTH, 1),
                     ("vf", WIDTH, HALF), ("vd", V_DIM, HALF),
                     ("rgb", HALF, RGB_COLS)]


def _slab_order(at: torch.Tensor, slab_k: int) -> torch.Tensor:
    """``at`` (K, N) holds the pack index of each element of a matrix. The
    indices in the order the kernels stage that matrix: K-slabs of
    ``slab_k`` rows, each as 8 x 8 core matrices ``[k / 8][n / 8][n % 8]
    [k % 8]`` (the unswizzled K-major operand layout of wgmma)."""
    k, n = at.shape
    return at.reshape(k // slab_k, slab_k // 8, 8, n // 8, 8) \
        .permute(0, 1, 3, 4, 2).reshape(-1)


@functools.cache
def image_index(depth: int, skip: int, transposed: bool) -> torch.Tensor:
    """The permutation ``perm`` (int64, on the CPU) with ``image =
    pack[perm]``: the forward image of the canonical weight pack, or the
    transposed one the backward's delta products read (see
    ``csrc/nerf_mlp_tile.cuh``). Every matrix keeps its offset. The
    transposed image permutes only the matrices the backward multiplies
    by (trunk layers 1.., feat, vf, rgb); the rest stay as in the pack."""
    parts, at = [], 0
    for name, rows, cols in pack_matrices(depth, skip):
        idx = torch.arange(at, at + rows * cols).view(rows, cols)
        at += rows * cols
        if name == "alpha":
            parts.append(idx.reshape(-1))
        elif not transposed:
            parts.append(_slab_order(idx, min(rows, SLAB_K)
                                     if name != "rgb" else rows))
        elif name in ("0", "vd") or name.endswith("x"):
            parts.append(idx.reshape(-1))
        else:
            parts.append(_slab_order(idx.t(), min(cols, SLAB_K)))
    return torch.cat(parts)


def weight_image(w: torch.Tensor, depth: int, skip: int,
                 transposed: bool = False) -> torch.Tensor:
    """The kernels' image of the canonical pack ``w`` (one indexing op)."""
    perm = _image_index_on(depth, skip, transposed, w.device)
    if perm.numel() != w.numel():
        raise ValueError(f"fused kernel: a pack of {w.numel()} weights does "
                         f"not fit depth {depth}, skip {skip}")
    return w[perm]


@functools.cache
def _image_index_on(depth, skip, transposed, device):
    return image_index(depth, skip, transposed).to(device)


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """One branch's weights in the canonical layout (see
    ``csrc/nerf_mlp_tile.cuh``): ``w`` a flat bf16 pack of (in, out)
    row-major matrices, ``b`` a flat f32 pack of biases. ``img`` and
    ``img_t`` are the images of ``w`` the kernels read, made at first use."""

    w: torch.Tensor
    b: torch.Tensor
    depth: int
    skip: int

    @functools.cached_property
    def img(self) -> torch.Tensor:
        return weight_image(self.w, self.depth, self.skip)

    @functools.cached_property
    def img_t(self) -> torch.Tensor:
        return weight_image(self.w, self.depth, self.skip, transposed=True)


def pack_tensors(weight, bias, in_dim: int, view_dim: int, depth: int,
                 skip: int):
    """The flat f32 weight and bias packs (the layout of
    ``csrc/nerf_mlp_tile.cuh``) from ``weight(name)`` (an ``nn.Linear``
    weight, (out, in)) and ``bias(name)``, by transpose, pad, split and
    concat only, so autograd routes gradients of the packs back to the
    parameters. The skip layer splits at ``in_dim`` rows and ``views.0``
    at 256, as in nerf_replication_tpu/ops/pallas/mlp_kernel.py:62-80."""
    if in_dim > X_DIM or view_dim > V_DIM:
        raise ValueError(f"fused kernel: encoded widths {in_dim}/{view_dim} "
                         f"exceed {X_DIM}/{V_DIM}")
    if not 0 <= skip < depth - 1:
        raise ValueError(f"fused kernel: skip {skip} must feed a trunk "
                         f"layer (depth {depth})")

    def w(name, rows, cols):
        m = weight(name).float().t()
        if tuple(m.shape) != (rows, cols):
            raise ValueError(f"fused kernel: {name} is {tuple(m.shape)}, "
                             f"expected {(rows, cols)}")
        return m

    def b(name, pad=0):
        return F.pad(bias(name).float(), (0, pad))

    def pad_rows(m, rows):
        return F.pad(m, (0, 0, 0, rows - m.shape[0]))

    ws = [pad_rows(w("pts.0", in_dim, WIDTH), X_DIM)]
    bs = [b("pts.0")]
    for i in range(1, depth):
        if i == skip + 1:
            k = w(f"pts.{i}", in_dim + WIDTH, WIDTH)
            ws += [pad_rows(k[:in_dim], X_DIM), k[in_dim:]]
        else:
            ws.append(w(f"pts.{i}", WIDTH, WIDTH))
        bs.append(b(f"pts.{i}"))
    ws += [w("feature", WIDTH, WIDTH), w("alpha", WIDTH, 1)]
    bs += [b("feature"), b("alpha", ALPHA_PAD - 1)]
    wv = w("views.0", WIDTH + view_dim, HALF)
    ws += [wv[:WIDTH], pad_rows(wv[WIDTH:], V_DIM),
           F.pad(w("rgb", HALF, 3), (0, RGB_COLS - 3))]
    bs += [b("views.0"), b("rgb", RGB_COLS - 3)]
    return torch.cat([m.reshape(-1) for m in ws]), torch.cat(bs)


def pack_nerf_params(state: dict, in_dim: int, view_dim: int, depth: int,
                     skip: int) -> PackedMLP:
    """A NeRFMLP state_dict (``nn.Linear`` weights are (out, in)) -> the
    kernel's pack: bf16 weights, f32 biases, detached."""
    if any(k.startswith("views.1.") for k in state):
        raise ValueError("fused kernel: one view layer only")
    with torch.no_grad():
        w, b = pack_tensors(lambda n: state[f"{n}.weight"].detach(),
                            lambda n: state[f"{n}.bias"].detach(),
                            in_dim, view_dim, depth, skip)
    return PackedMLP(w=w.to(torch.bfloat16), b=b, depth=depth, skip=skip)


def _take(flat: torch.Tensor, at: int, rows: int, cols: int):
    return flat[at:at + rows * cols].view(rows, cols).float(), at + rows * cols


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the cast the kernel applies before a matmul."""
    return x.to(torch.bfloat16).float()


def _encode(x: torch.Tensor, n_freqs: int, cols: int) -> torch.Tensor:
    feats = freq_encode(x.float(), n_freqs)
    return _bf16(F.pad(feats, (0, cols - feats.shape[-1])))


def _mlp_body(packed: PackedMLP, x: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The kernels' MLP on bf16-valued f32 features x (N, 64), v (N, 32):
    bf16-valued operands multiplied in f32 (exact products, f32 sums, as
    bf16 x bf16 -> f32 on the tensor cores), f32 bias and ReLU, each
    activation rounded to bf16 before the next product. Reads the pack,
    so it checks the packing too. f32 matmuls must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32`` False, the default)."""
    w, b = packed.w, packed.b
    wa = ba = 0

    def layer(inp, rows, cols):
        # the next (rows, cols) matrix of the pack, in pack order
        nonlocal wa
        m, wa = _take(w, wa, rows, cols)
        return inp @ m

    h = _bf16(torch.relu(layer(x, X_DIM, WIDTH) + b[ba:ba + WIDTH]))
    ba += WIDTH
    for i in range(1, packed.depth):
        acc = layer(x, X_DIM, WIDTH) if i == packed.skip + 1 else 0.0
        acc = acc + layer(h, WIDTH, WIDTH)
        h = _bf16(torch.relu(acc + b[ba:ba + WIDTH]))
        ba += WIDTH
    feat = _bf16(layer(h, WIDTH, WIDTH) + b[ba:ba + WIDTH])
    sigma = layer(h, WIDTH, 1) + b[ba + WIDTH]
    ba += WIDTH + ALPHA_PAD
    g = layer(feat, WIDTH, HALF) + layer(v, V_DIM, HALF)
    g = _bf16(torch.relu(g + b[ba:ba + HALF]))
    ba += HALF
    rgb = layer(g, HALF, RGB_COLS)[:, :3] + b[ba:ba + 3]
    return torch.cat([rgb, sigma], dim=-1)


def fused_nerf_mlp_enc_reference(packed: PackedMLP, pts: torch.Tensor,
                                 dirs: torch.Tensor, xyz_freqs: int,
                                 view_freqs: int) -> torch.Tensor:
    """Plain PyTorch version of the encode+MLP kernel with the same
    rounding points (see :func:`_mlp_body`).
    (N, 3), (N, 3) -> raw (N, 4) float32."""
    tracing.counts["fused_nerf_mlp_enc_reference.calls"] += 1
    return _mlp_body(packed, _encode(pts, xyz_freqs, X_DIM),
                     _encode(dirs, view_freqs, V_DIM))


def encode_features(pts: torch.Tensor, dirs: torch.Tensor, xyz_freqs: int,
                    view_freqs: int):
    """Raw (N, 3) points and directions -> the features-in kernel's bf16
    inputs x (N, 64) and v (N, 32), zero-padded, contiguous."""
    return (_encode(pts, xyz_freqs, X_DIM).to(torch.bfloat16).contiguous(),
            _encode(dirs, view_freqs, V_DIM).to(torch.bfloat16).contiguous())


def fused_nerf_mlp_reference(packed: PackedMLP, x: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the features-in kernel with the same
    rounding points (see :func:`_mlp_body`). bf16 x (N, 64), v (N, 32) ->
    raw (N, 4) float32."""
    tracing.counts["fused_nerf_mlp_reference.calls"] += 1
    return _mlp_body(packed, x.float(), v.float())


@functools.cache
def _kernel():
    lib = _build.load("fused_nerf_mlp")
    fn = lib.fused_nerf_mlp_enc
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = i32
    lib.fused_nerf_mlp.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, i32, ptr]
    lib.fused_nerf_mlp.restype = i32
    lib.fused_nerf_mlp_grid.argtypes = [i32]
    return lib


def build() -> None:
    """Build and load the kernels now, so that a failed build raises here."""
    _kernel()


def launch_shape(n: int) -> dict:
    """What a forward launch on ``n`` points looks like on the current
    card: persistent ``blocks`` (one an SM, or fewer when there are fewer
    128-point tiles) and the dynamic shared memory of a block."""
    lib = _kernel()
    blocks = lib.fused_nerf_mlp_grid(n)
    if blocks < 0:
        check_launch(-blocks, "fused_nerf_mlp launch configuration")
    return {"blocks": blocks,
            "shared_memory_bytes": lib.fused_nerf_mlp_smem_bytes()}


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    _build.check_launch(_kernel(), err, name)


def check_pack(packed: PackedMLP, device: torch.device) -> None:
    for t in (packed.w, packed.b):
        if t.device != device or not t.is_contiguous():
            raise ValueError("fused kernel: weight pack must be contiguous "
                             f"on {device}")
    if packed.w.dtype != torch.bfloat16 or packed.b.dtype != torch.float32:
        raise ValueError("fused kernel: the pack must be bf16 weights and "
                         "f32 biases")


def fused_nerf_mlp_enc(packed: PackedMLP, pts: torch.Tensor,
                       dirs: torch.Tensor, xyz_freqs: int,
                       view_freqs: int) -> torch.Tensor:
    """Raw (N, 3) points + (N, 3) directions -> raw (N, 4) float32
    ``[rgb, sigma]``, encoding and every MLP layer in one kernel.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if pts.device.type == "cpu":
        return fused_nerf_mlp_enc_reference(packed, pts, dirs, xyz_freqs,
                                            view_freqs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {pts.device}")
    n = pts.shape[0]
    for name, t in (("pts", pts), ("dirs", dirs)):
        if t.dtype != torch.float32 or t.shape != (n, 3) \
                or not t.is_contiguous() or t.device != pts.device:
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"float32 ({n}, 3) tensor on {pts.device}")
    check_pack(packed, pts.device)
    if 3 * (1 + 2 * xyz_freqs) > X_DIM or 3 * (1 + 2 * view_freqs) > V_DIM:
        raise ValueError(f"fused kernel: at most {(X_DIM // 3 - 1) // 2} "
                         f"and {(V_DIM // 3 - 1) // 2} bands")
    if n >= 2 ** 31 // 4:
        raise ValueError(f"fused kernel: {n} points exceed the int32 index")
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(pts.device):
        err = lib.fused_nerf_mlp_enc(
            pts.data_ptr(), dirs.data_ptr(), out.data_ptr(), n,
            packed.img.data_ptr(), packed.b.data_ptr(), packed.depth,
            packed.skip, xyz_freqs, view_freqs,
            torch.cuda.current_stream(pts.device).cuda_stream)
    check_launch(err, "fused_nerf_mlp_enc")
    tracing.counts["fused_nerf_mlp_enc.launches"] += 1
    return out


def check_features(x: torch.Tensor, v: torch.Tensor) -> int:
    """The number of points of the features-in kernels' inputs: bf16,
    contiguous (N, 64) and (N, 32) on one CUDA device; raises otherwise."""
    n = x.shape[0]
    for name, t, cols in (("x", x, X_DIM), ("v", v, V_DIM)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (n, cols) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"bfloat16 ({n}, {cols}) tensor on {x.device}")
    if n >= 2 ** 31 // WIDTH:
        raise ValueError(f"fused kernel: {n} points exceed the int32 index")
    return n


def fused_nerf_mlp(packed: PackedMLP, x: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Encoded bf16 features x (N, 64), v (N, 32) (see
    :func:`encode_features`) -> raw (N, 4) float32 ``[rgb, sigma]``.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_nerf_mlp_reference(packed, x, v)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {x.device}")
    n = check_features(x, v)
    check_pack(packed, x.device)
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.fused_nerf_mlp(
            x.data_ptr(), v.data_ptr(), out.data_ptr(), n,
            packed.img.data_ptr(), packed.b.data_ptr(), packed.depth,
            packed.skip, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "fused_nerf_mlp")
    tracing.counts["fused_nerf_mlp.launches"] += 1
    return out


def flops_per_point(packed: PackedMLP) -> int:
    """Multiply-adds x 2 of one point through the padded kernel."""
    macs = (X_DIM * WIDTH + (packed.depth - 1) * WIDTH * WIDTH + X_DIM * WIDTH
            + WIDTH * (WIDTH + 1) + (WIDTH + V_DIM) * HALF + HALF * RGB_COLS)
    return 2 * macs


def unsupported(net) -> str | None:
    """What of ``net`` (a port Network) the kernel does not cover, or None
    when it is the canonical architecture with frequency encoders."""
    for m in (net.coarse, net.fine):
        if m.width != WIDTH:
            return f"width {m.width} (the kernel takes {WIDTH})"
        if len(m.skips) != 1:
            return f"skips {list(m.skips)} (the kernel takes one)"
        if not m.use_viewdirs or m.view_depth != 1:
            return "the view branch (the kernel takes one view layer)"
    if net.coarse.depth != net.fine.depth or net.coarse.skips != net.fine.skips:
        return "coarse and fine MLPs of different depth or skips"
    xyz, dirs = net.xyz_encoder, net.dir_encoder
    if not all(isinstance(e, FrequencyEncoder) and e.include_input
               and e.input_dim == 3 for e in (xyz, dirs)):
        return "encoders other than 3-D frequency encoders with the input"
    if xyz.output_dim > X_DIM or dirs.output_dim > V_DIM:
        return (f"encoded widths {xyz.output_dim}/{dirs.output_dim} "
                f"(the kernel takes at most {X_DIM}/{V_DIM})")
    return None


def make_fused_apply(net):
    """Eval ``apply_fn(pts, viewdirs, model)`` that runs both branches of
    ``net`` (a port Network) through :func:`fused_nerf_mlp_enc`, with the
    weights packed now. None when :func:`unsupported` names a part of the
    network that the kernel does not cover."""
    if unsupported(net) is not None:
        return None
    xyz, dirs = net.xyz_encoder, net.dir_encoder
    packed = {
        name: pack_nerf_params(mlp.state_dict(), xyz.output_dim,
                               dirs.output_dim, mlp.depth, mlp.skips[0])
        for name, mlp in (("coarse", net.coarse), ("fine", net.fine))}

    def apply_fn(pts, viewdirs, model=""):
        shape = pts.shape[:-1]
        p = pts.reshape(-1, 3).float().contiguous()
        d = viewdirs.expand(*shape, 3).reshape(-1, 3).float().contiguous()
        branch = "fine" if model == "fine" else "coarse"
        raw = fused_nerf_mlp_enc(packed[branch], p, d, xyz.n_freqs,
                                 dirs.n_freqs)
        return raw.reshape(*shape, 4)

    return apply_fn


__all__ = ["PackedMLP", "pack_tensors", "pack_nerf_params",
           "fused_nerf_mlp_enc", "fused_nerf_mlp_enc_reference",
           "fused_nerf_mlp", "fused_nerf_mlp_reference", "encode_features",
           "unsupported", "make_fused_apply", "build", "flops_per_point"]
