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
the canonical pack (:func:`layout`, ``ops/tile_mlp.py``), permuted once a
pack by one gather into the order the tensor cores read from shared
memory, so that each slab of a matrix is one contiguous run for a bulk
copy.

* :func:`fused_nerf_mlp_enc` encodes raw points and directions in the
  kernel (the eval path, and the training forward of ops/mlp_train.py);
* :func:`fused_nerf_mlp` takes encoded bf16 features (N, 64) and (N, 32)
  (``mlp_train.fused_nerf_mlp_diff``, the features-in counterpart of the
  JAX package's).

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
import functools

import torch
import torch.nn.functional as F

from ..models.encoding.freq import FrequencyEncoder, freq_encode
from ..utils import tracing
from . import _build, tile_mlp
from .tile_mlp import _bf16

WIDTH = 256
HALF = WIDTH // 2
X_DIM = 64       # encoded point features, padded to a multiple of 16
V_DIM = 32       # encoded direction features, padded
RGB_COLS = 16    # RGB head outputs, padded
ALPHA_PAD = 16   # density-head bias, padded


@functools.cache
def layout(depth: int, skip: int, x_dim: int,
           v_dim: int) -> tile_mlp.Layout:
    """The canonical MLP's packs (csrc/nerf_mlp_tile.cuh) for a
    ``depth``-layer trunk with the input re-joined after layer ``skip``,
    on ``x_dim`` encoded point and ``v_dim`` direction features: W_0, W_1
    .. W_{depth-1} (the skip layer's split at ``x_dim`` rows into W_ix and
    W_i), W_feat, w_alpha, Wv_f, Wv_d (``views.0`` split at 256), W_rgb;
    b_0 .. b_{depth-1}, b_feat, b_alpha, b_v, b_rgb (as
    nerf_replication_tpu/ops/pallas/mlp_kernel.py:62-80). The transposed
    image stages all but w_alpha and Wv_d, which the backward never
    multiplies by."""
    if x_dim > X_DIM or v_dim > V_DIM:
        raise ValueError(f"fused kernel: encoded widths {x_dim}/{v_dim} "
                         f"exceed {X_DIM}/{V_DIM}")
    if not 0 <= skip < depth - 1:
        raise ValueError(f"fused kernel: skip {skip} must feed a trunk "
                         f"layer (depth {depth})")
    mat, vec, s = tile_mlp.matrix, tile_mlp.vector, skip + 1
    weights = [mat("0", X_DIM, WIDTH, "pts.0.weight", keep=(x_dim, WIDTH))]
    for i in range(1, depth):
        if i == s:
            weights.append(mat(f"{i}x", X_DIM, WIDTH, f"pts.{i}.weight",
                               keep=(x_dim, WIDTH)))
        weights.append(mat(str(i), WIDTH, WIDTH, f"pts.{i}.weight",
                           col0=x_dim if i == s else 0))
    weights += [mat("feat", WIDTH, WIDTH, "feature.weight"),
                mat("alpha", WIDTH, 1, "alpha.weight", slab=0, slab_t=0),
                mat("vf", WIDTH, HALF, "views.0.weight"),
                mat("vd", V_DIM, HALF, "views.0.weight", col0=WIDTH,
                    keep=(v_dim, HALF), slab_t=0),
                mat("rgb", HALF, RGB_COLS, "rgb.weight", keep=(HALF, 3),
                    slab=HALF)]
    biases = [vec(str(i), WIDTH, f"pts.{i}.bias") for i in range(depth)] + [
        vec("feat", WIDTH, "feature.bias"),
        vec("alpha", ALPHA_PAD, "alpha.bias", keep=1),
        vec("v", HALF, "views.0.bias"),
        vec("rgb", RGB_COLS, "rgb.bias", keep=3)]
    # csrc/fused_nerf_mlp_bwd.cu names the planes; x and v are the
    # encodings as the delta kernel loaded or encoded them
    act = (("h", WIDTH),) * depth + (("feat", WIDTH), ("g_act", HALF),
                                     ("x", X_DIM), ("v", V_DIM))
    dlt = (("d", WIDTH),) * depth + (("d_af", WIDTH + ALPHA_PAD),
                                     ("d_gpre", HALF), ("d_rgb", RGB_COLS))
    return tile_mlp.Layout(depth, skip, tuple(weights), tuple(biases), act,
                           dlt)


def layout_of(net) -> tile_mlp.Layout:
    """The layout of ``net``'s (a port Network's) coarse and fine MLPs."""
    mlp = net.coarse
    return layout(mlp.depth, mlp.skips[0], net.xyz_encoder.output_dim,
                  net.dir_encoder.output_dim)


def _encode(x: torch.Tensor, n_freqs: int, cols: int) -> torch.Tensor:
    feats = freq_encode(x.float(), n_freqs)
    return _bf16(F.pad(feats, (0, cols - feats.shape[-1])))


def _mlp_body(packed: tile_mlp.Pack, x: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The kernels' MLP on bf16-valued f32 features x (N, 64), v (N, 32):
    bf16-valued operands multiplied in f32 (exact products, f32 sums, as
    bf16 x bf16 -> f32 on the tensor cores), f32 bias and ReLU, each
    activation rounded to bf16 before the next product. Reads the pack,
    so it checks the packing too. f32 matmuls must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32`` False, the default)."""
    w, b = tile_mlp.unpack(packed)
    h = _bf16(torch.relu(x @ w["0"] + b["0"]))
    for i in range(1, packed.depth):
        acc = x @ w[f"{i}x"] if i == packed.skip + 1 else 0.0
        acc = acc + h @ w[str(i)]
        h = _bf16(torch.relu(acc + b[str(i)]))
    feat = _bf16(h @ w["feat"] + b["feat"])
    sigma = h @ w["alpha"] + b["alpha"][0]
    g = feat @ w["vf"] + v @ w["vd"]
    g = _bf16(torch.relu(g + b["v"]))
    rgb = (g @ w["rgb"])[:, :3] + b["rgb"][:3]
    return torch.cat([rgb, sigma], dim=-1)


def fused_nerf_mlp_enc_reference(packed: tile_mlp.Pack, pts: torch.Tensor,
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
    """Raw (N, 3) points and directions -> the features-in kernels' bf16
    inputs x (N, 64) and v (N, 32), zero-padded, contiguous. The encoding
    ends in a cast to bf16, so a gradient taken back through it is rounded
    to bf16 on its way to the points; the training route hands the kernels
    the points instead (``mlp_train.FusedNeRFMLPFn``), and the encoding's
    gradient stays f32 there."""
    return (_encode(pts, xyz_freqs, X_DIM).to(torch.bfloat16).contiguous(),
            _encode(dirs, view_freqs, V_DIM).to(torch.bfloat16).contiguous())


def bands(lay: tile_mlp.Layout) -> tuple[int, int]:
    """The frequency bands (point, direction) of the encodings whose
    columns ``lay``'s MLP reads: 3 (1 + 2 F) encoded columns each. Raises
    for a width no 3-D frequency encoding with its input has."""
    widths = {m.name: m.keep_rows for m in lay.weights}
    out = []
    for dim in (widths["0"], widths["vd"]):
        if dim % 3 or (dim // 3) % 2 == 0:
            raise ValueError(f"fused kernel: {dim} encoded columns are no "
                             f"3-D frequency encoding with its input")
        out.append((dim // 3 - 1) // 2)
    return out[0], out[1]


def fused_nerf_mlp_reference(packed: tile_mlp.Pack, x: torch.Tensor,
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
        _build.check_launch(lib, -blocks,
                            "fused_nerf_mlp launch configuration")
    return {"blocks": blocks,
            "shared_memory_bytes": lib.fused_nerf_mlp_smem_bytes()}


def fused_nerf_mlp_enc(packed: tile_mlp.Pack, pts: torch.Tensor,
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
    n = check_points(pts, dirs, xyz_freqs, view_freqs)
    tile_mlp.check_pack(packed, pts.device)
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
    _build.check_launch(lib, err, "fused_nerf_mlp_enc")
    tracing.counts["fused_nerf_mlp_enc.launches"] += 1
    return out


def check_points(pts: torch.Tensor, dirs: torch.Tensor, xyz_freqs: int,
                 view_freqs: int) -> int:
    """The number of points of the encoding kernels' inputs: f32,
    contiguous (N, 3) points and directions on one CUDA device, with bands
    whose encodings fit the kernels' columns; raises otherwise."""
    n = pts.shape[0]
    for name, t in (("pts", pts), ("dirs", dirs)):
        if t.dtype != torch.float32 or t.shape != (n, 3) \
                or not t.is_contiguous() or t.device != pts.device:
            raise ValueError(f"fused kernel: {name} must be a contiguous "
                             f"float32 ({n}, 3) tensor on {pts.device}")
    if 3 * (1 + 2 * xyz_freqs) > X_DIM or 3 * (1 + 2 * view_freqs) > V_DIM:
        raise ValueError(f"fused kernel: at most {(X_DIM // 3 - 1) // 2} "
                         f"and {(V_DIM // 3 - 1) // 2} bands")
    if n >= 2 ** 31 // 4:
        raise ValueError(f"fused kernel: {n} points exceed the int32 index")
    return n


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


def fused_nerf_mlp(packed: tile_mlp.Pack, x: torch.Tensor,
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
    tile_mlp.check_pack(packed, x.device)
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.fused_nerf_mlp(
            x.data_ptr(), v.data_ptr(), out.data_ptr(), n,
            packed.img.data_ptr(), packed.b.data_ptr(), packed.depth,
            packed.skip, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(lib, err, "fused_nerf_mlp")
    tracing.counts["fused_nerf_mlp.launches"] += 1
    return out


def flops_per_point(packed: tile_mlp.Pack) -> int:
    """Multiply-adds x 2 of one point through the padded kernel."""
    macs = (X_DIM * WIDTH + (packed.depth - 1) * WIDTH * WIDTH + X_DIM * WIDTH
            + WIDTH * (WIDTH + 1) + (WIDTH + V_DIM) * HALF + HALF * RGB_COLS)
    return 2 * macs


def unsupported(net) -> str | None:
    """What of ``net`` (a port Network) the kernel does not cover, or None
    when it is the canonical architecture with frequency encoders. A
    D-NeRF's ``coarse`` and ``fine`` are its one canonical MLP; its
    deformation MLP runs in PyTorch ahead of the kernel."""
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
    weights packed now. For a D-NeRF, ``apply_fn(pts, viewdirs, model,
    times)`` moves the points through its deformation MLP first and runs
    the kernel on x + dx (its one canonical MLP packed once). None when
    :func:`unsupported` names a part of the network that the kernel does
    not cover."""
    if unsupported(net) is not None:
        return None
    xyz, dirs = net.xyz_encoder, net.dir_encoder
    lay = layout_of(net)
    coarse = tile_mlp.pack(lay, net.coarse.state_dict())
    packed = {"coarse": coarse,
              "fine": coarse if net.fine is net.coarse
              else tile_mlp.pack(lay, net.fine.state_dict())}
    move = getattr(net, "move", None)

    def apply_fn(pts, viewdirs, model="", times=None):
        shape = pts.shape[:-1]
        p = pts if move is None else move(pts, times)
        p = p.reshape(-1, 3).float().contiguous()
        d = viewdirs.expand(*shape, 3).reshape(-1, 3).float().contiguous()
        branch = "fine" if model == "fine" else "coarse"
        raw = fused_nerf_mlp_enc(packed[branch], p, d, xyz.n_freqs,
                                 dirs.n_freqs)
        return raw.reshape(*shape, 4)

    return apply_fn


__all__ = ["layout", "layout_of", "fused_nerf_mlp_enc",
           "fused_nerf_mlp_enc_reference",
           "fused_nerf_mlp", "fused_nerf_mlp_reference", "encode_features",
           "bands", "check_points", "check_features", "unsupported",
           "make_fused_apply", "build", "flops_per_point"]
