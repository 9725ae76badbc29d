"""Multi-resolution hash-grid encoders as ``nn.Module``s.

The counterpart of nerf_replication_tpu/models/encoding/hashgrid.py.
:class:`HashGridEncoder` has the JAX module's two backends:

* ``backend="xla"`` (the default, as in the JAX package) is the
  vertex-exact instant-ngp grid of any ``input_dim`` 2-4 and any
  ``n_features``: a table of shape (offsets[-1], n_features), levels
  8-aligned, dense below the table size and hashed above it with the
  prime-XOR hash in wrapping uint32 arithmetic. :func:`hash_encode` is its
  forward (one gather over all levels and corners, the weighted corner
  sum) with the backward of the JAX ``custom_vjp``: the table gradient
  (one ``index_add_`` of the corners' contributions) and, with
  ``input_grad``, the analytic gradient of the interpolation weights with
  respect to the points (zero without it). ``sorted_bwd`` is accepted as
  the JAX module accepts it and computes the same sum: the JAX package
  sorts the rows first to spare the TPU a serialising scatter, and on the
  card the sort only adds time (PERF.md section 6). ``compute_dtype
  bfloat16`` reads a bf16 copy of the table, sums the corners of bf16
  products in f32 and rounds the sum to bf16, and hands the f32
  parameter a bf16-rounded gradient, as the JAX module does. The JAX
  package runs this in XLA, outside any Pallas kernel, so it is plain
  PyTorch here on the card too.
* ``backend="brick"`` (``input_dim`` 3, 2 features, no input gradient)
  hashes 4^3-cell bricks: the table is (n_rows, 256) in the layout of
  ops/hashgrid_kernel.py and the forward is the training encode with its
  table gradient (``ops.hashgrid_kernel.BrickHashEncodeFn``: the CUDA
  kernels on a CUDA tensor, their plain versions on a CPU tensor). The
  eval path reaches the packed-table kernels through
  models/nerf/renderer/ngp_renderer.py instead.

Either way the table is the state_dict's ``table``, so a JAX checkpoint's
``params/xyz_encoder/table`` loads into it as it is; the two backends'
tables differ in shape and do not load into each other.

The composite encoders built from the vertex-exact grid, with its input
gradient on (the JAX default), follow: :class:`TriPlaneEncoder`,
:class:`Motion2DEncoder`, :class:`HashLatentEncoder`,
:class:`HashGrid4DEncoder` and :class:`HashCoefEncoder`. Their Dense
layers are ``nn.Linear`` with Flax's init, and lists of submodules
(``mlp_{i}``, ``basis_{i}``) are ``nn.ModuleList``s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...config import as_bool
from ...ops import hashgrid_kernel as hk
from ...utils import tracing
from ..flax_init import dense, uniform_parameter

EPS = 1e-6
# instant-ngp hash primes; the first dimension is not multiplied
_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF
_GRID_FIELDS = ("input_dim", "n_levels", "n_features", "log2_hashmap_size",
                "base_resolution", "finest_resolution", "per_level_scale")


def normalize_to_unit(x: torch.Tensor, bounds) -> torch.Tensor:
    """Clamp to ``bounds`` (lo..., hi...) and scale into [0,1]^D by the
    largest side, in float32 as the jitted JAX package does."""
    d = x.shape[-1]
    lo, hi, inv = (torch.from_numpy(a).to(x.device)
                   for a in box_constants(bounds[:d], bounds[d:]))
    return _into_box(x, lo, hi, inv)


def box_constants(lo, hi) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float32 lo, hi and the reciprocal of the largest side plus EPS,
    rounded once to float32. The JAX package divides by that side inside
    ``jit``, where XLA turns a division by a constant into a product by
    its float32 reciprocal; at +-1.2 or +-1.5 the side is no power of two
    and a true division lands an ulp off on about one coordinate in six."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    side = np.max(hi - lo) + np.float32(EPS)
    return lo, hi, np.array(np.float32(1.0) / side)


def _into_box(x, lo, hi, inv_side):
    x = torch.minimum(torch.maximum(x, lo), hi)
    return (x - lo) * inv_side


def frame_time(t: torch.Tensor, frames: int) -> torch.Tensor:
    """t / max(frames, 1) as a product by the reciprocal, which is how
    jitted XLA divides by a constant and how CUDA divides by a scalar; the
    CPU's true division would round a third of t / 3 one ulp apart."""
    return t * (1.0 / max(frames, 1))


def _register_box(module: nn.Module, bounds) -> None:
    """The corners of ``bounds`` as non-persistent buffers of ``module``:
    they move with it, so no call copies them to the device (a copy would
    wait for the host inside a frame)."""
    if not bounds:
        return
    d = len(bounds) // 2
    lo, hi, inv = box_constants(bounds[:d], bounds[d:])
    module.register_buffer("box_lo", torch.from_numpy(lo), persistent=False)
    module.register_buffer("box_hi", torch.from_numpy(hi), persistent=False)
    module.register_buffer("box_inv_side", torch.from_numpy(inv),
                           persistent=False)


def _normalize(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``normalize_to_unit`` by ``module``'s box buffers, if it has any."""
    if not module.bounds:
        return x
    return _into_box(x, module.box_lo, module.box_hi, module.box_inv_side)


# -- the vertex-exact functional core -------------------------------------

class HashLayout(NamedTuple):
    """The JAX package's layout tuple but its last field, ``sorted_bwd``:
    (scales, offsets, use_hash, table_size, D, F, input_grad)."""
    scales: tuple
    offsets: tuple
    use_hash: tuple
    table_size: int
    input_dim: int
    n_features: int
    input_grad: bool


def _level_layout(input_dim, n_levels, log2_hashmap_size, base_resolution,
                  finest_resolution, per_level_scale):
    """Resolutions, table offsets (levels 8-aligned) and the dense/hash
    switch of each level, and the table size."""
    if finest_resolution and finest_resolution > 0 and n_levels > 1:
        b = (finest_resolution / base_resolution) ** (1.0 / (n_levels - 1))
    else:
        b = per_level_scale
    table_size = 2 ** log2_hashmap_size
    scales, offsets, use_hash = [], [0], []
    for i in range(n_levels):
        res = int(np.ceil(base_resolution * (b ** i)))
        scales.append(res)
        dense_rows = (res + 1) ** input_dim
        n_entries = int(np.ceil(min(dense_rows, table_size) / 8) * 8)
        use_hash.append(dense_rows > table_size)
        offsets.append(offsets[-1] + n_entries)
    return scales, offsets, use_hash, table_size


def _corners(D: int, device) -> torch.Tensor:
    """The 2^D cell corners (C, D) in 0/1, dimension 0 most significant,
    made on ``device``: a copy from the host would wait for the card."""
    c = torch.arange(2 ** D, device=device)
    return (c[:, None] >> torch.arange(D - 1, -1, -1, device=device)) & 1


def _indices_weights(layout: HashLayout, x: torch.Tensor):
    """x (N, D) in [0,1] -> global table rows (N, L*C) int64 and
    interpolation weights (N, L*C) in x's dtype. The hash is the JAX package's
    wrapping uint32 one, in int64 with every product masked to 32 bits:
    coordinates are clipped to ``res``, so a product stays below 2^43."""
    D = layout.input_dim
    corners = _corners(D, x.device)                             # (C, D)
    one = corners == 1
    idx_all, w_all = [], []
    for level, res in enumerate(layout.scales):
        pos = x * res
        base = torch.floor(pos)
        frac = pos - base
        cidx = base.to(torch.int64)[:, None, :] + corners[None]  # (N, C, D)
        cidx = cidx.clamp(0, res)
        if layout.use_hash[level]:
            h = cidx[..., 0]
            for d in range(1, D):
                h = h ^ ((cidx[..., d] * _PRIMES[d]) & _U32)
            idx = h & (layout.table_size - 1)
        else:
            idx = cidx[..., 0]
            for d in range(1, D):
                idx = idx * (res + 1) + cidx[..., d]
        idx_all.append(idx + layout.offsets[level])
        # the product in dimension order, one rounding a factor, so the
        # weights are bit-equal on every device
        terms = torch.where(one[None], frac[:, None, :],
                            1.0 - frac[:, None, :])          # (N, C, D)
        w = terms[..., 0]
        for d in range(1, D):
            w = w * terms[..., d]
        w_all.append(w)
    return torch.cat(idx_all, dim=-1), torch.cat(w_all, dim=-1)


def encode_forward(layout: HashLayout, table: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """(N, D) points in [0,1] -> (N, L*F) float32 features (float64 for a
    float64 table and points, a reference): the corner rows gathered once
    for every level, weighted and summed. A bf16 table gives bf16
    products, summed in f32 and rounded to bf16 (jnp.sum's accumulation of
    a bf16 array)."""
    L, C, F = len(layout.scales), 2 ** layout.input_dim, layout.n_features
    n = x.shape[0]
    idx, w = _indices_weights(layout, x)
    vals = table[idx.reshape(-1)].reshape(n, L, C, F)
    prod = w.reshape(n, L, C, 1).to(vals.dtype) * vals
    if prod.dtype == torch.bfloat16:
        out = prod.float().sum(dim=2).to(prod.dtype)
    else:
        out = prod.sum(dim=2)
    return out.reshape(n, L * F).to(torch.promote_types(out.dtype,
                                                        torch.float32))


def encode_backward(layout: HashLayout, table: torch.Tensor,
                    x: torch.Tensor, g: torch.Tensor, table_grad: bool = True,
                    points_grad: bool = True):
    """The JAX ``custom_vjp``'s backward of :func:`encode_forward` for the
    cotangent ``g`` (N, L*F): (d table in the table's dtype, d x), either
    None where not asked for. d table adds the float32 contributions w x g
    of every (point, level, corner) with one ``index_add_``. d x is the
    analytic derivative of the interpolation weights, level by level and
    scaled by the level's resolution, with ``input_grad``, else zero."""
    L, C, F = len(layout.scales), 2 ** layout.input_dim, layout.n_features
    D = layout.input_dim
    n = x.shape[0]
    idx, w = _indices_weights(layout, x)
    g4 = g.reshape(n, L, 1, F)
    dtable = dx = None
    if table_grad:
        u = (w.reshape(n, L, C, 1) * g4).reshape(-1, F)
        dtable = torch.zeros(table.shape[0], F, dtype=u.dtype,
                             device=u.device).index_add_(0, idx.reshape(-1),
                                                         u)
        dtable = dtable.to(table.dtype)
    if points_grad and not layout.input_grad:
        dx = torch.zeros_like(x)
    elif points_grad:
        vals = table[idx.reshape(-1)].reshape(n, L, C, F)
        vg = (vals.to(g.dtype) * g4).sum(-1)              # (N, L, C) dL/dw
        corners = _corners(D, x.device)
        one = corners == 1
        sign = torch.where(one, 1.0, -1.0)
        dx = torch.zeros_like(x)
        for level, res in enumerate(layout.scales):
            pos = x * res
            frac = pos - torch.floor(pos)
            term = torch.where(one[None], frac[:, None, :],
                               1.0 - frac[:, None, :])    # (N, C, D)
            for d in range(D):
                others = [term[..., dd] for dd in range(D) if dd != d]
                prod = others[0]
                for o in others[1:]:
                    prod = prod * o
                dwdx = sign[..., d] * prod                # (N, C)
                dx[:, d] += (vg[:, level, :] * dwdx).sum(-1) * res
    return dtable, dx


class HashEncodeFn(torch.autograd.Function):
    """:func:`encode_forward` with :func:`encode_backward` as its
    gradient; the points' gradient is zero without ``input_grad``."""

    @staticmethod
    def forward(ctx, layout, table, x):
        ctx.layout = layout
        ctx.save_for_backward(table, x)
        return encode_forward(layout, table, x)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        dtable, dx = encode_backward(ctx.layout, table, x, g.contiguous(),
                                     ctx.needs_input_grad[1],
                                     ctx.needs_input_grad[2])
        return None, dtable, dx


def hash_encode(layout: HashLayout, table: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The fused multi-level encode of the JAX package's ``hash_encode``;
    ``tracing.counts["hash_encode.calls"]`` counts its calls."""
    tracing.counts["hash_encode.calls"] += 1
    return HashEncodeFn.apply(layout, table, x)


# -- the encoder ------------------------------------------------------------

class HashGridEncoder(nn.Module):
    """D-dimensional multi-resolution hash grid; ``output_dim`` is
    n_levels x n_features. Points are world-space when ``bounds`` is set
    (and ``normalize`` is not False), else in [0,1]^D; they are clipped
    to [0,1] either way. The arguments and their defaults are the JAX
    module's."""

    def __init__(self, input_dim: int = 3, n_levels: int = 16,
                 n_features: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, finest_resolution: int = -1,
                 per_level_scale: float = 2.0, bounds=(),
                 input_grad: bool = True, sorted_bwd: bool = True,
                 compute_dtype: str = "float32", backend: str = "xla",
                 log2_bricks: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backend not in ("xla", "brick"):
            raise ValueError(f"unknown hash-grid backend {backend!r}")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.input_dim, self.n_levels = input_dim, n_levels
        self.n_features = n_features
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.finest_resolution = finest_resolution
        self.per_level_scale = per_level_scale
        self.bounds = tuple(bounds)
        self.input_grad, self.sorted_bwd = input_grad, sorted_bwd
        self.compute_dtype = compute_dtype
        self.backend, self.log2_bricks = backend, log2_bricks
        self.output_dim = n_levels * n_features
        _register_box(self, self.bounds)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if backend == "brick":
            if (input_dim, n_features) != (3, 2) or input_grad:
                raise ValueError(
                    "brick backend supports input_dim=3, n_features=2, "
                    "input_grad=False; use backend='xla' otherwise")
            self.layout = hk.make_brick_layout(
                n_levels, base_resolution, finest_resolution,
                log2_bricks=log2_bricks, per_level_scale=per_level_scale)
            shape = (self.layout.n_rows, hk.ROW)
        else:
            scales, offsets, use_hash, table_size = _level_layout(
                input_dim, n_levels, log2_hashmap_size, base_resolution,
                finest_resolution, per_level_scale)
            self.layout = HashLayout(tuple(scales), tuple(offsets),
                                     tuple(use_hash), table_size, input_dim,
                                     n_features, input_grad)
            shape = (offsets[-1], n_features)
        self.table = uniform_parameter(shape, generator)

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None,
                 **overrides):
        """The encoder of a config section (:func:`grid_options`)."""
        return cls(**{**grid_options(enc_cfg), **overrides},
                   generator=generator)

    def to_unit(self, x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Points (N, D) -> [0,1]^D: normalised to the bounds when set and
        ``normalize``, then clipped with ``jnp.clip``'s gradient, half of it
        at a bound (a point of frame 0 has t = 0 on a 4-D grid)."""
        if normalize:
            x = _normalize(self, x)
        return torch.minimum(torch.maximum(x, x.new_zeros(())),
                             x.new_ones(()))

    def forward(self, x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """(..., D) -> (..., L*F)."""
        shape = x.shape[:-1]
        x = self.to_unit(x.reshape(-1, self.input_dim), normalize)
        if self.backend == "brick":
            out = hk.BrickHashEncodeFn.apply(self.layout, self.table,
                                             x.float().contiguous())
        else:
            table = self.table
            if self.compute_dtype != "float32":
                table = table.to(getattr(torch, self.compute_dtype))
            out = hash_encode(self.layout, table, x)
        return out.reshape(*shape, self.output_dim)


def grid_options(enc_cfg) -> dict:
    """:class:`HashGridEncoder`'s arguments from a config section, read by
    the JAX package's names and the reference YAML's (``num_levels``,
    ``level_dim``, ``desired_resolution``, ``bbox``); flags are strict
    booleans. A grid from a config has no input gradient unless it asks
    for one (sample positions carry none)."""
    g = enc_cfg.get
    return dict(
        input_dim=int(g("input_dim", 3)),
        n_levels=int(g("n_levels", g("num_levels", 16))),
        n_features=int(g("n_features", g("level_dim", 2))),
        log2_hashmap_size=int(g("log2_hashmap_size", 19)),
        base_resolution=int(g("base_resolution", 16)),
        finest_resolution=int(g("finest_resolution",
                                g("desired_resolution", -1))),
        per_level_scale=float(g("per_level_scale", 2.0)),
        bounds=_cfg_bounds(enc_cfg),
        input_grad=as_bool(g("input_grad", False), "input_grad"),
        sorted_bwd=as_bool(g("sorted_bwd", True), "sorted_bwd"),
        compute_dtype=str(g("compute_dtype", "float32")),
        backend=str(g("backend", "xla")),
        log2_bricks=int(g("log2_bricks", 12)))


def grid_kw(enc_cfg, **overrides) -> dict:
    """The seven grid fields of ``enc_cfg`` that the composite encoders
    hand their sub-grids; the sub-grids keep the module defaults for the
    rest (the xla backend, the input gradient on)."""
    options = grid_options(enc_cfg)
    return {**{f: options[f] for f in _GRID_FIELDS}, **overrides}


def _cfg_bounds(enc_cfg) -> tuple:
    return tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ())))


def _grid_output_dim(kw: dict) -> int:
    return kw["n_levels"] * kw["n_features"]


class TriPlaneEncoder(nn.Module):
    """Three 2-D grids over (x, y), (y, z) and (x, z), concatenated."""

    def __init__(self, plane_kw: dict, bounds=(),
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.plane_kw, self.bounds = dict(plane_kw), tuple(bounds)
        _register_box(self, self.bounds)
        self.xy_plane = HashGridEncoder(**plane_kw, generator=generator)
        self.yz_plane = HashGridEncoder(**plane_kw, generator=generator)
        self.xz_plane = HashGridEncoder(**plane_kw, generator=generator)
        self.output_dim = 3 * _grid_output_dim(plane_kw)

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        return cls(grid_kw(enc_cfg, input_dim=2), _cfg_bounds(enc_cfg),
                   generator)

    def planes(self, xyz: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.xy_plane(xyz[..., [0, 1]], normalize=False),
            self.yz_plane(xyz[..., [1, 2]], normalize=False),
            self.xz_plane(xyz[..., [0, 2]], normalize=False)], dim=-1)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.planes(_normalize(self, xyz))


class Motion2DEncoder(TriPlaneEncoder):
    """Triplane + a time-conditioned deformation MLP (``mlp_width`` x
    ``mlp_depth``, then 3 outputs through a sigmoid): points of frames
    t > 0 move by 2 sigmoid - 1, clipped to [0,1]; t is divided by
    num_frames - 1."""

    def __init__(self, plane_kw: dict, bounds=(), num_frames: int = 2,
                 mlp_width: int = 128, mlp_depth: int = 8,
                 generator: torch.Generator | None = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        super().__init__(plane_kw, bounds, generator)
        self.num_frames = num_frames
        self.mlp = nn.ModuleList(
            dense(4 if i == 0 else mlp_width, mlp_width, generator)
            for i in range(mlp_depth))
        self.mlp_out = dense(mlp_width, 3, generator)

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        return cls(grid_kw(enc_cfg, input_dim=2), _cfg_bounds(enc_cfg),
                   int(enc_cfg.get("num_frames", 2)), generator=generator)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = _normalize(self, xyzt[..., :3])
        t = frame_time(xyzt[..., 3:], self.num_frames - 1)
        h = torch.cat([xyz, t], dim=-1)
        for layer in self.mlp:
            h = torch.relu(layer(h))
        delta = torch.sigmoid(self.mlp_out(h))
        warped = torch.clamp(xyz + 2.0 * delta - 1.0, 0.0, 1.0)
        return self.planes(torch.where(t > 0, warped, xyz))


class HashLatentEncoder(nn.Module):
    """A 3-D grid of xyz and a per-frame latent code (frame int(t),
    clipped), concatenated."""

    def __init__(self, grid_kw: dict, bounds=(), num_frames: int = 2,
                 latent_dim: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.bounds, self.num_frames = tuple(bounds), num_frames
        _register_box(self, self.bounds)
        self.grid = HashGridEncoder(**grid_kw, generator=generator)
        self.latent_t = uniform_parameter((num_frames, latent_dim), generator)
        self.output_dim = _grid_output_dim(grid_kw) + latent_dim

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        return cls(grid_kw(enc_cfg), _cfg_bounds(enc_cfg),
                   int(enc_cfg.get("num_frames", 2)),
                   int(enc_cfg.get("latent_dim", 32)), generator)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = _normalize(self, xyzt[..., :3])
        t_idx = xyzt[..., 3].long().clamp(0, self.num_frames - 1)
        return torch.cat([self.grid(xyz, normalize=False),
                          self.latent_t[t_idx]], dim=-1)


class HashGrid4DEncoder(nn.Module):
    """A 4-D grid of (xyz, t / num_frames)."""

    def __init__(self, grid_kw: dict, bounds=(), num_frames: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bounds, self.num_frames = tuple(bounds), num_frames
        _register_box(self, self.bounds)
        self.grid = HashGridEncoder(**grid_kw, generator=generator)
        self.output_dim = _grid_output_dim(grid_kw)

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        return cls(grid_kw(enc_cfg, input_dim=4), _cfg_bounds(enc_cfg),
                   int(enc_cfg.get("num_frames", 2)), generator)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = _normalize(self, xyzt[..., :3])
        t = frame_time(xyzt[..., 3:], self.num_frames)
        return self.grid(torch.cat([xyz, t], dim=-1), normalize=False)


class HashCoefEncoder(nn.Module):
    """``basis_num`` 3-D basis grids mixed by a softmax over a 4-D
    coefficient grid (``input_dim`` 4, ``log2_hashmap_size`` 20) of
    (xyz, t / num_frames) through a 64-wide layer."""

    def __init__(self, grid_kw: dict, bounds=(), num_frames: int = 2,
                 basis_num: int = 6,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.bounds, self.num_frames = tuple(bounds), num_frames
        _register_box(self, self.bounds)
        self.basis = nn.ModuleList(
            HashGridEncoder(**grid_kw, generator=generator)
            for _ in range(basis_num))
        self.coefs = HashGridEncoder(**{**grid_kw, "input_dim": 4,
                                        "log2_hashmap_size": 20},
                                     generator=generator)
        self.coef_mlp_hidden = dense(self.coefs.output_dim, 64, generator)
        self.coef_mlp_out = dense(64, basis_num, generator)
        self.output_dim = _grid_output_dim(grid_kw)

    @classmethod
    def from_cfg(cls, enc_cfg, generator: torch.Generator | None = None):
        return cls(grid_kw(enc_cfg), _cfg_bounds(enc_cfg),
                   int(enc_cfg.get("num_frames", 2)),
                   int(enc_cfg.get("basis_num", 6)), generator)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = _normalize(self, xyzt[..., :3])
        t = frame_time(xyzt[..., 3:], self.num_frames)
        h = torch.relu(self.coef_mlp_hidden(
            self.coefs(torch.cat([xyz, t], dim=-1), normalize=False)))
        coefs = torch.softmax(self.coef_mlp_out(h), dim=-1)
        embs = torch.stack([g(xyz, normalize=False) for g in self.basis],
                           dim=-2)                         # (N, K, E)
        return (embs * coefs[..., None]).sum(dim=-2)
