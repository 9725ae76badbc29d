"""The two radiance fields of the benchmark in plain PyTorch: the NeRF
paper's 8x256 MLP on frequency encodings, and the Instant-NGP MLP on a
bricked multi-level hash grid with spherical-harmonics directions.

Written from the published descriptions and the configurations in
``benchmark/configs``, independent of the measured program: it imports
nothing of it. Weights are a dict of float32 tensors under the names
``{coarse,fine}.pts.{i}.weight`` (out, in), ``.bias``, ``alpha``,
``feature``, ``views.{i}``, ``rgb`` and ``xyz_encoder.table``, the
layout of the checkpoints in ``data/pretrain`` once their Flax kernels
are transposed (:func:`load_checkpoint`).

Every product goes through :class:`Precision`: ``float32`` (the
reference; run it with TF32 off), or one of the controls, the precision
below the one each configuration states: ``tf32`` (operands rounded to
10 mantissa bits, the tensor cores' TF32 product) and ``fp8`` (operands
and outputs scaled per tensor into e4m3 and rounded).
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

_INDEXED = re.compile(r"^(.*)_(\d+)$")


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """``{"net": {"params": tree}}`` pickled numpy (a Flax tree) -> the
    weight dict: Dense kernels (in, out) transposed to (out, in),
    ``pts_3`` named ``pts.3``, other leaves as they are."""
    with open(path, "rb") as f:
        tree = pickle.load(f)["net"]["params"]
    out = {}

    def walk(node, prefix):
        if "kernel" in node:
            out[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(node["kernel"], np.float32).T))
            out[prefix + "bias"] = torch.from_numpy(
                np.asarray(node["bias"], np.float32).copy())
            return
        for name, child in node.items():
            if not isinstance(child, dict):
                out[prefix + name] = torch.from_numpy(
                    np.asarray(child, np.float32).copy())
                continue
            m = _INDEXED.match(name)
            walk(child, prefix + (f"{m[1]}.{m[2]}." if m else f"{name}."))

    walk(tree, "")
    return out


# -- precision ----------------------------------------------------------------

def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 (10 mantissa bits), ties away from zero."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled e4m3: the largest magnitude maps to 448."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How a product ``x @ w.T + b`` is computed: ``name`` is float32, tf32
    or fp8. Each follows the policy of the configuration it controls: a
    float32 configuration keeps f32 outputs, so TF32 rounds the operands
    only; the bf16 one rounds every product's output to its type as well
    (Flax's ``Dense(dtype=...)``), so fp8 rounds the operands and the
    output. Rounding goes through a straight-through gradient."""

    ROUND = {"float32": (None, None), "tf32": (round_tf32, None),
             "fp8": (round_fp8, round_fp8)}

    def __init__(self, name: str = "float32"):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @staticmethod
    def _round(t, r):
        return t if r is None else t + (r(t) - t).detach()

    def linear(self, x, w, b):
        operands, output = self.ROUND[self.name]
        return self._round(torch.nn.functional.linear(
            self._round(x, operands), self._round(w, operands),
            self._round(b, operands)), output)


# -- encodings ----------------------------------------------------------------

def freq_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF's positional encoding: ``[x, sin(2^0 x), cos(2^0 x), ...]``."""
    feats = [x]
    for i in range(n_freqs):
        feats += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(feats, dim=-1)


def sh_encode(dirs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 values, Instant-NGP's
    convention) of directions normalised by ``|d| + 1e-8``."""
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.4886025119029199 * y, 0.4886025119029199 * z,
        -0.4886025119029199 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.31539156525252005 * (2.0 * zz - xx - yy),
        -1.0925484305920792 * xz, 0.5462742152960396 * (xx - yy),
        -0.5900435899266435 * y * (3 * xx - yy), 2.890611442640554 * xy * z,
        -0.4570457994644658 * y * (4 * zz - xx - yy),
        0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
        -0.4570457994644658 * x * (4 * zz - xx - yy),
        1.445305721320277 * z * (xx - yy),
        -0.5900435899266435 * x * (xx - 3 * yy)], dim=-1)


# -- the bricked hash grid ----------------------------------------------------

BRICK, BW, ROW = 4, 5, 256        # cells a brick side, vertices, row lanes
BF16_MAX_ROWS = 4096              # levels this small store bf16 values
_P1, _P2, _U32 = 2654435761, 805459861, 0xFFFFFFFF


class BrickGrid:
    """Levels of 4^3-cell bricks, one table row of 256 lanes a brick:
    feature 0 of vertex ``vx*25 + vy*5 + vz`` at lane v, feature 1 at
    128 + v. Level l has ``ceil(base * b^l)`` cells a side, ``b`` the
    growth from ``base`` to ``finest``; a level of more bricks than
    ``2^log2_bricks`` hashes the brick coordinate with Instant-NGP's XOR
    primes into the largest power of two that fits its rows. The
    configuration stores levels of at most 4096 rows in bfloat16: a read
    rounds the value, and each (point, corner) contribution to the table
    gradient is rounded before it is summed."""

    def __init__(self, n_levels, base, finest, log2_bricks, bounds):
        b = (finest / base) ** (1.0 / (n_levels - 1))
        cap = 2 ** log2_bricks
        self.res, self.bsides, self.offsets, self.hashed = [], [], [0], []
        for level in range(n_levels):
            res = int(np.ceil(base * b ** level))
            bs = -(-res // BRICK)
            rows = int(np.ceil(min(bs ** 3, cap) / 128) * 128)
            self.res.append(res)
            self.bsides.append(bs)
            self.hashed.append(bs ** 3 > cap)
            self.offsets.append(self.offsets[-1] + rows)
        self.n_rows = self.offsets[-1]
        lo = np.asarray(bounds[:3], np.float32)
        hi = np.asarray(bounds[3:], np.float32)
        side = np.float32(np.max(hi - lo) + np.float32(1e-6))
        self.lo, self.hi = lo, hi
        self.inv_side = np.float32(1.0) / side

    def rows(self, level):
        return self.offsets[level + 1] - self.offsets[level]

    def to_unit(self, x):
        lo = torch.as_tensor(self.lo, device=x.device)
        hi = torch.as_tensor(self.hi, device=x.device)
        u = (torch.minimum(torch.maximum(x, lo), hi) - lo) * float(
            self.inv_side)
        return u.clamp(0.0, 1.0)

    def corners(self, x):
        """Per level: (flat table index (N, 8, 2) of the two features of
        each corner, weight (N, 8))."""
        out = []
        for level, res in enumerate(self.res):
            pos = x * res
            cell = torch.clamp(torch.floor(pos), 0.0, res - 1.0)
            frac = pos - cell
            c = cell.long()
            bc = c // BRICK
            if self.hashed[level]:
                h = bc[:, 0] ^ ((bc[:, 1] * _P1) & _U32) \
                    ^ ((bc[:, 2] * _P2) & _U32)
                bid = h % (1 << int(np.floor(np.log2(self.rows(level)))))
            else:
                bs = self.bsides[level]
                bid = (bc[:, 0] * bs + bc[:, 1]) * bs + bc[:, 2]
            base = (self.offsets[level] + bid) * ROW
            loc = c & (BRICK - 1)
            idx, wts = [], []
            for k in range(8):
                d = ((k >> 2) & 1, (k >> 1) & 1, k & 1)
                v = ((loc[:, 0] + d[0]) * BW * BW + (loc[:, 1] + d[1]) * BW
                     + (loc[:, 2] + d[2]))
                w = [frac[:, a] if d[a] else 1.0 - frac[:, a]
                     for a in range(3)]
                idx.append(torch.stack([base + v, base + 128 + v], -1))
                wts.append(w[0] * w[1] * w[2])
            out.append((torch.stack(idx, 1), torch.stack(wts, 1)))
        return out

    def encode(self, table, x):
        """World points (N, 3) -> features (N, 2L)."""
        return _BrickEncode.apply(table, self.to_unit(x), self)


class _BrickEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, grid):
        ctx.grid = grid
        ctx.save_for_backward(x)
        flat = table.reshape(-1)
        feats = []
        for level, (idx, w) in enumerate(grid.corners(x)):
            vals = flat[idx]                                 # (N, 8, 2)
            if grid.rows(level) <= BF16_MAX_ROWS:
                vals = round_bf16(vals)
            feats.append((w[..., None] * vals).sum(1))
        ctx.table_shape = table.shape
        return torch.cat(feats, -1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grid = ctx.grid
        dflat = g.new_zeros(int(np.prod(ctx.table_shape)))
        for level, (idx, w) in enumerate(grid.corners(x)):
            c = w[..., None] * g[:, None, 2 * level:2 * level + 2]
            if grid.rows(level) <= BF16_MAX_ROWS:
                c = round_bf16(c)
            dflat.index_add_(0, idx.reshape(-1), c.reshape(-1))
        return dflat.reshape(ctx.table_shape), None, None


# -- the MLPs ---------------------------------------------------------------

def mlp(w: dict, prefix: str, x, v, depth: int, skips, prec: Precision):
    """NeRF's MLP: ``depth`` ReLU layers with the input re-joined as
    ``[x, h]`` after each layer in ``skips``; density from ``alpha``; a
    linear ``feature`` layer joined with the direction features; one ReLU
    view layer; ``rgb``. Returns raw ``[rgb, sigma]`` (N, 4)."""
    def dense(name, h):
        return prec.linear(h, w[f"{prefix}.{name}.weight"],
                           w[f"{prefix}.{name}.bias"])

    h = x
    for i in range(depth):
        h = torch.relu(dense(f"pts.{i}", h))
        if i in skips:
            h = torch.cat([x, h], -1)
    sigma = dense("alpha", h)
    h = torch.cat([dense("feature", h), v], -1)
    h = torch.relu(dense("views.0", h))
    return torch.cat([dense("rgb", h), sigma], -1)


class Field:
    """A configuration's field: ``field(w, pts (..., 3), dirs (..., 3)
    broadcastable, branch) -> raw (..., 4)``. ``model`` is the
    configuration's ``model`` section."""

    def __init__(self, model: dict, prec: Precision | None = None):
        self.model = model
        self.prec = prec or Precision("float32")
        self.kind = model["kind"]
        if self.kind == "ngp":
            g = model["grid"]
            self.grid = BrickGrid(g["num_levels"], g["base_resolution"],
                                  g["desired_resolution"], g["log2_bricks"],
                                  g["bounds"])

    def __call__(self, w, pts, dirs, branch="coarse"):
        shape = pts.shape[:-1]
        dirs = dirs.expand(*shape, 3)
        m = self.model
        p, d = pts.reshape(-1, 3), dirs.reshape(-1, 3)
        if self.kind == "ngp":
            x = self.grid.encode(w["xyz_encoder.table"], p)
            v = sh_encode(d)
        else:
            x = freq_encode(p, m["xyz_freqs"])
            v = freq_encode(d, m["dir_freqs"])
        raw = mlp(w, branch, x, v, m["D"], tuple(m["skips"]), self.prec)
        return raw.reshape(*shape, 4)
