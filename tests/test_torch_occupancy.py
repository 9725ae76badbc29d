"""Port parity for the occupancy grid (nerf_replication_tpu_torch/ops/
occupancy.py), ``ray_ops.ray_aabb_intersect`` and ``Network.density``
against the JAX package. The lookups are compared bit for bit with the
JAX functions compiled as the JAX frame renderer compiles them (under
``jax.jit``, the bbox a constant). The rays are dyadic, so every sample
position is exact in float32 whichever way it is computed (XLA's CPU
build contracts ``o + d * t`` into an FMA), and many samples sit exactly
on cell faces."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import default_cfg, load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.ops import occupancy as jocc
from nerf_replication_tpu.ops.ray_ops import (
    ray_aabb_intersect as jax_ray_aabb_intersect,
)
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch.models.nerf.network import make_network
from nerf_replication_tpu_torch.ops import occupancy
from nerf_replication_tpu_torch.ops.ray_ops import ray_aabb_intersect
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BBOX = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def cube_sigma(m):
    """A box field: density 30 (0.8 - max |x_i|), exact in float32 in
    either framework (no product to fuse, no rounding in the max)."""
    return 30.0 * (0.8 - m)


def jax_density(params, pts):
    return cube_sigma(jnp.max(jnp.abs(pts), axis=-1))


def port_density(pts):
    return cube_sigma(pts.abs().amax(dim=-1))


def grids(seed):
    """Random grids at three densities, one touching every face of the
    lattice, and an empty and a full one, (R, R, R) uint8."""
    g = np.random.default_rng(seed)
    r = 16
    out = [(g.random((r, r, r)) < p).astype(np.uint8) for p in (0.02, 0.1)]
    edge = np.zeros((r, r, r), np.uint8)
    edge[0, 3, 5] = edge[-1, 6, 2] = edge[4, 0, 7] = edge[2, -1, 1] = 1
    edge[5, 5, 0] = edge[7, 8, -1] = edge[-1, -1, -1] = edge[0, 0, 0] = 1
    return out + [edge, np.zeros((r, r, r), np.uint8),
                  np.ones((r, r, r), np.uint8)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("which", range(5))
def test_dilate_bit_equal(k, which):
    """Max-pool dilation, the wrapped high border included."""
    grid = grids(k)[which]
    ref = jocc._dilate(grid, k)
    out = occupancy._dilate(torch.from_numpy(grid), k).numpy()
    np.testing.assert_array_equal(out, ref)
    if which == 2:   # the edge grid: the high border wraps in from low
        assert out[-1].any() and ref.dtype == out.dtype


@pytest.mark.parametrize("resolution,dilate,chunk", [(16, 2, 1000),
                                                     (24, 1, 4096)])
def test_build_occupancy_grid_bit_equal(resolution, dilate, chunk):
    """The lattice, the chunked density query, the float32 threshold and
    the dilation; a chunk that does not divide R^3 (the JAX package pads,
    the port takes a short last chunk)."""
    ref, ref_bbox = jocc.build_occupancy_grid(
        jax_density, None, resolution=resolution, threshold=0.02,
        dilate=dilate, chunk=chunk)
    out, bbox = occupancy.build_occupancy_grid(
        port_density, resolution=resolution, threshold=0.02, dilate=dilate,
        chunk=chunk)
    assert bbox == ref_bbox
    assert out.dtype == torch.uint8 and 0 < ref.mean() < 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def dyadic_rays(n, seed):
    """Rays with dyadic origins and directions: samples at dyadic depths
    are exact. A quarter of the rays are axis-parallel at a cell face's
    coordinate, some start outside the bbox pointing away."""
    g = np.random.default_rng(seed)
    ro = g.integers(-96, 97, (n, 3)) / 64.0
    ro[:, 2] = g.choice([-4.0, 4.0], n)
    rd = g.integers(-64, 65, (n, 3)) / 64.0
    rd[:, 2] = -np.sign(ro[:, 2]) * g.integers(16, 65, n) / 64.0
    q = n // 4
    ro[:q, 0] = -1.5 + g.integers(0, 17, q) * 0.1875   # on an x face
    rd[:q, 0] = 0.0
    rd[q:2 * q] *= -1.0                                 # pointing away
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.fixture(scope="module")
def lookup_case():
    grid = grids(3)[1]
    ro, rd = dyadic_rays(512, 0)
    t = (2.0 + np.arange(40) / 8.0).astype(np.float32)
    return grid, ro, rd, t


def near_faces(r, ulps=48):
    """float32 coordinates within ``ulps`` of every cell face of an
    ``r``-cell axis of BBOX."""
    out = [np.float32(-1.5 + np.arange(r + 1) * 3.0 / r)]
    for to in (np.inf, -np.inf):
        x = out[0]
        for _ in range(ulps):
            x = np.nextafter(x, np.float32(to))
            out.append(x)
    return np.concatenate(out)


def test_points_occupied_bit_equal(lookup_case):
    """The samples of the dyadic rays, then points within a few ulps of
    the cell faces, where a quotient and XLA's product by the reciprocal
    pick different cells."""
    grid, ro, rd, t = lookup_case
    pts = ro[:, None] + rd[:, None] * t[None, :, None]
    assert (pts * 64 * 8 == np.round(pts * 64 * 8)).all()   # exact
    g = np.random.default_rng(7)
    coords = near_faces(grid.shape[0])
    near = g.choice(coords, (4096, 3)).astype(np.float32)
    lookup = jax.jit(lambda p, g: jocc.points_occupied(p, g, BBOX))
    for p in (pts, near):
        ref = np.asarray(lookup(p, grid))
        out = occupancy.points_occupied(torch.from_numpy(p),
                                        torch.from_numpy(grid), BBOX)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert 0 < out.float().mean() < 1
    quotient = ((near + np.float32(1.5)) / np.float32(3.0)
                * np.float32(grid.shape[0])).astype(np.int32)
    product = ((near + np.float32(1.5)) * (np.float32(1) / np.float32(3.0))
               * np.float32(grid.shape[0])).astype(np.int32)
    assert (quotient != product).any()   # the case can see the difference


@pytest.mark.parametrize("margin", [0.0, 0.1875])
def test_ray_spans_bit_equal(lookup_case, margin):
    grid, ro, rd, t = lookup_case
    ref = jax.jit(lambda o, d, tt, g: jocc.ray_spans(o, d, tt, g, BBOX,
                                                     margin=margin))(
        ro, rd, t, grid)
    out = occupancy.ray_spans(torch.from_numpy(ro), torch.from_numpy(rd),
                              torch.from_numpy(t), torch.from_numpy(grid),
                              BBOX, margin=margin)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < out[0].float().mean() < 1


def test_rays_active_bit_equal(lookup_case):
    """Shared (S,) depths and per-ray (N, S) depths."""
    grid, ro, rd, t = lookup_case
    t_rays = t[None] + (np.arange(len(ro)) % 4)[:, None] / 16.0
    for tt in (t, t_rays.astype(np.float32)):
        ref = jax.jit(lambda o, d, x, g: jocc.rays_active(o, d, x, g, BBOX))(
            ro, rd, tt, grid)
        out = occupancy.rays_active(torch.from_numpy(ro),
                                    torch.from_numpy(rd), torch.from_numpy(tt),
                                    torch.from_numpy(grid), BBOX)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_ray_aabb_intersect_bit_equal(lookup_case):
    """Hits, misses, rays behind the box, axis-parallel rays (zero
    direction components) and a ray that starts inside."""
    _, ro, rd, _ = lookup_case
    ro = np.concatenate([ro, np.zeros((1, 3), np.float32)])
    rd = np.concatenate([rd, np.float32([[0.0, 0.0, 1.0]])])
    lo, hi = (-1.2, -1.0, -0.8), (1.2, 1.0, 0.8)
    ref = jax.jit(lambda o, d: jax_ray_aabb_intersect(o, d, lo, hi, 2.0,
                                                      6.0))(ro, rd)
    out = ray_aabb_intersect(torch.from_numpy(ro), torch.from_numpy(rd), lo,
                             hi, 2.0, 6.0)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    hit = out[2].numpy()
    assert hit[-1] and 0 < hit.mean() < 1


@pytest.mark.parametrize("model", ["fine", ""])
def test_network_density_matches_jax(model):
    """``Network.density`` (zero view directions) on the trained
    data/pretrain/hard weights against the JAX package's, 256 points in
    the box. Both run bf16 matmuls rounded at different places, so the
    raw densities agree to the bf16 bound of tests/test_torch_network.py
    relative to their range."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = load_cfg_tree("configs/nerf/hard.yaml", default_cfg())
    finally:
        os.chdir(cwd)
    tree = jax_load(os.path.join(ROOT, "data", "pretrain", "hard"))
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(tree))
    jnet = jax_make_network(cfg)
    pts = np.random.default_rng(5).uniform(-1.2, 1.2, (256, 3)).astype(
        np.float32)
    ref = np.asarray(jnet.apply(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(pts), model=model,
                                method=jnet.density))
    with torch.no_grad():
        out = net.density(torch.from_numpy(pts), model=model).numpy()
    assert out.shape == ref.shape == (256,)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-2, rtol=5e-2)
    assert np.median(np.abs(out - ref)) / scale < 2e-3
