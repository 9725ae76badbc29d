"""Port parity for the compacted renders of the volume renderer:
``Renderer(net, settings=...)``, ``Renderer.render`` with
``fast_sampling``, ``Renderer.render_image_fast`` (hit and miss rays),
``Renderer.make_frame_renderer`` (with and without an occupancy grid, with
the segmented ERT fine pass, uint8, its stats), ``run_evaluate`` with
``task_arg.fast_sampling``, and the frame bench's ``freq`` family, against
the JAX package on the CPU. Fields: an analytic sphere written in both
frameworks, and a small network (4 layers, 32 wide, float32, the JAX
package's seed-0 init carried over by ``params_from_jax``) with that
sphere's density added; the bench runs the trained data/pretrain/hard.

The frames use camera poses whose rotation is exact (axis-aligned) and
pixel directions that are dyadic, so that both frameworks make the same
rays; only the normalised direction's sample points can differ, by the
one rounding that XLA's CPU build saves by contracting ``o + d * t``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    Renderer as JaxRenderer,
)
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    RenderSettings as JaxSettings,
)
from nerf_replication_tpu.ops import occupancy as jocc
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch import raymarch_bench, run
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models.nerf.renderer import (
    Renderer,
    RenderSettings,
)
from nerf_replication_tpu_torch.models.nerf.renderer import volume_renderer \
    as tv
from nerf_replication_tpu_torch.ops import mlp_kernel
from nerf_replication_tpu_torch.parallel.mesh import Mesh
from nerf_replication_tpu_torch.utils import synthetic_scene
from test_torch_fast_render import small_network

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_sphere(p, pts, viewdirs, model=""):
    sigma = 30.0 * (0.8 - jnp.linalg.norm(pts, axis=-1))
    return jnp.concatenate([pts * 2.0 + 0.1 * viewdirs, sigma[..., None]], -1)


def port_sphere(pts, viewdirs, model=""):
    sigma = 30.0 * (0.8 - torch.linalg.norm(pts, dim=-1))
    return torch.cat([pts * 2.0 + 0.1 * viewdirs, sigma[..., None]], -1)


class JaxNet:
    """A JAX-package network stand-in: ``apply`` is the field."""

    def __init__(self, apply_fn):
        self.apply_fn = apply_fn

    def apply(self, params, pts, viewdirs, model=""):
        return self.apply_fn(params, pts, viewdirs, model)


@pytest.fixture(scope="module")
def fields():
    """name -> (JAX apply, port apply)."""
    return {"sphere": (jax_sphere, port_sphere), "small": small_network()}


def renderers(fields, name, **kw):
    """The same settings ``kw`` in a JAX and a port renderer through the
    field ``name``. The port renderer's network only sets the device."""
    jax_apply, port_apply = fields[name]
    holder = torch.nn.Linear(1, 1)
    return (JaxRenderer(JaxNet(jax_apply), settings=JaxSettings(**kw),
                        mesh=None),
            Renderer(holder, settings=RenderSettings(**kw)).use_apply(
                port_apply))


BASE = dict(N_samples=16, N_importance=16, density_activation="softplus",
            ray_chunk=64)


def test_renderer_takes_settings_and_renders_without_masks(fields):
    """``settings=`` replaces the config; eval turns the masks off and
    ``render`` goes through render_image_fast with fast_sampling and a
    fine pass only."""
    _, r = renderers(fields, "sphere", **BASE, fast_sampling=True)
    assert r.settings.fast_sampling and not r.eval_settings.fast_sampling
    ro, rd = rays_mixed()
    batch = {"rays_o": ro.reshape(2, -1, 3), "rays_d": rd.reshape(2, -1, 3)}
    rgb, depth = r.render(batch)
    fast = r.render_image_fast(ro, rd)
    torch.testing.assert_close(rgb, fast["rgb"], atol=0, rtol=0)
    torch.testing.assert_close(depth, fast["depth"], atol=0, rtol=0)
    r.settings = dataclasses.replace(r.settings, N_importance=0)
    rgb0, _ = r.render(batch)
    torch.testing.assert_close(rgb0, r.render_rays_batch(ro, rd)["rgb"],
                               atol=0, rtol=0)


# --- render_image_fast --------------------------------------------------------

def rays_mixed(n_hit=40, n_miss=56, seed=0):
    """Rays from (0, 0, 4) at the radius-0.8 sphere and rays beside it."""
    g = np.random.default_rng(seed)
    hit = g.normal(size=(n_hit, 3)) * 0.1 + [0.0, 0.0, -1.0]
    miss = g.normal(size=(n_miss, 3)) * 0.05 + [0.5, 0.5, -1.0]
    rd = np.concatenate([hit, miss])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    order = g.permutation(len(rd))
    ro = np.tile([[0.0, 0.0, 4.0]], (len(rd), 1))
    return ro.astype(np.float32), rd[order].astype(np.float32)


@pytest.mark.parametrize("field", ["sphere", "small"])
@pytest.mark.parametrize("chunk", [16, 40, 96])
def test_render_image_fast_matches_jax(fields, field, chunk):
    """rgb, depth, acc within 1e-5 (depth 2e-5) of the JAX package's on
    hit and miss rays; the hit rays are the port's dense render's, and the
    miss rays keep the coarse composite (white)."""
    jr, r = renderers(fields, field, **{**BASE, "ray_chunk": chunk},
                      fast_sampling=True)
    ro, rd = rays_mixed()
    ref = jr.render_image_fast(None, ro, rd)
    out = r.render_image_fast(ro, rd)
    for k, atol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 2e-5)):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=atol, rtol=0)
    dense = r.render_rays_batch(ro, rd)
    hit = out["acc"] > 1e-3
    assert 0 < int(hit.sum()) < len(ro)
    torch.testing.assert_close(out["rgb"][hit], dense["rgb"][hit],
                               atol=1e-6, rtol=0)
    coarse = r._render_chunks(*r._rays(ro, rd), dataclasses.replace(
        r.eval_settings, N_importance=0))
    torch.testing.assert_close(out["rgb"][~hit], coarse["rgb"][~hit],
                               atol=0, rtol=0)
    if field == "sphere":
        np.testing.assert_allclose(out["rgb"][~hit].numpy(), 1.0, atol=1e-3)


def test_render_image_fast_runs_the_fine_pass_on_active_rays_only(fields):
    """With every ray a miss, one coarse pass and nothing else."""
    _, r = renderers(fields, "sphere", **BASE, fast_sampling=True)
    calls = []

    def counting(pts, viewdirs, model=""):
        calls.append((model, pts.shape[0]))
        return port_sphere(pts, viewdirs, model)

    r.use_apply(counting)
    ro, rd = rays_mixed(n_hit=0)
    out = r.render_image_fast(ro, rd)
    assert calls == [("", 56)]
    np.testing.assert_allclose(out["rgb"].numpy(), 1.0, atol=1e-3)
    calls.clear()
    ro, rd = rays_mixed(n_hit=5, n_miss=30)
    r.render_image_fast(ro, rd)
    assert calls == [("", 35), ("", 35), ("fine", 35)]


# --- make_frame_renderer ------------------------------------------------------

def pose_at(x=1.5, z=4.0):
    """Camera at (x, 0, z) looking down -z: an exact rotation, a dyadic
    origin; off the sphere's axis, so that some rays miss it."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3], c2w[2, 3] = x, z
    return c2w


@pytest.fixture(scope="module")
def grids(fields):
    """name -> ((grid, bbox, 2), (grid, bbox, 1)): 16^3 grids of each
    field's softplus density (threshold 0.5), dilated 2 and 1 cells, as the
    JAX package builds them."""
    out = {}
    for name, (jax_apply, _) in fields.items():
        def density(p, x, f=jax_apply):
            return jax.nn.softplus(
                f(None, x[:, None, :], jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])

        out[name] = tuple(
            jocc.build_occupancy_grid(density, None, resolution=16,
                                      threshold=0.5, dilate=d) + (d,)
            for d in (2, 1))
    return out


FRAMES = {
    # (H, W, focal, renderer kw, frame kw, grid: None | dilate)
    "dense": (16, 16, 16.0, {}, dict(capacity=0.6), None),
    "full": (16, 16, 16.0, {}, dict(capacity=1.0), None),
    "occ_sub1": (16, 16, 16.0, {}, dict(capacity=0.5), 1),
    "occ_sub4": (32, 32, 128.0, {}, dict(capacity=0.4), 2),
    "occ_sub2": (24, 24, 64.0, {}, dict(capacity=0.3,
                                        coarse_capacity=0.5), 2),
    "overflow": (16, 16, 16.0, dict(ray_chunk=16),
                 dict(capacity=0.05, coarse_capacity=0.1), 1),
    "ert2": (16, 16, 16.0, dict(ert_segments=2), dict(capacity=0.75), 1),
    "ert3_frac": (16, 16, 16.0, dict(ert_segments=3, ert_frac=(0.6,),
                                     ert_split=0.5),
                  dict(capacity=1.0), None),
    "uint8": (32, 32, 128.0, dict(ert_segments=2), dict(
        capacity=0.4, out_dtype="uint8"), 2),
}


def frames_both(fields, grids, field, case, pose):
    H, W, focal, rkw, fkw, dilate = FRAMES[case]
    jr, r = renderers(fields, field, **{**BASE, **rkw})
    fkw = dict(fkw)
    uint8 = fkw.pop("out_dtype", None) == "uint8"
    occupancy = None
    if dilate is not None:
        occupancy = grids[field][0 if dilate == 2 else 1]
    jfn = jr.make_frame_renderer(
        H, W, focal, occupancy=occupancy, return_stats=True,
        out_dtype=jnp.uint8 if uint8 else jnp.float32, **fkw)
    fn = r.make_frame_renderer(
        H, W, focal, return_stats=True,
        occupancy=None if occupancy is None else
        (torch.from_numpy(np.asarray(occupancy[0])),) + occupancy[1:],
        out_dtype=torch.uint8 if uint8 else torch.float32, **fkw)
    ref, ref_stats = jfn(None, jnp.asarray(pose))
    out, stats = fn(pose)
    return ((np.asarray(ref), {k: int(v) for k, v in ref_stats.items()}),
            (out.numpy(), {k: int(v) for k, v in stats.items()}), fn.budget)


# every case on the sphere, the network on those that run its MLP most
FRAME_CASES = [(c, "sphere") for c in sorted(FRAMES)] + [
    (c, "small") for c in ("dense", "occ_sub1", "ert2", "uint8")]


@pytest.mark.parametrize("case,field", FRAME_CASES)
def test_frame_matches_jax(fields, grids, field, case):
    """Every stat equal; rgb within 1e-5, uint8 within one level where
    the float lies on a rounding boundary (at most 1% of the values)."""
    (ref, ref_stats), (out, stats), budget = frames_both(
        fields, grids, field, case, pose_at())
    assert stats == ref_stats
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if out.dtype == np.uint8:
        diff = np.abs(out.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert stats["coarse_rays"] == budget["coarse_rays"]
    if case == "overflow":
        assert stats["coarse_overflow"] > 0 and stats["fine_overflow"] > 0
    if FRAMES[case][-1] is not None:
        assert 0 < stats["active_rays"] < FRAMES[case][0] ** 2


@pytest.mark.parametrize("case", ["full", "ert3_frac"])
def test_frame_at_full_capacity_is_the_dense_render(fields, case):
    """Every ray kept (ERT with every ray surviving too): the frame is the
    dense render of the same rays within 2e-6."""
    H, W, focal, rkw, _, _ = FRAMES[case]
    _, r = renderers(fields, "small", **BASE, **{**rkw, "ert_frac": (1.0,)})
    img = r.make_frame_renderer(H, W, focal, capacity=1.0)(pose_at())
    c2w = torch.from_numpy(pose_at())
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer

    rd = ngp_renderer.rotate_dirs(torch.from_numpy(
        ngp_renderer.pixel_dirs(H, W, focal)), c2w)
    dense = r.render_rays_batch(c2w[:3, 3].expand(rd.shape), rd)["rgb"]
    torch.testing.assert_close(img, dense, atol=2e-6, rtol=0)


def test_frame_budgets_and_refusals(fields):
    """The static budgets of the JAX record's 800x800 frames (bench_freq
    log: 280,000 coarse rays at capacity 0.35 / coarse 0.4, 240,000 after
    autocap), the fine segments' count, and a device mesh of a size that
    does not divide the ray chunk taken with the same budgets (the ranks
    take whole chunks; the JAX package, which splits a chunk by rows,
    raises, volume_renderer.py:641-645)."""
    _, r = renderers(fields, "sphere", **{**BASE, "ray_chunk": 40000,
                                          "N_samples": 64,
                                          "N_importance": 128})
    occ = (np.ones((4, 4, 4), np.uint8), (-1.5,) * 3 + (1.5,) * 3, 2)
    fn = r.make_frame_renderer(800, 800, 1111.0, capacity=0.35,
                               coarse_capacity=0.4, occupancy=occ)
    assert fn.budget == {"chunk": 40000, "coarse_rays": 280000,
                         "fine_rays": 240000, "fine_segments": 1}
    cap, ccap = raymarch_bench.freq_autocap(180000, 640000, 0.35, 0.4)
    assert (round(ccap, 2), round(cap, 2)) == (0.34, 0.33)
    r.settings = dataclasses.replace(r.settings, ert_segments=2)
    fn = r.make_frame_renderer(800, 800, 1111.0, capacity=cap,
                               coarse_capacity=ccap, occupancy=occ)
    assert fn.budget == {"chunk": 40000, "coarse_rays": 240000,
                         "fine_rays": 240000, "fine_segments": 2}
    assert tv.ert_capacity(40000, 0.5) == 20096
    mesh = Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    assert r.make_frame_renderer(8, 8, 8.0, mesh=mesh).budget == \
        r.make_frame_renderer(8, 8, 8.0).budget


# --- run_evaluate with task_arg.fast_sampling ----------------------------------

HARD = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
        "pretrain_path", "data/pretrain/hard", "device", "cpu",
        "save_result", "False", "task_arg.N_samples", "32",
        "task_arg.N_importance", "32"]


def test_run_evaluate_fast_sampling(monkeypatch):
    """run_evaluate with task_arg.fast_sampling renders each view through
    render_image_fast (the trained hard network, fused MLP's plain
    version, test views 0 and 4 at 16x16): the image is that function's,
    its PSNR the dense render's within 0.02 dB."""
    monkeypatch.chdir(ROOT)
    views = synthetic_scene.test_views("hard", 16, 16, [0, 4])
    cfg = make_cfg(parse_args(HARD + ["task_arg.fast_sampling", "True"]))
    res = run.run_evaluate(cfg, loader=views)
    renderer = run.build_renderer(cfg, run.load_model(cfg, "cpu"))
    for view, rgb in zip(views, res["rgb"]):
        fast = renderer.render_image_fast(view["rays_o"], view["rays_d"])
        np.testing.assert_array_equal(rgb, fast["rgb"].numpy())
    dense = run.run_evaluate(make_cfg(parse_args(HARD)), loader=views)
    assert abs(res["psnr"] - dense["psnr"]) < 0.02


# --- the frame bench's freq family -------------------------------------------

def bench_py_freq_autocap(active_rays, n_pix, capacity, coarse_capacity):
    """bench.py:868-880, as written there."""
    active_frac = active_rays / n_pix
    new_ccap = min(1.0, active_frac * 1.15 + 0.02)
    new_cap = min(new_ccap, active_frac * 1.10 + 0.02)
    if abs(new_ccap - coarse_capacity) > 0.03 or \
            abs(new_cap - capacity) > 0.03:
        return new_cap, new_ccap
    return None


@pytest.mark.parametrize("active", [180000, 0, 640000, 250000, 263000])
@pytest.mark.parametrize("caps", [(0.35, 0.4), (0.33, 0.34), (1.0, 1.0)])
def test_freq_autocap_matches_bench_py(active, caps):
    assert raymarch_bench.freq_autocap(active, 640000, *caps) == \
        bench_py_freq_autocap(active, 640000, *caps)


def test_freq_bench_end_to_end(monkeypatch, capsys):
    """``raymarch_bench --model freq`` on the CPU at 16x16: the grid, the
    first frame, autocap, the ERT gate and a window of 2 frames; bench.py's
    JSON with the gate and the GT-drop reading; the adopted frame of the
    first orbit pose, made again from the JSON's budgets, is the JAX
    package's compacted frame (the same grid and budgets, its XLA MLP;
    bf16 rounding points differ from the fused MLP's, ~1e-2 at most) within
    3 levels of 255 on fewer than 5% of the values, every stat equal."""
    monkeypatch.chdir(ROOT)
    built = []

    def build_grids(*args):
        built.append(run.build_grids(*args))
        return built[-1]

    monkeypatch.setattr(raymarch_bench, "build_grids", build_grids)
    out = raymarch_bench.main(["--model", "freq", "--size", "16",
                               "--frames", "2", "device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    gate = out["gate"]
    assert out["metric"] == "render_fps_16x16" and out["value"] > 0
    assert gate["kind"] in ("freq-ert", "freq-dense")
    assert (gate["kind"] == "freq-ert") == (gate["q_vs_dense_db"] >= 45.0)
    assert gate["stats"]["coarse_overflow"] == gate["stats"][
        "fine_overflow"] == 0
    assert 0 < gate["stats"]["active_rays"] < 256
    drop = gate["gt_drop"]
    assert drop["passed"] == (drop["drop"] <= raymarch_bench.GATE_DROP_DB)
    assert set(drop) == {"passed", "psnr", "drop", "q_vs_dense_db"}

    cfg = make_cfg(parse_args(["--type", "evaluate",
                               *raymarch_bench.MODELS["freq"], "device",
                               "cpu"]))
    renderer = run.build_renderer(cfg, run.load_model(cfg, "cpu"))
    (occupancy, select), = built
    assert occupancy[0].shape == (64,) * 3 and select is None
    segments = 2 if gate["kind"] == "freq-ert" else 1
    renderer.settings = dataclasses.replace(renderer.settings,
                                            ert_segments=segments)
    cap, ccap = gate["caps"]
    focal = 16 / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    pose = raymarch_bench.orbit_poses(2)[0].astype(np.float32)
    img, stats = renderer.make_frame_renderer(
        16, 16, focal, capacity=cap, coarse_capacity=ccap,
        out_dtype=torch.uint8, occupancy=occupancy, return_stats=True)(pose)
    assert raymarch_bench.host_stats(stats) == gate["stats"] or segments == 2

    jcfg = jax_config.make_cfg(jax_config.parse_args(
        raymarch_bench.MODELS["freq"]))
    jr = JaxRenderer(jax_make_network(jcfg), settings=dataclasses.replace(
        JaxSettings.from_cfg(jcfg), ert_segments=segments), mesh=None)
    jfn = jr.make_frame_renderer(
        16, 16, focal, capacity=cap, coarse_capacity=ccap,
        out_dtype=jnp.uint8, occupancy=(np.asarray(occupancy[0]),
                                        *occupancy[1:]), return_stats=True)
    ref, ref_stats = jfn(jax.tree.map(jnp.asarray,
                                      jax_load("data/pretrain/hard")),
                         jnp.asarray(pose))
    assert {k: int(v) for k, v in ref_stats.items()} == {
        k: int(v) for k, v in stats.items()}
    diff = np.abs(img.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 3 and (diff > 0).mean() < 0.05


def test_active_rays_of_the_jax_record():
    """The JAX record's 180,000 active rays of orbit pose 0 at 800x800
    (result/bench_freq_r5.log) against the port's 179,584 on the card:
    on the CPU the JAX package's probe of the same grid (64^3, threshold
    0.05, dilated 2, from the JAX network) counts 179,584 too, as does the
    port's; with the ray rotation's matmul in one bf16 pass, the TPU's
    default matmul precision, it counts the record's 180,000."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jcfg = jax_config.make_cfg(jax_config.parse_args(
            raymarch_bench.MODELS["freq"]))
        params = jax.tree.map(jnp.asarray, jax_load("data/pretrain/hard"))
    finally:
        os.chdir(cwd)
    jnet = jax_make_network(jcfg)

    def density(p, pts):
        return jax.nn.softplus(jnet.apply(p, pts[:, None, :],
                                          jnp.zeros((1, 1, 3)),
                                          model="fine")[:, 0, 3])

    grid, bbox = jocc.build_occupancy_grid(jax.jit(density), params,
                                           resolution=64, threshold=0.05,
                                           dilate=2)
    H = W = 800
    q = 4
    focal = W / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    n_probe = int(np.ceil(4.0 / (3.0 / 64))) + 1
    pose = raymarch_bench.orbit_poses(1)[0].astype(np.float32)

    def jax_count(c2w, dtype):
        # the compacted frame's rays and probe (volume_renderer.py:701-748)
        us, vs = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                              jnp.arange(H, dtype=jnp.float32))
        u, v = us.ravel(), vs.ravel()
        dirs = jnp.stack([(u - W / 2.0) / focal, -(v - H / 2.0) / focal,
                          -jnp.ones_like(u)], -1)
        rays_d = (dirs.astype(dtype) @ c2w[:3, :3].T.astype(dtype)).astype(
            jnp.float32)
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        sub = rays_d.reshape(H, W, 3)[q // 2::q, q // 2::q].reshape(-1, 3)
        act = jocc.rays_active(jnp.broadcast_to(c2w[:3, 3], sub.shape), sub,
                               jnp.linspace(2.0, 6.0, n_probe), grid, bbox)
        return act.sum() * q * q

    c2w = jnp.asarray(pose)
    count = jax.jit(jax_count, static_argnums=1)
    assert int(count(c2w, jnp.float32)) == 179584
    assert int(count(c2w, jnp.bfloat16)) == 180000

    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
    from nerf_replication_tpu_torch.ops.occupancy import rays_active

    rd = ngp_renderer.rotate_dirs(torch.from_numpy(
        ngp_renderer.pixel_dirs(H, W, focal)), torch.from_numpy(pose))
    sub = rd.reshape(H, W, 3)[q // 2::q, q // 2::q].reshape(-1, 3)
    act = rays_active(torch.from_numpy(pose[:3, 3]).expand(sub.shape), sub,
                      torch.from_numpy(ngp_renderer.probe_depths(
                          2.0, 6.0, n_probe)),
                      torch.from_numpy(np.asarray(grid)), bbox)
    assert int(act.sum()) * q * q == 179584
