"""Port parity for the occupancy-raymarch frame path:
``ngp_renderer.make_ngp_frame_renderer`` against the JAX package's, on an
analytic field written in both frameworks and on the trained brick-NGP and
frequency networks, with the JAX package's weights; the frame's ray
geometry bit for bit; ``run_evaluate`` with ``task_arg.fast_render``; the
frame bench's ladder and autocap against bench.py's formulas."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import default_cfg as jax_default_cfg
from nerf_replication_tpu.config import load_cfg_tree as jax_load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.renderer import ngp_renderer as jr
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    RenderSettings as JaxSettings,
)
from nerf_replication_tpu.ops import occupancy as jocc
from nerf_replication_tpu.ops.pallas import mlp_kernel as jax_mlp
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch import raymarch_bench, run
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import RenderSettings
from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer as tr
from nerf_replication_tpu_torch.ops import fused_ngp, mlp_kernel
from nerf_replication_tpu_torch.parallel.mesh import Mesh
from nerf_replication_tpu_torch.utils import synthetic_scene
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 24
FOCAL = 0.5 * W / np.tan(0.5 * synthetic_scene.CAMERA_ANGLE_X)
POSE = synthetic_scene.look_at_pose(
    np.array([0.5, -3.8, 1.0], np.float32)).astype(np.float32)


# --- an analytic field in both frameworks ---------------------------------

def jax_field(params, pts, viewdirs, model=""):
    sigma = 30.0 * (0.8 - jnp.linalg.norm(pts, axis=-1))
    return jnp.concatenate([pts * 2.0 + 0.1 * viewdirs, sigma[..., None]], -1)


def port_field(pts, viewdirs, model=""):
    sigma = 30.0 * (0.8 - torch.linalg.norm(pts, dim=-1))
    return torch.cat([pts * 2.0 + 0.1 * viewdirs, sigma[..., None]], -1)


@pytest.fixture(scope="module")
def field_grids():
    """The probe grid (16^3, dilated 2) and the selection grid (32^3,
    dilated 1) of the field's relu density, as the JAX package builds
    them; both frameworks get the same grids."""
    def density(p, x):
        return jnp.maximum(jax_field(p, x, jnp.zeros_like(x))[..., 3], 0.0)

    grid, bbox = jocc.build_occupancy_grid(density, None, resolution=16,
                                           threshold=0.5, dilate=2)
    sel = jocc.build_occupancy_grid(density, None, resolution=32,
                                    threshold=0.5, dilate=1)
    return (grid, bbox, 2), sel


def render_both(jax_apply, port_apply, occupancy, select, params=None,
                H=H, W=W, focal=FOCAL, pose=POSE, ray_chunk=64,
                activation="relu", uint8=False, **kw):
    """The same frame through both renderers: (jax outputs, port
    outputs), each (rgb[, depth], stats) as numpy, stats as floats."""
    full = kw.get("stage", "full") == "full"
    common = dict(return_stats=True, return_depth=full,
                  select_occupancy=select, **kw)
    js = JaxSettings(ray_chunk=ray_chunk, density_activation=activation)
    ts = RenderSettings(ray_chunk=ray_chunk, density_activation=activation)
    jfn = jr.make_ngp_frame_renderer(
        jax_apply, H, W, focal, occupancy, js,
        out_dtype=jnp.uint8 if uint8 else jnp.float32, **common)
    tfn = tr.make_ngp_frame_renderer(
        port_apply, H, W, focal, occupancy, ts,
        out_dtype=torch.uint8 if uint8 else torch.float32, **common)
    ref = jfn(params, jnp.asarray(pose))
    out = tfn(pose)

    def host(res):
        return ([np.asarray(x) for x in res[:-1]],
                {k: float(v) for k, v in res[-1].items()})

    return host(ref), host(out)


CASES = {
    "probe": dict(stage="probe"),
    "coarse_occ_capacity": dict(stage="coarse", occ_capacity=0.8,
                                select=True),
    "full_sub1": dict(),
    "full_auto_stride2_fine2": dict(probe_sub="auto", probe_stride=2,
                                    n_fine2=2, occ_capacity=0.9, select=True,
                                    focal=90.0),
    "overflow": dict(capacity=0.2, fine_capacity=0.1),
    "uint8": dict(uint8=True, occ_capacity=0.9, select=True),
    # with softplus every ray has some opacity, and two rays whose coarse
    # opacities lie one ulp apart (0.99999386 / 0.9999939) swap places
    # across the top-k cut between the frameworks; every ray takes the
    # fine pass here, and "overflow" holds the cut (relu)
    "softplus": dict(activation="softplus", probe_sub=4, focal=150.0,
                     fine_capacity=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_matches_jax_on_a_field(field_grids, case):
    """Every stat equal, rgb and depth within 1e-5 (uint8 within one
    level at a rounding boundary)."""
    occupancy, sel = field_grids
    kw = dict(n_candidates=16, n_coarse=8, n_fine=8, capacity=1.0,
              probe_sub=1)
    kw.update(CASES[case])
    select = sel if kw.pop("select", False) else None
    (ref, ref_stats), (out, stats) = render_both(
        jax_field, port_field, occupancy, select, **kw)
    assert stats == ref_stats
    assert stats["active_rays"] > 0
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.uint8:
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    if case == "overflow":
        assert stats["coarse_overflow"] > 0
    if case == "full_auto_stride2_fine2":
        assert stats["occ_rays"] > 0 and stats["fine_overflow"] > 0


@pytest.mark.parametrize("value", [0, 1])
def test_empty_and_full_grids(value):
    """An empty grid renders pure background with no ray active; a full
    one makes every ray active."""
    occupancy = (np.full((8, 8, 8), value, np.uint8), (-1.5,) * 3 + (1.5,) * 3)
    (ref, ref_stats), (out, stats) = render_both(
        jax_field, port_field, occupancy, None, n_candidates=8, n_coarse=4,
        n_fine=4, capacity=0.5, probe_sub=1)
    assert stats == ref_stats
    assert stats["active_rays"] == value * H * W
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    if value == 0:
        np.testing.assert_array_equal(out[0], 1.0)


def test_chunk_invariance(field_grids):
    """At full capacities the image does not depend on the ray chunk."""
    occupancy, sel = field_grids
    imgs = []
    for chunk in (32, 64, 576):
        fn = tr.make_ngp_frame_renderer(
            port_field, H, W, FOCAL, occupancy, RenderSettings(
                ray_chunk=chunk, density_activation="relu"),
            n_candidates=16, n_coarse=8, n_fine=8, capacity=1.0,
            fine_capacity=1.0, occ_capacity=1.0, select_occupancy=sel,
            probe_sub=1, out_dtype=torch.float32, return_depth=True)
        imgs.append(fn(POSE))
    for rgb, depth in imgs[1:]:
        np.testing.assert_array_equal(rgb.numpy(), imgs[0][0].numpy())
        np.testing.assert_array_equal(depth.numpy(), imgs[0][1].numpy())


def test_refusals(field_grids):
    """The reference's ValueErrors, an unknown stage, and a device mesh of
    a size that does not divide the ray chunk taken with the same budgets
    (the ranks take whole chunks; the JAX package raises, :294-302)."""
    occupancy, _ = field_grids
    s = RenderSettings()

    def make(occ=occupancy, **kw):
        return tr.make_ngp_frame_renderer(port_field, 8, 8, 10.0, occ, s,
                                          **kw)

    with pytest.raises(ValueError, match="n_coarse"):
        make(n_candidates=8, n_coarse=9)
    with pytest.raises(ValueError, match="dilated"):
        make(occ=occupancy[:2] + (1,), probe_sub=4)
    with pytest.raises(ValueError, match="stride"):
        make(probe_stride=4)
    with pytest.raises(ValueError, match="stage"):
        make(stage="fine")
    mesh = Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    assert make(mesh=mesh).budget == make().budget
    make(occ=occupancy[:2] + (1,), probe_sub="auto")   # auto degrades to 1


# --- the frame's geometry, bit for bit ------------------------------------

@pytest.mark.parametrize("n", [22, 44, 65, 86, 300])
def test_probe_depths_bit_equal(n):
    """``jnp.linspace`` with constant ends as the JAX frame compiles it."""
    ref = jax.jit(lambda: jnp.linspace(2.0, 6.0, n))()
    np.testing.assert_array_equal(tr.probe_depths(2.0, 6.0, n),
                                  np.asarray(ref))


@pytest.mark.parametrize("c", [10, 16, 24, 32, 40, 48])
def test_candidate_fractions_bit_equal(c):
    ref = jax.jit(lambda: (jnp.arange(c, dtype=jnp.float32) + 0.5) / c)()
    np.testing.assert_array_equal(tr.candidate_fractions(c), np.asarray(ref))


def test_ray_directions_in_plain_float32():
    """The pixel directions equal the JAX frame's (ngp_renderer.py:311-316,
    compiled); the world directions equal a numpy float32 elementwise
    computation bit for bit, also with float32 matmuls allowed to run in
    reduced precision, since they use no matmul."""
    h, w, focal = 40, 56, 61.7

    def jax_dirs():
        us, vs = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32),
                              jnp.arange(h, dtype=jnp.float32))
        u, v = us.ravel(), vs.ravel()
        return jnp.stack([(u - w / 2.0) / focal, -(v - h / 2.0) / focal,
                          -jnp.ones_like(u)], -1)

    dirs = tr.pixel_dirs(h, w, focal)
    np.testing.assert_array_equal(dirs, np.asarray(jax.jit(jax_dirs)()))
    c2w = synthetic_scene.test_poses()[3].astype(np.float32)
    r = c2w[:3, :3]
    d = [dirs[:, 0] * r[i, 0] + dirs[:, 1] * r[i, 1] + dirs[:, 2] * r[i, 2]
         for i in range(3)]
    norm = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    ref = np.stack([c / norm for c in d], -1)
    before = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "medium"):
            torch.set_float32_matmul_precision(precision)
            out = tr.rotate_dirs(torch.from_numpy(dirs),
                                 torch.from_numpy(c2w))
            np.testing.assert_array_equal(out.numpy(), ref)
    finally:
        torch.set_float32_matmul_precision(before)


# --- the trained networks, the JAX package's weights ---------------------

NETS = {
    # data/pretrain/hard_ngp_b9 through the fused NGP kernel (#10): Pallas
    # in interpret mode against its plain version
    "ngp": ("configs/nerf/hard_ngp.yaml", "data/pretrain/hard_ngp_b9",
            {"xyz_encoder.log2_bricks": 9}),
    # data/pretrain/hard through the fused encode+MLP kernel (#1): Pallas
    # in interpret mode against its plain version
    "freq": ("configs/nerf/hard.yaml", "data/pretrain/hard", {}),
}
# rgb bounds of the frames, from the CPU readings (max |rgb diff| 1.1e-5 /
# 2.4e-5 for NGP at fine_capacity 1 / 0.125; 2.5e-3 for the frequency
# network, whose bf16 MLP and its kernel's plain version differ where f32
# summation order flips a bf16 rounding)
NET_RGB_ATOL = {"ngp": 1e-4, "freq": 1e-2}


def set_network(cfg, network: dict):
    for key, value in network.items():
        node = cfg.network
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        node[last] = value
    return cfg


@pytest.fixture(scope="module", params=sorted(NETS))
def trained_net(request):
    """(name, JAX apply, port apply, grids): the checkpoint's weights as
    the JAX package loads them, carried to the port by params_from_jax;
    the grids (16^3 and 24^3) from the port's apply, given to both."""
    name = request.param
    cfg_file, ckpt, network = NETS[name]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jcfg = set_network(jax_load_cfg_tree(cfg_file, jax_default_cfg()),
                           network)
        cfg = set_network(make_cfg(parse_args(["--cfg_file", cfg_file])),
                          network)
        tree = jax_load(ckpt)
    finally:
        os.chdir(cwd)
    jnet = jax_make_network(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(tree))
    net.eval()
    if name == "ngp":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NGP_FUSED", "1")
            jax_apply = jr.make_ngp_eval_apply(jnet, params)
        port_apply = tr.make_ngp_eval_apply(net)
    else:
        jax_apply = jax_mlp.make_fused_apply(jnet, params)
        port_apply = mlp_kernel.make_fused_apply(net)
    occupancy, select = run.build_grids(
        port_apply, RenderSettings(density_activation="softplus"), "cpu",
        resolution=16, sel_resolution=24, threshold=0.02)
    return name, jax_apply, port_apply, occupancy, select


@pytest.mark.parametrize("fine_capacity", [1.0, 0.125])
def test_trained_network_frames_match_jax(trained_net, fine_capacity,
                                          monkeypatch):
    """A 16x16 frame of hard test view 0: every stat equal, rgb within
    NET_RGB_ATOL; the port's apply runs the kernel's plain version."""
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    name, jax_apply, port_apply, occupancy, select = trained_net
    h = w = 16
    focal = w / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    plain = (fused_ngp.fused_ngp_eval_reference if name == "ngp"
             else mlp_kernel.fused_nerf_mlp_enc_reference)
    calls = plain.calls
    (ref, ref_stats), (out, stats) = render_both(
        jax_apply, port_apply, (occupancy[0].numpy(),) + occupancy[1:],
        (select[0].numpy(), select[1]), H=h, W=w, focal=focal,
        pose=synthetic_scene.test_poses()[0].astype(np.float32),
        ray_chunk=32, activation="softplus", n_candidates=16, n_coarse=6,
        n_fine=6, capacity=1.0, occ_capacity=1.0,
        fine_capacity=fine_capacity, probe_sub=1)
    assert stats == ref_stats
    assert 0 < stats["nontrivial_rays"] < stats["active_rays"] < h * w
    assert plain.calls > calls
    if fine_capacity < 1.0:
        assert stats["fine_overflow"] > 0
    np.testing.assert_allclose(out[0], ref[0], atol=NET_RGB_ATOL[name],
                               rtol=0)


# --- run_evaluate with task_arg.fast_render -------------------------------

FAST = ["task_arg.fast_render", "True", "task_arg.occ_resolution", "16",
        "task_arg.occ_sel_resolution", "24", "task_arg.fast_candidates",
        "16", "task_arg.fast_coarse", "6", "task_arg.fast_fine", "6",
        "task_arg.fast_capacity", "0.6", "task_arg.fast_occ_capacity",
        "0.5", "task_arg.fast_probe_sub", "auto",
        "task_arg.fast_probe_stride", "2"]
B9 = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard_ngp.yaml",
      "pretrain_path", "data/pretrain/hard_ngp_b9",
      "network.xyz_encoder.log2_bricks", "9", "device", "cpu",
      "save_result", "False"]


def test_run_evaluate_fast_render(monkeypatch):
    """The trained b9 network, hard test view 0 at 16x16: run_evaluate's
    image is the frame renderer's, made with the config's keys, and a
    flag that is not a boolean is refused."""
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args(B9 + FAST))
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    res = run.run_evaluate(cfg, loader=views)

    renderer = run.build_renderer(cfg, run.load_model(cfg, "cpu"))
    occupancy, select = run.build_grids(
        renderer.apply_fn, renderer.settings, "cpu", 16, 24, 0.02)
    fn = tr.make_ngp_frame_renderer(
        renderer.apply_fn, 16, 16, float(views[0]["focal"]), occupancy,
        renderer.settings, n_candidates=16, n_coarse=6, n_fine=6,
        capacity=0.6, occ_capacity=0.5, probe_sub="auto", probe_stride=2,
        select_occupancy=select, out_dtype=torch.float32, return_depth=True)
    rgb, _ = fn(views[0]["pose"])
    np.testing.assert_array_equal(res["rgb"][0], rgb.numpy())
    dense = run.run_evaluate(make_cfg(parse_args(B9)), loader=views)
    assert abs(res["psnr"] - dense["psnr"]) < 3.0

    cfg.task_arg.fast_render = "false"
    with pytest.raises(TypeError, match="fast_render"):
        run.make_frame_fn(cfg, renderer)


# --- the bench's ladder and autocap ---------------------------------------

def bench_py_autocap(stats, n_pix, capacity, occ_cap, fine_cap):
    """bench.py:684-705, as written there."""
    active_frac = stats["active_rays"] / n_pix
    new_cap = min(1.0, active_frac * 1.1 + 0.02)
    new_occ = min(new_cap, stats["occ_rays"] / n_pix * 1.15 + 0.01)
    new_fine = min(new_occ, stats["nontrivial_rays"] / n_pix * 1.15 + 0.01)
    if (abs(new_cap - capacity) > 0.015 or fine_cap is None
            or abs(new_occ - occ_cap) > 0.015
            or abs(new_fine - fine_cap) > 0.015):
        return new_cap, new_occ, new_fine
    return None


# the freq_rm record's stats (BENCH_r05.json) and the NGP frame bench's
# on the CPU at 32x32 (one frame's counts, scaled to 800x800)
RECORDED = [
    {"active_rays": 202432, "occ_rays": 147481, "nontrivial_rays": 125294},
    {"active_rays": 202500, "occ_rays": 146250, "nontrivial_rays": 126875},
    {"active_rays": 640000, "occ_rays": 640000, "nontrivial_rays": 0},
]


@pytest.mark.parametrize("stats", RECORDED)
@pytest.mark.parametrize("caps", [(0.35, 0.35, None), (0.37, 0.27, 0.23),
                                  (0.3364, 0.2751, 0.2351)])
def test_autocap_matches_bench_py(stats, caps):
    ref = bench_py_autocap(stats, 640000, *caps)
    out = raymarch_bench.autocap(stats, 640000, raymarch_bench.Caps(*caps))
    assert (out is None) == (ref is None)
    if out is not None:
        assert (out.capacity, out.occ, out.fine) == ref


def test_default_ladder_is_bench_py_s():
    src = open(os.path.join(ROOT, "bench.py")).read()
    default = re.search(r'"BENCH_NGP_LADDER",\s*("[^)]*")\)', src).group(1)
    text = "".join(re.findall(r'"([^"]*)"', default))
    assert raymarch_bench.DEFAULT_LADDER == text
    assert raymarch_bench.parse_ladder(text)[3] == (32, 12, 10)


@pytest.mark.parametrize("passes_at,accelerated", [
    (2, True), (None, True), (1, False), (None, False)])
def test_walk_ladder(passes_at, accelerated):
    """The walk on recorded stats, no render: autocap on the first step,
    the first passing step taken; with no pass under the accelerated
    probe, the ladder again with (4, 1); None when nothing passes."""
    built = []

    def build(C, M, F, caps, sub, stride):
        built.append((C, sub, stride, caps.capacity))

        def fn(pose):
            return "img", {k: torch.tensor(v) for k, v in RECORDED[0].items()}
        fn.step = (C, M, F, sub, stride)
        return fn

    def gate(fn, label, first_img):
        C, _, _, sub, stride = fn.step
        ok = passes_at is not None and C == passes_at and (
            (sub, stride) == (4, 1)) != accelerated
        return ok, {"label": label}

    ladder = [(1, 1, 1), (2, 1, 1), (3, 1, 1)]
    out = raymarch_bench.walk_ladder(
        build, gate, ladder, raymarch_bench.Caps(), ("auto", 2), 640000,
        None, log=lambda msg: None)
    if passes_at is None:
        assert out is None
        assert [b[1:3] for b in built][-3:] == [(4, 1)] * 3
        return
    assert out["step"] == (passes_at, 1, 1)
    assert out["probe"] == (("auto", 2) if accelerated else (4, 1))
    assert built[0][3] == 0.35 and built[1][3] != 0.35   # refitted once
    assert out["caps"].fine is not None


@pytest.mark.parametrize("brick,f32_passes,bf16_passes", [
    (True, True, True), (True, True, False), (True, False, True),
    (False, True, None)])
def test_gated_frame_adopts_the_bf16_arm_only_if_it_passes(
        monkeypatch, brick, f32_passes, bf16_passes):
    """raymarch_bench.gated_frame, the one policy of the bench and the
    chip smoke: the ladder on the f32 apply; for a brick-NGP network the
    bf16 arm at the passing step, gated and reported with its verdict; no
    bf16 arm for a frequency network or when no step passes."""
    frame_args = (4, 4, "focal", "occupancy", "select", "settings")

    def factory(apply_fn, *args):
        assert args == frame_args

        def build(C, M, F, caps, sub, stride):
            def fn(pose):
                return "img", {k: torch.tensor(v)
                               for k, v in RECORDED[0].items()}
            fn.arm, fn.step = apply_fn, (C, M, F, caps, sub, stride)
            return fn
        return build

    monkeypatch.setattr(raymarch_bench, "frame_factory", factory)
    monkeypatch.setattr(raymarch_bench.ngp_renderer, "is_brick_ngp",
                        lambda net: brick)
    monkeypatch.setattr(raymarch_bench.ngp_renderer, "make_ngp_eval_apply",
                        lambda net, mlp_bf16=False: ("bf16", net))

    def gate(fn, label, first_img=None):
        return (f32_passes if fn.arm == "f32" else bf16_passes), \
            {"label": label}

    chosen, bf16 = raymarch_bench.gated_frame(
        "net", "f32", frame_args, gate, [(1, 1, 1)], None,
        log=lambda msg: None)
    if not f32_passes:
        assert chosen is None and bf16 is None
        return
    assert chosen["step"] == (1, 1, 1) and chosen["fn"].arm == "f32"
    if not brick:
        assert bf16 is None
        return
    assert bf16["apply"] == ("bf16", "net") and bf16["fn"].arm == bf16["apply"]
    assert bf16["fn"].step == (*chosen["step"], chosen["caps"],
                               *chosen["probe"])
    assert bf16["passed"] is bf16_passes
    assert bf16["label"] == "bf16-MLP refinement"
