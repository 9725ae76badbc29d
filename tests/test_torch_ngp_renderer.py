"""Port parity for the NGP eval slice: a small brick-NGP network renders
the same rays through JAX's ``Renderer.use_apply(make_ngp_eval_apply(...))``
(the fused Pallas kernel in interpret mode) and the port's
``build_renderer`` (the fused kernel's plain version on the CPU); the
port's three routes agree; the hard_ngp_b9 checkpoint loads strictly and
round-trips; the CLI evaluates it on the CPU."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import default_cfg as jax_default_cfg
from nerf_replication_tpu.config import load_cfg_tree as jax_load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
    make_ngp_eval_apply as jax_make_ngp_eval_apply,
)
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    Renderer as JaxRenderer,
)
import chip_smoke
from nerf_replication_tpu_torch import run
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import (
    make_renderer,
    ngp_renderer,
)
from nerf_replication_tpu_torch.ops import eval_encode, fused_ngp
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import (
    load_pretrain,
    params_from_jax,
    params_to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B9 = ["pretrain_path", "data/pretrain/hard_ngp_b9",
      "network.xyz_encoder.log2_bricks", "9"]
# hard_ngp cut to a small grid and few samples: 4 levels, 5-bit bricks
SMALL = ["network.xyz_encoder.num_levels", "4",
         "network.xyz_encoder.base_resolution", "4",
         "network.xyz_encoder.desired_resolution", "32",
         "network.xyz_encoder.log2_bricks", "5",
         "task_arg.N_samples", "8", "task_arg.N_importance", "8"]


def port_cfg(monkeypatch, *opts):
    monkeypatch.chdir(ROOT)
    return make_cfg(parse_args(["--type", "evaluate", "--cfg_file",
                                "configs/nerf/hard_ngp.yaml", "device", "cpu",
                                "save_result", "False", *opts]))


def object_rays(n_side=4):
    """n_side^2 rays of hard test view 0 over the object."""
    pose = synthetic_scene.test_poses()[0]
    focal = 800 / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    ro, rd = synthetic_scene.camera_rays(pose, 800, 800, focal)
    idx = np.ix_(np.linspace(300, 500, n_side).astype(int),
                 np.linspace(300, 500, n_side).astype(int))
    return (np.ascontiguousarray(ro[idx].reshape(-1, 3)),
            np.ascontiguousarray(rd[idx].reshape(-1, 3)))


def test_small_ngp_render_matches_jax(monkeypatch):
    """16 rays, 8 + 8 samples, a fresh seed-0 JAX init loaded into the
    port. The MLPs sum in other orders (f32 both), and the fine samples
    follow the coarse weights: rgb and acc within 1e-4, depth within 1e-3
    of its [2, 6] range."""
    monkeypatch.setenv("NGP_FUSED", "1")
    cfg = port_cfg(monkeypatch, *SMALL)
    jcfg = jax_load_cfg_tree("configs/nerf/hard_ngp.yaml", jax_default_cfg())
    jcfg.network.xyz_encoder.update(num_levels=4, base_resolution=4,
                                    desired_resolution=32, log2_bricks=5)
    jcfg.task_arg.update(N_samples=8, N_importance=8)
    jnet = jax_make_network(jcfg)
    params = init_params(jnet, jax.random.key(0))
    jax_renderer = JaxRenderer(jnet, cfg=jcfg, mesh=None).use_apply(
        jax_make_ngp_eval_apply(jnet, params))
    ro, rd = object_rays()
    ref = jax_renderer.render_rays_batch(params, ro, rd)

    net = make_network(cfg)
    net.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(params))))
    calls = tracing.counts["fused_ngp_eval_reference.calls"]
    launches = tracing.counts["fused_ngp_eval.launches"]
    out = run.build_renderer(cfg, net.eval()).render_rays_batch(ro, rd)
    assert tracing.counts["fused_ngp_eval_reference.calls"] == calls + 2
    assert tracing.counts["fused_ngp_eval.launches"] == launches
    for key, atol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3),
                      ("rgb_coarse", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=0)


@pytest.fixture(scope="module")
def b9_net():
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = make_cfg(parse_args(["--type", "evaluate", "--cfg_file",
                                   "configs/nerf/hard_ngp.yaml", "device",
                                   "cpu", "save_result", "False", *B9]))
        return cfg, run.load_model(cfg, torch.device("cpu"))
    finally:
        os.chdir(cwd)


# the fused kernel's plain version, the eval encode's, the MLP's, the
# network's
ROUTE_COUNTS = ("fused_ngp_eval_reference.calls",
                "brick_encode_cells_reference.calls", "NeRFMLP.calls",
                "Network.calls")


def test_three_routes_agree_on_b9(b9_net):
    """The trained b9 network, 16 rays of hard view 0: the fused route,
    the unfused route (eval encode + nn.Module MLP) and the plain
    nn.Module network. The encodes agree bit for bit (the same bf16
    values summed in the same order) and the MLPs differ only in their f32
    summation order: rgb within 1e-5, depth within 1e-4. Each route runs
    through its own path, counted."""
    cfg, net = b9_net
    ro, rd = object_rays()
    renderer = make_renderer(cfg, net)
    out = {}
    counts = {}
    for route in ("fused", "unfused", "plain"):
        before = tuple(tracing.counts[k] for k in ROUTE_COUNTS)
        if route == "plain":
            renderer.use_apply(net)
        else:
            renderer.use_apply(ngp_renderer.make_ngp_eval_apply(
                net, fused=route == "fused"))
        out[route] = renderer.render_rays_batch(ro, rd)
        counts[route] = tuple(tracing.counts[k] - b
                              for k, b in zip(ROUTE_COUNTS, before))
    assert counts == {"fused": (2, 0, 0, 0), "unfused": (0, 2, 2, 0),
                      "plain": (0, 0, 2, 2)}
    assert float(out["fused"]["acc"].min()) > 0.5   # the rays hit
    for route in ("unfused", "plain"):
        torch.testing.assert_close(out[route]["rgb"], out["fused"]["rgb"],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(out[route]["depth"], out["fused"]["depth"],
                                   atol=1e-4, rtol=0)


def test_b9_checkpoint_loads_strictly_and_round_trips(b9_net, monkeypatch):
    """Every leaf of hard_ngp_b9 (the 5504-row table untransposed) lands in
    the port's Network and comes back bit for bit; the yaml's b12 layout on
    that checkpoint raises instead of reinterpreting the rows."""
    _, net = b9_net
    tree = load_pretrain(os.path.join(ROOT, "data", "pretrain",
                                      "hard_ngp_b9"))
    state = net.state_dict()
    assert set(state) == set(params_from_jax(tree))
    assert tuple(state["xyz_encoder.table"].shape) == (5504, 256)
    back = params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    cfg12 = port_cfg(monkeypatch, "pretrain_path", "data/pretrain/hard_ngp_b9")
    with pytest.raises(ValueError, match="log2_bricks"):
        run.load_model(cfg12, torch.device("cpu"))


def test_b9_network_matches_flax(b9_net):
    """The port's nn.Module network (plain training-forward encode, f32
    MLP) against the Flax network on the same checkpoint, world points
    and directions: atol 1e-4 + rtol 1e-5 (f32 summation order; sigma
    reaches ~600)."""
    _, net = b9_net
    tree = load_pretrain(os.path.join(ROOT, "data", "pretrain",
                                      "hard_ngp_b9"))
    cwd = os.getcwd()
    os.chdir(ROOT)   # parent_cfg paths are relative to the repo root
    try:
        jcfg = jax_load_cfg_tree("configs/nerf/hard_ngp.yaml",
                                 jax_default_cfg())
    finally:
        os.chdir(cwd)
    jcfg.network.xyz_encoder.log2_bricks = 9
    jnet = jax_make_network(jcfg)
    g = np.random.default_rng(3)
    pts = g.uniform(-1.3, 1.3, (64, 6, 3)).astype(np.float32)
    dirs = g.normal(size=(64, 1, 3)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    for model in ("", "fine"):
        expect = jnet.apply(params, jnp.asarray(pts), jnp.asarray(dirs),
                            model=model)
        with torch.no_grad():
            out = net(torch.from_numpy(pts), torch.from_numpy(dirs), model)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("variant", [
    "f64 MLP products",
    *(k for k in chip_smoke.NGP_CONTROLS if "TF32" not in k)])
def test_ngp_smoke_check_sees_precision_faults(b9_net, variant):
    """chip_smoke.py's phase-6 check on the CPU, b9 network, 4096 points of
    the unit cube and SH of random directions: it accepts the fused plain
    version with its MLP products in f64 (another rounding, as the
    kernel's 3xTF32 products are) and rejects the controls that read the
    table in f32 or multiply in bf16, and the f32 arm held to the bf16
    arm's check (the TF32 control needs a card)."""
    _, net = b9_net
    g = np.random.default_rng(11)
    x = torch.from_numpy(g.uniform(0, 1, (4096, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(4096, 3)).astype(np.float32))
    sh = net.dir_encoder(d)
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    cells = eval_encode.pack_cell_table(packed)
    ops, meta = fused_ngp.extract_mlp_weights(
        net.coarse.state_dict(), 24, 3, (1,), 1)
    plains = {
        "encode": lambda: eval_encode.brick_encode_eval(layout, cells, x),
        "fused": lambda: fused_ngp.fused_ngp_eval(layout, meta, packed, ops,
                                                  x, sh),
        "fused_bf16": lambda: fused_ngp.fused_ngp_eval(
            layout, meta, packed, ops, x, sh, mlp_bf16=True)}
    with torch.no_grad():
        if variant.startswith("f64"):
            f64 = lambda a, b: (a.double() @ b.double()).float()  # noqa: E731
            with mock.patch.object(fused_ngp, "_matmul", f64):
                out = plains["fused"]()
            a = chip_smoke.agreement(out, plains["fused"](),
                                     chip_smoke.NGP_BOUNDS)
            assert a["ok"] and a["max_abs_err"] > 0, a
        else:
            target, control = chip_smoke.NGP_CONTROLS[variant]
            out = control(net.xyz_encoder, x, plains[target])
            a = chip_smoke.agreement(out, plains[target](),
                                     chip_smoke.NGP_BF16_BOUNDS
                                     if target == "fused_bf16"
                                     else chip_smoke.NGP_BOUNDS)
            assert not a["ok"], a


def test_ngp_apply_is_none_for_other_networks(monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args(["--cfg_file", "configs/nerf/hard.yaml"]))
    assert ngp_renderer.make_ngp_eval_apply(make_network(cfg)) is None


def test_run_evaluate_ngp_on_cpu(monkeypatch):
    """The evaluate CLI's path on hard_ngp_b9 at 16x16 (hard test view 0):
    two fused plain calls, no launch, and an image that reads the scene
    (PSNR above 20 dB at this size)."""
    cfg = port_cfg(monkeypatch, *B9)
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    calls = tracing.counts["fused_ngp_eval_reference.calls"]
    res = run.run_evaluate(cfg, loader=views)
    assert tracing.counts["fused_ngp_eval_reference.calls"] == calls + 2
    assert res["rgb"][0].shape == (256, 3)
    assert np.isfinite(res["rgb"][0]).all()
    assert res["psnr"] > 20.0 and 0.5 < res["ssim"] <= 1.0
