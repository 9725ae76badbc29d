"""Port parity for the slice as a whole: configs/nerf/hard.yaml with the
trained data/pretrain/hard weights, 64 rays through the object from hard
test view 0, 64 + 128 samples. The JAX renderer runs the fused Pallas
MLP in interpret mode; the port runs its fused MLP's plain version (the
CPU path of the same wrapper that launches the CUDA kernel on a GPU)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import default_cfg as jax_default_cfg
from nerf_replication_tpu.config import load_cfg_tree as jax_load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    Renderer as JaxRenderer,
)
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch.config import CN, as_bool, make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import (
    RenderSettings,
    make_renderer,
)
from nerf_replication_tpu_torch.run import build_renderer, load_model
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
        "pretrain_path", "data/pretrain/hard", "device", "cpu",
        "save_result", "False"]


@pytest.fixture(scope="module")
def port_cfg():
    cwd = os.getcwd()
    os.chdir(ROOT)  # parent_cfg and pretrain_path are repo-relative
    try:
        yield make_cfg(parse_args(ARGV))
    finally:
        os.chdir(cwd)


def object_rays():
    """64 rays of hard test view 0 (800x800) on an 8x8 pixel lattice over
    the object."""
    pose = synthetic_scene.test_poses()[0]
    focal = 800 / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    ro, rd = synthetic_scene.camera_rays(pose, 800, 800, focal)
    idx = np.ix_(np.linspace(300, 500, 8).astype(int),
                 np.linspace(300, 500, 8).astype(int))
    return (np.ascontiguousarray(ro[idx].reshape(-1, 3)),
            np.ascontiguousarray(rd[idx].reshape(-1, 3)))


def test_slice_matches_jax_renderer(port_cfg, monkeypatch):
    """rgb/depth/acc of the hierarchical render. Both MLPs round at the
    same points, so they differ only where float32 summation order flips
    a bf16 rounding; the fine samples follow the coarse weights, so such
    a flip can move them a little: rgb within 2e-3, depth within 2e-3 of
    its [2, 6] range."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    cfg = jax_load_cfg_tree("configs/nerf/hard.yaml", jax_default_cfg())
    params = jax.tree.map(jnp.asarray, jax_load("data/pretrain/hard"))
    jax_renderer = JaxRenderer(jax_make_network(cfg), cfg=cfg, mesh=None)
    assert jax_renderer.enable_fused_mlp(params)
    ro, rd = object_rays()
    ref = jax_renderer.render_rays_batch(params, ro, rd)

    renderer = make_renderer(port_cfg, load_model(port_cfg, "cpu"))
    assert renderer.enable_fused_mlp()
    calls = tracing.counts["fused_nerf_mlp_enc_reference.calls"]
    out = renderer.render_rays_batch(ro, rd)
    assert tracing.counts["fused_nerf_mlp_enc_reference.calls"] == calls + 2
    assert np.asarray(ref["acc"]).min() > 0.5  # the rays hit the object
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(out["acc"].numpy(), ref["acc"], atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(out["depth"].numpy(), ref["depth"],
                               atol=8e-3, rtol=0)
    np.testing.assert_allclose(out["rgb_coarse"].numpy(), ref["rgb_coarse"],
                               atol=2e-3, rtol=0)


def test_render_settings_from_hard_cfg(port_cfg):
    s = RenderSettings.from_cfg(port_cfg)
    assert (s.N_samples, s.N_importance, s.ray_chunk) == (64, 128, 40000)
    assert s.white_bkgd and not s.lindisp and not s.finite_tail
    assert s.density_activation == "softplus"


def test_render_settings_parse_fast_sampling_and_ert(port_cfg):
    """The ESS/ERT keys as the JAX package reads them, ``ert_frac`` a YAML
    list made a tuple of floats; flags strict, a non-list ``ert_frac``
    refused."""
    cfg = port_cfg.clone()
    cfg.task_arg.update({"fast_sampling": True, "ess_verbose": 1,
                         "weights_threshold": 0.3, "ert_threshold": 0.5,
                         "ert_segments": 3, "ert_eps": 1e-3,
                         "ert_frac": [0.6, 1], "ert_split": 0.5})
    s = RenderSettings.from_cfg(cfg)
    assert (s.fast_sampling, s.ess_verbose, s.weights_threshold,
            s.ert_threshold, s.ert_segments, s.ert_eps, s.ert_frac,
            s.ert_split) == (True, True, 0.3, 0.5, 3, 1e-3, (0.6, 1.0), 0.5)
    cfg.task_arg.fast_sampling = "false"
    with pytest.raises(TypeError, match="fast_sampling"):
        RenderSettings.from_cfg(cfg)
    cfg.task_arg.fast_sampling = False
    cfg.task_arg.ert_frac = "0.5"
    with pytest.raises(TypeError, match="ert_frac"):
        RenderSettings.from_cfg(cfg)


@pytest.mark.parametrize("value,expected", [(True, True), (False, False),
                                            (1, True), (0, False)])
def test_as_bool_accepts_booleans(value, expected):
    assert as_bool(value, "k") is expected


@pytest.mark.parametrize("value", ["false", "True", 2, None])
def test_as_bool_refuses_the_rest(value):
    """bool('false') is True: a string must not switch a kernel on."""
    with pytest.raises(TypeError):
        as_bool(value, "network.use_pallas_mlp")


def test_enable_fused_mlp_false_for_other_architectures(port_cfg):
    cfg = port_cfg.clone()
    cfg.network.nerf = CN({"D": 4, "W": 128, "V_D": 1, "skips": [2]})
    assert make_renderer(cfg, make_network(cfg)).enable_fused_mlp() is False


@pytest.mark.parametrize("use_pallas_mlp", [True, False])
def test_build_renderer_runs_the_plain_mlp_only_when_asked(port_cfg,
                                                           use_pallas_mlp):
    """With network.use_pallas_mlp on, a network the kernel does not cover
    raises, naming what differs, rather than running the plain MLP. With
    it off the plain nn.Module MLP runs, and tracing.counts["Network.calls"]
    counts it."""
    cfg = port_cfg.clone()
    cfg.network.nerf.W = 128
    cfg.network.use_pallas_mlp = use_pallas_mlp
    cfg.task_arg.N_samples, cfg.task_arg.N_importance = 8, 8
    net = make_network(cfg).eval()
    if use_pallas_mlp:
        with pytest.raises(ValueError, match="width 128"):
            build_renderer(cfg, net)
        return
    calls = tracing.counts["Network.calls"]
    ref_calls = tracing.counts["fused_nerf_mlp_enc_reference.calls"]
    out = build_renderer(cfg, net).render_rays_batch(*object_rays())
    assert bool(torch.isfinite(out["rgb"]).all())
    assert tracing.counts["Network.calls"] == calls + 2
    assert tracing.counts["fused_nerf_mlp_enc_reference.calls"] == ref_calls


def test_padded_last_chunk_matches_one_chunk(port_cfg):
    """64 rays in chunks of 48 (the last one padded) render as in one
    chunk of 64, and every output is finite."""
    cfg = port_cfg.clone()
    cfg.task_arg.N_samples, cfg.task_arg.N_importance = 8, 8
    renderer = make_renderer(cfg, load_model(cfg, "cpu"))
    renderer.enable_fused_mlp()
    ro, rd = object_rays()
    whole = renderer.render_rays_batch(ro, rd)
    renderer.settings = dataclasses.replace(renderer.settings, ray_chunk=48)
    chunked = renderer.render_rays_batch(ro, rd)
    assert chunked["rgb"].shape == (64, 3)
    for k, v in whole.items():
        assert bool(torch.isfinite(chunked[k]).all())
        torch.testing.assert_close(chunked[k], v, atol=1e-6, rtol=0)
