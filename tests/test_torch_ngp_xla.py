"""Port parity for an NGP network on the vertex-exact (``xla``) hash grid:
configs/nerf/hard_ngp.yaml with ``network.xyz_encoder.backend xla`` cut to
4 levels (4 -> 32, two dense and two hashed) and ``log2_hashmap_size``
10, a fresh JAX init carried to the port. Its raw output against JAX's
``Network.apply``, one batch's loss and every leaf gradient against
``jax.grad`` (no randomness: ``perturb`` 0, no key), a render against the
JAX renderer, the routing (no kernel covers the xla grid, so eval and
training run the ``nn.Module``, as the JAX package runs ``net.apply``; a
brick network still takes the fused kernel), ``load_model``'s row check
naming ``log2_hashmap_size``, and ``run_evaluate`` at 16x16. The
probe48_ngp config, which names no backend, builds an xla network.

Tolerances: raw outputs within 1e-5 (f32 MLP sums in another order);
the loss within 1e-5 relative; every leaf gradient within 1e-4 of its
norm; the render's rgb and acc within 1e-5, depth within 1e-4."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import default_cfg as jax_default_cfg
from nerf_replication_tpu.config import load_cfg_tree as jax_load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    Renderer as JaxRenderer,
)
from nerf_replication_tpu.train.trainers.nerf import (
    NetworkWrapper as JaxWrapper,
)
from nerf_replication_tpu_torch import run
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.encoding import hashgrid
from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
from nerf_replication_tpu_torch.ops import (
    eval_encode,
    fused_ngp,
    hashgrid_kernel,
    mlp_kernel,
    mlp_train,
)
from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import (
    params_from_jax,
    params_to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = {"backend": "xla", "num_levels": 4, "base_resolution": 4,
        "desired_resolution": 32, "log2_hashmap_size": 10}
SMALL = [x for k, v in GRID.items()
         for x in (f"network.xyz_encoder.{k}", str(v))] + [
    "task_arg.N_samples", "8", "task_arg.N_importance", "8",
    "task_arg.N_rays", "16", "task_arg.perturb", "0",
    "task_arg.raw_noise_std", "0"]


def port_cfg(*opts):
    return make_cfg(parse_args(["--type", "evaluate", "--cfg_file",
                                "configs/nerf/hard_ngp.yaml", "device", "cpu",
                                "save_result", "False", *SMALL, *opts]))


def _counts():
    """Every port kernel's launches and every plain version's calls."""
    fns = [hashgrid_kernel.brick_hash_encode,
           hashgrid_kernel.brick_hash_encode_bwd,
           mlp_kernel.fused_nerf_mlp_enc, mlp_kernel.fused_nerf_mlp,
           mlp_train.fused_nerf_mlp_bwd, eval_encode.brick_encode_eval,
           fused_ngp.fused_ngp_eval]
    plain = [hashgrid_kernel.brick_encode_reference,
             hashgrid_kernel.brick_encode_bwd_reference,
             mlp_kernel.fused_nerf_mlp_enc_reference,
             mlp_kernel.fused_nerf_mlp_reference,
             mlp_train.fused_nerf_mlp_bwd_reference,
             eval_encode.brick_encode_eval_reference,
             fused_ngp.fused_ngp_eval_reference]
    return ([tracing.counts[f"{f.__name__}.launches"] for f in fns],
            [tracing.counts[f"{f.__name__}.calls"] for f in plain])


@pytest.fixture(scope="module")
def nets():
    """(port cfg, JAX cfg, JAX net, its seed-0 params as numpy, the port
    net with those weights)."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = port_cfg()
        jcfg = jax_load_cfg_tree("configs/nerf/hard_ngp.yaml",
                                 jax_default_cfg())
        jcfg.network.xyz_encoder.update(**GRID)
        jcfg.task_arg.update(N_samples=8, N_importance=8, N_rays=16,
                             perturb=0, raw_noise_std=0)
    finally:
        os.chdir(cwd)
    jnet = jax_make_network(jcfg)
    params = jax.tree.map(np.asarray, init_params(jnet, jax.random.key(0)))
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(params))
    return cfg, jcfg, jnet, params, net


def _rays(n, seed):
    g = np.random.default_rng(seed)
    eye = g.normal(size=(n, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.2 * g.normal(size=(n, 3))
    return {"rays_o": eye.astype(np.float32), "rays_d": d.astype(np.float32),
            "colors": g.uniform(size=(n, 3)).astype(np.float32)}


def test_network_is_xla(nets):
    cfg, _, _, params, net = nets
    enc = net.xyz_encoder
    assert enc.backend == "xla" and not enc.input_grad
    assert enc.layout.use_hash == (False, False, True, True)
    assert tuple(params["params"]["xyz_encoder"]["table"].shape) == \
        tuple(enc.table.shape) == (enc.layout.offsets[-1], 2)
    assert not ngp_renderer.is_brick_ngp(net) and ngp_renderer.is_xla_ngp(net)
    assert ngp_renderer.make_ngp_eval_apply(net) is None


@pytest.mark.parametrize("model", ["", "fine"])
def test_raw_matches_jax_network(nets, model):
    _, _, jnet, params, net = nets
    g = np.random.default_rng(1)
    pts = g.uniform(-1.4, 1.4, (64, 5, 3)).astype(np.float32)
    dirs = g.normal(size=(64, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    expect = jnet.apply(params, jnp.asarray(pts), jnp.asarray(dirs),
                        model=model)
    calls = tracing.counts["hash_encode.calls"]
    with torch.no_grad():
        out = net(torch.from_numpy(pts), torch.from_numpy(dirs), model=model)
    assert tracing.counts["hash_encode.calls"] == calls + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5,
                               rtol=0)


def test_loss_and_grads_match_jax(nets):
    """loss_fn on 16 rays with no randomness through the port's train
    apply (the nn.Module, with ``use_pallas_mlp_train`` at its default
    True) against the JAX arm: no kernel and no plain version of one runs."""
    cfg, jcfg, jnet, params, _ = nets
    batch = _rays(16, seed=2)

    def jloss(p):
        return JaxWrapper(jnet, jcfg).loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, None,
            train=True)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(params))
    wrap = NetworkWrapper(net, cfg)
    before = _counts()
    loss, _ = wrap.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                           None, train=True)
    loss.backward()
    assert _counts() == before
    assert wrap.renderer.train_apply is net
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, ref_grads))
    assert set(ref) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        err = np.linalg.norm(p.grad.numpy() - ref[name].numpy())
        assert err <= 1e-4 * np.linalg.norm(ref[name].numpy()), name
    assert net.xyz_encoder.table.grad.abs().max() > 0


def test_render_matches_jax_renderer(nets, capsys):
    """16 rays through build_renderer (use_pallas_mlp at its default True:
    the xla route, printed) against the JAX renderer's net.apply."""
    cfg, jcfg, jnet, params, net = nets
    batch = _rays(16, seed=3)
    ref = JaxRenderer(jnet, cfg=jcfg, mesh=None).render_rays_batch(
        params, batch["rays_o"], batch["rays_d"])
    before = _counts()
    renderer = run.build_renderer(cfg, net.eval())
    assert "xla hash grid" in capsys.readouterr().out
    assert renderer.apply_fn is net
    out = renderer.render_rays_batch(batch["rays_o"], batch["rays_d"])
    assert _counts() == before
    for key, atol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=0)


def test_brick_network_keeps_its_kernels(monkeypatch):
    """The same config with the brick backend still takes the fused NGP
    eval kernel and trains through the brick encode; a frequency network
    the fused MLP kernel does not cover still raises."""
    monkeypatch.chdir(ROOT)
    cfg = port_cfg("network.xyz_encoder.backend", "brick",
                   "network.xyz_encoder.log2_bricks", "5")
    net = make_network(cfg)
    assert ngp_renderer.is_brick_ngp(net) and not ngp_renderer.is_xla_ngp(net)
    renderer = run.build_renderer(cfg, net)
    assert renderer.apply_fn is not net
    calls = tracing.counts["fused_ngp_eval_reference.calls"]
    renderer.render_rays_batch(*[_rays(4, 4)[k] for k in ("rays_o",
                                                          "rays_d")])
    assert tracing.counts["fused_ngp_eval_reference.calls"] == calls + 2
    freq = make_cfg(parse_args(["--cfg_file", "configs/nerf/hard.yaml",
                                "device", "cpu", "network.nerf.W", "64"]))
    with pytest.raises(ValueError, match="use_pallas_mlp is on"):
        run.build_renderer(freq, make_network(freq))


def _write_pretrain(directory, net):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "pretrain.ckpt"), "wb") as f:
        pickle.dump({"net": params_to_jax(net.state_dict())}, f)


def test_load_model_checks_log2_hashmap_size(nets, tmp_path, monkeypatch):
    """A checkpoint of the config's table loads strictly, bit for bit; one
    of another log2_hashmap_size is refused by name."""
    monkeypatch.chdir(ROOT)
    _, _, _, _, net = nets
    _write_pretrain(tmp_path, net)
    loaded = run.load_model(port_cfg("pretrain_path", str(tmp_path)),
                            torch.device("cpu"))
    for name, value in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name
    with pytest.raises(ValueError, match="log2_hashmap_size"):
        run.load_model(port_cfg("pretrain_path", str(tmp_path),
                                "network.xyz_encoder.log2_hashmap_size", "11"),
                       torch.device("cpu"))


def test_run_evaluate_xla_on_cpu(nets, tmp_path, monkeypatch):
    """The evaluate CLI's path at 16x16 (hard test view 0) on the carried
    weights: the nn.Module network, two calls a chunk, no kernel and no
    plain version of one; the image is finite."""
    monkeypatch.chdir(ROOT)
    _, _, _, _, net = nets
    _write_pretrain(tmp_path, net)
    cfg = port_cfg("pretrain_path", str(tmp_path))
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    before, calls = _counts(), tracing.counts["Network.calls"]
    res = run.run_evaluate(cfg, loader=views)
    assert _counts() == before and tracing.counts["Network.calls"] == calls + 2
    assert res["rgb"][0].shape == (256, 3)
    assert np.isfinite(res["rgb"][0]).all() and np.isfinite(res["psnr"])


def test_probe48_ngp_builds_an_xla_network(monkeypatch):
    """configs/nerf/probe48_ngp.yaml names no backend: the JAX default,
    the vertex-exact grid (12 levels, 2^17 rows a hashed level)."""
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args(["--cfg_file", "configs/nerf/probe48_ngp.yaml",
                               "device", "cpu"]))
    net = make_network(cfg)
    enc = net.xyz_encoder
    assert ngp_renderer.is_xla_ngp(net) and enc.output_dim == 24
    scales, offsets, _, _ = hashgrid._level_layout(3, 12, 17, 16, 256, 2.0)
    assert tuple(enc.table.shape) == (offsets[-1], 2)
    assert enc.layout.scales == tuple(scales)
