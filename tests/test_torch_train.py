"""Port parity for the training path: the loss and its parameter
gradients, the optimizer with its clip and schedule, the device ray
pipeline, the train split of the procedural scenes, checkpoints read
across the two packages, and the training CLI on the CPU. Both packages
get the same numpy inputs; JAX runs on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.datasets.pipeline import (
    DeviceRayPipeline as JaxPipeline,
)
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.models.nerf.renderer import (
    volume_renderer as jax_vr,
)
from nerf_replication_tpu.train.optimizer import make_optimizer as jax_optim
from nerf_replication_tpu.train.scheduler import make_lr_schedule as jax_sched
from nerf_replication_tpu.train.trainers.nerf import (
    NetworkWrapper as JaxWrapper,
)
from nerf_replication_tpu.utils import ckpt_utils as jax_ckpt
from nerf_replication_tpu.utils import synthetic_scene as jax_scene
from nerf_replication_tpu_torch import config
from nerf_replication_tpu_torch.datasets import DeviceRayPipeline
from nerf_replication_tpu_torch.datasets.nerf.blender import Dataset
from nerf_replication_tpu_torch.evaluators import make_evaluator
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import volume_renderer
from nerf_replication_tpu_torch.train import cli as train_cli
from nerf_replication_tpu_torch.train import make_optimizer, make_trainer
from nerf_replication_tpu_torch.train.cli import main as train_main
from nerf_replication_tpu_torch.train.scheduler import make_lr_schedule
from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper
from nerf_replication_tpu_torch.utils import ckpt_utils
from nerf_replication_tpu_torch.utils import synthetic_scene as scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["network.nerf.D", "4", "network.nerf.skips", "[1]",
        "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "task_arg.N_rays", "16"]


def _cfgs(monkeypatch, *opts):
    """(port cfg, JAX cfg) of configs/nerf/hard.yaml with ``opts``."""
    monkeypatch.chdir(ROOT)
    argv = ["--cfg_file", "configs/nerf/hard.yaml", *opts]
    return (config.make_cfg(config.parse_args(argv)),
            jax_config.make_cfg(jax_config.parse_args(argv)))


def _rays(n, seed):
    g = np.random.default_rng(seed)
    eye = g.normal(size=(n, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.2 * g.normal(size=(n, 3))
    return {"rays_o": eye.astype(np.float32), "rays_d": d.astype(np.float32),
            "colors": g.uniform(size=(n, 3)).astype(np.float32)}


def _flax_grads_as_port(tree) -> dict:
    """A Flax gradient tree as the port's state_dict names and layout."""
    return ckpt_utils.params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_grads_match_jax(monkeypatch, fused):
    """loss_fn with no randomness (JAX ``key=None``, port no generator) on
    a tiny hard config, through the nn.Module arm against the JAX XLA arm
    and through the fused arm (plain versions on the CPU) against the JAX
    Pallas kernels in interpret mode. At random init with 16 rays the
    deepest leaves' gradients are ill-conditioned: the JAX package's own
    two arms differ by 8% of the norm on the fine pts_0 kernel. So each
    leaf is held to 10% (read: 6% on the scalar alpha bias of the
    nn.Module arm, whose bias add rounds once where Flax's bf16 Dense
    rounds twice, 5% on fine pts_0) and all leaves together to 2% (read
    1.1%)."""
    flag = ["network.use_pallas_mlp_train", str(fused)]
    cfg, jcfg = _cfgs(monkeypatch, *TINY, *flag)
    jnet = jax_make_network(jcfg)
    params = init_params(jnet, jax.random.key(3))
    batch = _rays(16, seed=1)
    jwrap = JaxWrapper(jnet, jcfg)

    def jloss(p):
        return jwrap.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             None, train=True)[0]

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    net = make_network(cfg)
    net.load_state_dict(ckpt_utils.params_from_jax(
        jax.tree.map(np.asarray, params)))
    wrap = NetworkWrapper(net, cfg)
    loss, (out, stats, _) = wrap.loss_fn(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None, train=True)
    loss.backward()
    tol_loss, tol_all = (2e-4, 2e-2) if fused else (2e-3, 2e-2)
    assert float(loss.detach()) == pytest.approx(float(ref_loss),
                                                 rel=tol_loss)
    assert float(stats["psnr"]) == pytest.approx(
        -10 * np.log10(float(stats["color_mse"])), rel=1e-6)
    ref = _flax_grads_as_port(ref_grads)
    rel = {name: np.linalg.norm(p.grad.numpy() - ref[name].numpy())
           / (np.linalg.norm(ref[name].numpy()) + 1e-12)
           for name, p in net.named_parameters()}
    assert max(rel.values()) < 0.1, rel
    ours = np.concatenate([p.grad.numpy().ravel()
                           for _, p in net.named_parameters()])
    theirs = np.concatenate([ref[name].numpy().ravel()
                             for name, _ in net.named_parameters()])
    total = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    assert total < tol_all


def test_train_path_needs_no_inference_mode(monkeypatch):
    """The eval render runs under inference_mode; the train render keeps
    autograd, and a network the fused kernels do not cover raises when
    the kernels are asked for; ``random_bkgd`` is a flag of the loss
    module."""
    cfg, _ = _cfgs(monkeypatch, *TINY, "device", "cpu")
    wrap = NetworkWrapper(make_network(cfg), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _rays(16, seed=2).items()}
    gen = torch.Generator().manual_seed(0)
    loss, _ = wrap.loss_fn(batch, gen, train=True)
    assert loss.requires_grad
    cfg_w, _ = _cfgs(monkeypatch, *TINY, "network.nerf.W", "128")
    with pytest.raises(ValueError, match="width 128"):
        NetworkWrapper(make_network(cfg_w), cfg_w).loss_fn(batch, gen)
    cfg_b, _ = _cfgs(monkeypatch, *TINY, "task_arg.random_bkgd", "True")
    assert NetworkWrapper(make_network(cfg_b), cfg_b).random_bkgd
    assert not wrap.random_bkgd


def test_random_bkgd_loss_matches_jax(monkeypatch):
    """loss_fn with ``task_arg.random_bkgd`` on a tiny hard config through
    the nn.Module arm against the JAX XLA arm, both given the background
    colours that the JAX package draws from its key and the same ``alpha``;
    ``perturb`` and ``raw_noise_std`` off and both packages' importance
    sampling at its deterministic ``u`` (the JAX package samples the CDF
    at random ``u`` whenever it has a key). Loss and PSNR within 2e-3
    relative, the bound of the nn.Module arm in
    test_loss_and_grads_match_jax (Flax's bf16 Dense rounds twice). The
    recomposed targets differ from the white-background ones, which a run
    without a generator or without ``alpha`` still uses."""
    opts = [*TINY, "network.use_pallas_mlp_train", "False",
            "task_arg.random_bkgd", "True", "task_arg.perturb", "0",
            "task_arg.raw_noise_std", "0"]
    cfg, jcfg = _cfgs(monkeypatch, *opts)
    jnet = jax_make_network(jcfg)
    params = init_params(jnet, jax.random.key(3))
    batch = _rays(16, seed=4)
    batch["alpha"] = (np.random.default_rng(5).integers(0, 256, 16)
                      / 255.0).astype(np.float32)
    key = jax.random.key(11)
    bg = np.asarray(jax.random.uniform(jax.random.split(key)[1], (16, 3)))

    jax_pdf, port_pdf = jax_vr.sample_pdf, volume_renderer.sample_pdf
    monkeypatch.setattr(jax_vr, "sample_pdf",
                        lambda bins, w, n, key=None: jax_pdf(bins, w, n))
    monkeypatch.setattr(volume_renderer, "sample_pdf",
                        lambda bins, w, n, generator=None: port_pdf(bins, w,
                                                                    n))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, (_, ref_stats, _) = JaxWrapper(jnet, jcfg).loss_fn(
        params, jbatch, key, train=True)

    net = make_network(cfg)
    net.load_state_dict(ckpt_utils.params_from_jax(
        jax.tree.map(np.asarray, params)))
    wrap = NetworkWrapper(net, cfg)
    drawn = []

    def given_background(colors, generator):
        drawn.append(colors.shape)
        return torch.from_numpy(bg.copy())

    monkeypatch.setattr(NetworkWrapper, "draw_background",
                        staticmethod(given_background))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    loss, (_, stats, _) = wrap.loss_fn(tbatch, gen, train=True)
    assert drawn == [(16, 3)]
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=2e-3)
    assert float(stats["psnr"]) == pytest.approx(float(ref_stats["psnr"]),
                                                 rel=2e-3)
    # the JAX conditions: no generator, eval, or no alpha -> white targets
    white, _ = wrap.loss_fn(tbatch, None, train=True)
    no_alpha, _ = wrap.loss_fn({k: v for k, v in tbatch.items()
                                if k != "alpha"}, gen, train=True)
    assert drawn == [(16, 3)]
    assert float(white.detach()) == pytest.approx(float(no_alpha.detach()),
                                                  rel=1e-6)
    assert abs(float(white.detach()) - float(loss.detach())) \
        > 0.05 * float(loss.detach())
    monkeypatch.undo()
    real = NetworkWrapper.draw_background(tbatch["colors"], gen)
    assert real.shape == (16, 3) and 0 <= float(real.min()) \
        and float(real.max()) < 1


@pytest.mark.parametrize("optim", ["adam", "adamw", "sgd", "radam"])
def test_optimizer_matches_optax(monkeypatch, optim):
    """Value clip 40 + optimizer + exponential schedule against the JAX
    package's optax chain for 5 steps on identical gradients (some beyond
    the clip); the schedule decays within those steps."""
    kind, wd = ("adam", "0.01") if optim == "adamw" else (optim, "0.0")
    cfg, jcfg = _cfgs(monkeypatch, "train.optim", kind,
                      "train.weight_decay", wd, "ep_iter", "2",
                      "train.scheduler.decay_epochs", "3")
    g = np.random.default_rng(0)
    p0 = g.normal(size=(5, 7)).astype(np.float32)
    grads = [(g.normal(size=p0.shape) * 30).astype(np.float32)
             for _ in range(5)]
    assert max(np.abs(gr).max() for gr in grads) > 40
    opt = jax_optim(jcfg)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = make_optimizer(cfg, [tp])
    for gr in grads:
        upd, state = opt.update(jnp.asarray(gr), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(gr.copy())
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)
    assert topt.count == 5


@pytest.mark.parametrize("wd", ["0.0", "0.01"])
def test_adam_updates_take_optax_float32_bias_corrections(monkeypatch, wd):
    """Each of 100 Adam updates, taken from zero parameters so that the
    update is the parameter, within 1e-6 of optax's largest. optax's bias
    corrections 1 - b**t are float32 (1.3e-5 low at b 0.999); with
    float64 ones the updates would be ~6e-6 larger."""
    cfg, jcfg = _cfgs(monkeypatch, "train.weight_decay", wd)
    g = np.random.default_rng(1)
    grads = [g.normal(size=(64,)).astype(np.float32) for _ in range(100)]
    opt = jax_optim(jcfg)
    zero = jnp.zeros(64, jnp.float32)
    state = opt.init(zero)
    tp = torch.nn.Parameter(torch.zeros(64))
    topt = make_optimizer(cfg, [tp])
    for gr in grads:
        upd, state = opt.update(jnp.asarray(gr), state, zero)
        with torch.no_grad():
            tp.zero_()
        tp.grad = torch.from_numpy(gr.copy())
        topt.step()
        expect = np.asarray(upd)
        np.testing.assert_allclose(tp.detach().numpy(), expect, rtol=0,
                                   atol=1e-6 * np.abs(expect).max())


@pytest.mark.parametrize("sched", [
    ["train.scheduler.type", "exponential"],
    ["train.scheduler.type", "multi_step", "train.scheduler.milestones",
     "[2, 4]", "train.scheduler.gamma", "0.5"],
    ["train.scheduler.type", "warmup_multi_step",
     "train.scheduler.milestones", "[3, 5]",
     "train.scheduler.warmup_epochs", "2"]])
def test_lr_schedule_matches_jax(monkeypatch, sched):
    cfg, jcfg = _cfgs(monkeypatch, "ep_iter", "3", *sched)
    ours, theirs = make_lr_schedule(cfg), jax_sched(jcfg)
    for step in range(0, 25):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)


def _uv_image(H, W):
    """An image whose red and green channels are the pixel's u and v."""
    img = np.zeros((1, H, W, 3), np.uint8)
    img[0, ..., 0] = np.arange(W)[None, :]
    img[0, ..., 1] = np.arange(H)[:, None]
    return img


def test_pipeline_rays_and_precrop_match_jax():
    """Port rays through given pixels equal the JAX pipeline's
    ``_pixel_rays``; every drawn pixel of either pipeline lies inside the
    port's bounds, the centre crop before ``precrop_iters`` and the whole
    image after, and the draws reach both edges."""
    H = W = 40
    pose = scene.look_at_pose(np.array([1.0, -3.0, 2.5]))
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    img = _uv_image(H, W)
    kw = dict(n_rays=4096, precrop_iters=10, precrop_frac=0.5)
    ours = DeviceRayPipeline(img, pose[None], K, **kw)
    theirs = JaxPipeline(img, pose[None], K, **kw)
    u = np.array([0.0, 3.0, 17.0, 39.0], np.float32)
    v = np.array([0.0, 21.0, 5.0, 39.0], np.float32)
    ro, rd = ours._pixel_rays(torch.from_numpy(pose), torch.from_numpy(u),
                              torch.from_numpy(v))
    jro, jrd = theirs._pixel_rays(jnp.asarray(pose), jnp.asarray(u),
                                  jnp.asarray(v))
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=0)
    gen = torch.Generator().manual_seed(0)
    for step, bounds in ((0, (10, 30, 10, 30)), (10, (0, 40, 0, 40))):
        assert ours.bounds(step) == bounds
        b = ours.sample(gen, step)
        jb = theirs.sample(jax.random.key(step), step)
        for colors in (b["colors"].numpy(), np.asarray(jb["colors"])):
            uu, vv = (np.round(colors[:, :2] * 255).astype(int).T)
            assert (uu.min(), uu.max() + 1, vv.min(), vv.max() + 1) == bounds
        uu, vv = np.round(b["colors"].numpy()[:, :2] * 255).T
        _, rd = ours._pixel_rays(torch.from_numpy(pose),
                                 torch.tensor(uu, dtype=torch.float32),
                                 torch.tensor(vv, dtype=torch.float32))
        torch.testing.assert_close(b["rays_d"], rd, atol=0, rtol=0)
    across = DeviceRayPipeline(np.repeat(img, 3, 0), np.stack([pose] * 3), K,
                               n_rays=64, sample_across_images=True)
    b = across.sample(gen)
    assert b["rays_o"].shape == b["rays_d"].shape == b["colors"].shape \
        == (64, 3)


def test_train_views_match_generate_scene(tmp_path, monkeypatch):
    """train_views draws all 100 train poses before taking a subset, as
    generate_scene writes them, and its images are what the Blender
    loader reads from the written files."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "probe", H=4, W=4, n_train=100,
                             n_val=0, n_test=0)
    with open(tmp_path / "probe" / "transforms_train.json") as f:
        frames = json.load(f)["frames"]
    idx = [0, 7, 99]
    images, poses, K, alphas = scene.train_views("probe", 4, 4, idx)
    for i, pose in zip(idx, poses):
        np.testing.assert_allclose(
            pose, np.array(frames[i]["transform_matrix"]), atol=1e-6)
    cfg = config.CN({"scene": "probe", "task_arg": {"white_bkgd": 1}})
    ds = Dataset(cfg, data_root=str(tmp_path), split="train", H=4, W=4)
    ref_images, _, ref_K = ds.as_arrays()
    np.testing.assert_array_equal(images, ref_images[idx])
    np.testing.assert_array_equal(alphas, ds.alpha_arrays()[idx])
    np.testing.assert_allclose(K, ref_K, rtol=1e-6)


def test_checkpoints_cross_read(tmp_path, monkeypatch):
    """A port checkpoint is read by the JAX load_network and passes its
    check_params_compat; a JAX one is read by the port; keep-5 retention
    and latest.ckpt as the JAX package writes them."""
    cfg, jcfg = _cfgs(monkeypatch, *TINY)
    net = make_network(cfg)
    trainer = make_trainer(cfg, net)
    state = (trainer.optimizer.state_dict(), {"step": 3},
             {"step": 3, "epoch": 0})
    for epoch in range(7):
        ckpt_utils.save_model(net, *state, epoch, str(tmp_path / "port"))
    ckpt_utils.save_model(net, *state, 7, str(tmp_path / "port"), latest=True)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["2.ckpt", "3.ckpt", "4.ckpt", "5.ckpt", "6.ckpt",
                     "latest.ckpt"]
    jnet = jax_make_network(jcfg)
    loaded = jax_ckpt.load_network(str(tmp_path / "port"))
    jax_ckpt.check_params_compat(loaded, init_params(jnet, jax.random.key(0)))
    for name, value in ckpt_utils.params_from_jax(loaded).items():
        np.testing.assert_array_equal(value.numpy(),
                                      net.state_dict()[name].numpy())
    payload = ckpt_utils.load_model(str(tmp_path / "port"))
    assert payload["epoch"] == 7 and payload["scheduler"] == {"step": 3}
    trainer.optimizer.load_state_dict(payload["optim"])

    params = jax.tree.map(np.asarray, init_params(jnet, jax.random.key(5)))
    jax_ckpt.save_model(params, {}, {"step": 9}, {}, 4, str(tmp_path / "jax"))
    net2 = make_network(cfg)
    net2.load_state_dict(ckpt_utils.params_from_jax(
        ckpt_utils.load_network(str(tmp_path / "jax"))))
    back = ckpt_utils.params_to_jax(net2.state_dict())
    for branch, layers in params["params"].items():
        for layer, leaf in layers.items():
            for k, value in leaf.items():
                np.testing.assert_array_equal(
                    back["params"][branch][layer][k], value)


def test_cli_trains_resumes_and_tests(tmp_path, monkeypatch):
    """python -m nerf_replication_tpu_torch.train on a 32x32 probe scene on
    the CPU: the loss falls over two epochs, a resumed run continues the
    step count and the epoch, and --test evaluates the checkpoint."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "probe", H=32, W=32, n_train=4,
                             n_val=0, n_test=1)
    monkeypatch.chdir(ROOT)
    argv = ["--cfg_file", "configs/nerf/probe.yaml", "device", "cpu",
            *TINY[:8], "task_arg.N_rays", "64",
            "train_dataset.data_root", str(tmp_path),
            "test_dataset.data_root", str(tmp_path),
            "train_dataset.H", "32", "train_dataset.W", "32",
            "test_dataset.H", "32", "test_dataset.W", "32",
            "test_dataset.input_ratio", "1.0",
            "trained_model_dir", str(tmp_path / "model"),
            "record_dir", str(tmp_path / "record"),
            "result_dir", str(tmp_path / "result"), "save_result", "False",
            "ep_iter", "10", "save_ep", "1", "save_latest_ep", "1",
            "eval_ep", "2"]
    trainer = train_main(argv + ["train.epoch", "2", "resume", "False"])
    assert trainer.step == 20
    first, last = trainer.summaries
    assert np.isfinite(np.concatenate([first["loss"], last["loss"]])).all()
    assert last["loss"].mean() < first["loss"].mean()
    resumed = train_main(argv + ["train.epoch", "3"])
    assert resumed.step == 30
    assert [s["epoch"] for s in resumed.summaries] == [2]
    result = train_main(["--test"] + argv)
    assert set(result) == {"mse", "psnr", "ssim"}


def test_cli_trains_a_split_without_arrays_through_the_host_loader(
        tmp_path, monkeypatch):
    """A train split with no ``as_arrays`` (here a Blender split seen only
    through ``__getitem__``) trains through ``Trainer.train`` over that
    same dataset, built once, where the JAX package's train.py takes its
    host loader."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "probe", H=32, W=32, n_train=4,
                             n_val=0, n_test=0)
    monkeypatch.chdir(ROOT)

    class ItemsOnly:
        reads = 0

        def __init__(self, dataset):
            self.dataset = dataset

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, index):
            ItemsOnly.reads += 1
            return self.dataset[index]

    built = []
    make_split = train_cli.make_train_dataset

    def make_items_only(cfg):
        built.append(cfg.train_dataset.split)
        return ItemsOnly(make_split(cfg))

    monkeypatch.setattr(train_cli, "make_train_dataset", make_items_only)
    trainer = train_main([
        "--cfg_file", "configs/nerf/probe.yaml", "device", "cpu",
        *TINY[:8], "task_arg.N_rays", "64",
        "train_dataset.data_root", str(tmp_path),
        "train_dataset.H", "32", "train_dataset.W", "32",
        "trained_model_dir", str(tmp_path / "model"),
        "record_dir", str(tmp_path / "record"), "ep_iter", "6",
        "save_ep", "100", "save_latest_ep", "100", "eval_ep", "100",
        "train.epoch", "1", "resume", "False"])
    assert built == ["train"] and ItemsOnly.reads == 6 == trainer.step
    summary = trainer.summaries[-1]
    assert summary["data_time"].shape == (6,) and summary["rows"] == 64
    assert np.isfinite(summary["loss"]).all()


NGP_TINY = ["network.xyz_encoder.num_levels", "4",
            "network.xyz_encoder.desired_resolution", "64",
            "network.xyz_encoder.log2_bricks", "5",
            "task_arg.N_samples", "8", "task_arg.N_importance", "8",
            "task_arg.N_rays", "64", "task_arg.precrop_iters", "3"]


def test_ngp_cli_trains_resumes_and_checkpoints(tmp_path, monkeypatch):
    """python -m nerf_replication_tpu_torch.train on configs/nerf/
    hard_ngp.yaml cut to 4 levels, on a 32x32 probe scene (RGBA files, so
    ``random_bkgd`` applies) on the CPU: the loss falls, the table moves
    and the optimizer holds its moments, a resumed run continues, the
    checkpoint's JAX-format tree loads back bit for bit and is what the
    JAX package's load_network reads, and ``val`` packs the eval table
    from the current parameters each time."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "probe", H=32, W=32, n_train=4,
                             n_val=0, n_test=1)
    monkeypatch.chdir(ROOT)
    data = ["scene", "probe"]
    for split in ("train_dataset", "test_dataset"):
        data += [f"{split}.data_root", str(tmp_path), f"{split}.H", "32",
                 f"{split}.W", "32", f"{split}.input_ratio", "1.0"]
    argv = ["--cfg_file", "configs/nerf/hard_ngp.yaml", "device", "cpu",
            *NGP_TINY, *data, "trained_model_dir", str(tmp_path / "model"),
            "record_dir", str(tmp_path / "record"),
            "result_dir", str(tmp_path / "result"), "save_result", "False",
            "ep_iter", "10", "save_ep", "1", "save_latest_ep", "1",
            "eval_ep", "2"]
    drawn = []
    draw = NetworkWrapper.draw_background

    def counting(colors, generator):
        drawn.append(colors.shape)
        return draw(colors, generator)

    monkeypatch.setattr(NetworkWrapper, "draw_background",
                        staticmethod(counting))
    trainer = train_main(argv + ["train.epoch", "2", "resume", "False"])
    assert trainer.step == 20 and drawn == [(64, 3)] * 20
    first, last = trainer.summaries
    assert np.isfinite(np.concatenate([first["loss"], last["loss"]])).all()
    assert last["loss"].mean() < first["loss"].mean()
    net = trainer.network
    cfg = trainer.cfg
    fresh = make_network(cfg)
    table = net.xyz_encoder.table.detach()
    assert tuple(table.shape) == (512, 256)
    assert float((table - fresh.xyz_encoder.table.detach()).abs().max()) \
        > 1e-3
    names = [n for n, _ in net.named_parameters()]
    state = trainer.optimizer.state_dict()["optimizer"]["state"]
    moments = state[names.index("xyz_encoder.table")]
    assert tuple(moments["exp_avg"].shape) == (512, 256)
    assert float(moments["exp_avg_sq"].abs().max()) > 0

    # the checkpoint: bit for bit through the port, readable by JAX
    payload = ckpt_utils.load_model(cfg.trained_model_dir)
    assert payload["epoch"] == 1 and payload["scheduler"] == {"step": 20}
    loaded = ckpt_utils.params_from_jax(payload["net"])
    assert set(loaded) == set(net.state_dict())
    for name, value in net.state_dict().items():
        assert torch.equal(loaded[name], value), name
    saved = payload["optim"]["optimizer"]["state"]
    for index, entry in state.items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(saved[index][k]),
                               torch.as_tensor(v).cpu()), (index, k)
    jax_tree = jax_ckpt.load_network(cfg.trained_model_dir)
    np.testing.assert_array_equal(
        np.asarray(jax_tree["params"]["xyz_encoder"]["table"]), table.numpy())
    jcfg = jax_config.make_cfg(jax_config.parse_args(argv))
    jax_ckpt.check_params_compat(
        jax_tree, init_params(jax_make_network(jcfg), jax.random.key(0)))

    resumed = train_main(argv + ["train.epoch", "3"])
    assert resumed.step == 30
    assert [s["epoch"] for s in resumed.summaries] == [2]

    # val packs the eval table anew: a changed table changes the metrics
    loader = list(Dataset(cfg, data_root=str(tmp_path), split="test", H=32,
                          W=32))
    before = resumed.val(2, loader, make_evaluator(cfg))
    with torch.no_grad():
        resumed.network.xyz_encoder.table.zero_()
    after = resumed.val(2, loader, make_evaluator(cfg))
    assert set(before) == {"mse", "psnr", "ssim"}
    assert before["psnr"] != after["psnr"]
