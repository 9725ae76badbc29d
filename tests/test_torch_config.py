"""Port parity: config loading, metrics and the Blender loader against the
JAX package (the port carries its own copies, so that it imports nothing
of the JAX package)."""

import glob
import os

import numpy as np
import pytest

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.datasets.nerf.blender import Dataset as JaxBlender
from nerf_replication_tpu.evaluators import metrics as jax_metrics
from nerf_replication_tpu.utils import synthetic_scene as jax_scene
from nerf_replication_tpu_torch import config
from nerf_replication_tpu_torch.datasets.nerf.blender import Dataset
from nerf_replication_tpu_torch.evaluators import metrics
from nerf_replication_tpu_torch.utils import synthetic_scene as scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True))
# what the port reads from a config, training and the host loader too
PORT_KEYS = ("task", "scene", "task_arg", "network",
             "test_dataset", "test_dataset_module", "network_module",
             "renderer_module", "evaluator_module", "train", "test",
             "train_dataset", "train_dataset_module", "loss_module",
             "ep_iter", "save_ep", "save_latest_ep", "eval_ep",
             "log_interval", "seed", "distributed", "mesh", "local_rank")


@pytest.mark.parametrize("cfg_file", CONFIGS)
def test_config_tree_matches_jax(cfg_file, monkeypatch):
    monkeypatch.chdir(ROOT)
    ours = config.load_cfg_tree(cfg_file, config.default_cfg())
    theirs = jax_config.load_cfg_tree(cfg_file, jax_config.default_cfg())
    for key in PORT_KEYS:
        if key in theirs:
            assert key in ours and ours[key] == theirs[key], key


def test_cli_overrides_and_output_dirs_match_jax(monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
            "task_arg.N_samples", "16", "network.nerf.D", "4",
            "other_opts", "ignored", "x"]
    ours = config.make_cfg(config.parse_args(argv))
    theirs = jax_config.make_cfg(jax_config.parse_args(argv))
    assert ours.task_arg == theirs.task_arg and ours.network == theirs.network
    assert ours.task_arg.N_samples == 16 and ours.network.nerf.D == 4
    assert ours.trained_model_dir == theirs.trained_model_dir
    assert ours.result_dir == theirs.result_dir
    assert ours.mesh == theirs.mesh and ours.local_rank == theirs.local_rank
    with pytest.raises(ValueError):
        config.make_cfg(config.parse_args(argv[:4] + ["task_arg.near", "x"]))


def test_metrics_match_jax():
    g = np.random.default_rng(0)
    gt = g.uniform(size=(40, 48, 3)).astype(np.float32)
    pred = np.clip(gt + g.normal(0, 0.05, gt.shape), -0.1, 1.1).astype(
        np.float32)
    assert metrics.psnr_uint8(pred, gt) == jax_metrics.psnr_uint8(pred, gt)
    p8, g8 = (pred.clip(0, 1) * 255).astype(np.uint8), (gt * 255).astype(
        np.uint8)
    assert metrics.ssim(p8, g8, win_size=7, channel_axis=2) == pytest.approx(
        jax_metrics.ssim(p8, g8, win_size=7, channel_axis=2), abs=1e-12)
    assert metrics.ssim(pred[..., 0], gt[..., 0]) == pytest.approx(
        jax_metrics.ssim(pred[..., 0], gt[..., 0]), abs=1e-12)


@pytest.mark.parametrize("split", ["test", "train"])
def test_blender_loader_matches_jax(tmp_path, monkeypatch, split):
    """The port's copy of the Blender loader gives the JAX loader's batch
    dicts on the same scene files (ground truth from the port's
    render_gt, so the scene writes fast)."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    n_train, n_test = (2, 0) if split == "train" else (0, 2)
    jax_scene.generate_scene(str(tmp_path), "hard", H=10, W=10,
                             n_train=n_train, n_val=0, n_test=n_test)
    cfg = config.CN({"scene": "hard",
                     "task_arg": {"N_rays": 16, "white_bkgd": 1}})
    kw = dict(data_root=str(tmp_path), split=split, H=10, W=10, seed=3)
    ours, theirs = Dataset(cfg, **kw), JaxBlender(cfg, **kw)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
