"""Port parity for the alpha channel that random-background training
needs: the Blender loader's ``alpha_arrays``, the device pipeline's
``alpha`` in both sampling modes, the procedural train views' alphas and
the CLI's choice of when to upload them, each against the JAX package on
the same files or arrays."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_replication_tpu.datasets.nerf.blender import Dataset as JaxDataset
from nerf_replication_tpu.datasets.pipeline import (
    DeviceRayPipeline as JaxPipeline,
)
from nerf_replication_tpu.utils import synthetic_scene as jax_scene
from nerf_replication_tpu_torch import config
from nerf_replication_tpu_torch.datasets import DeviceRayPipeline
from nerf_replication_tpu_torch.datasets.nerf.blender import Dataset
from nerf_replication_tpu_torch.train.cli import make_pipeline
from nerf_replication_tpu_torch.utils import synthetic_scene as scene

CFG = config.CN({"scene": "probe", "task_arg": {"white_bkgd": 1}})


@pytest.fixture()
def probe_scene(tmp_path, monkeypatch):
    """A 100-train-view 8x8 probe scene on disk, as generate_scene writes
    it (RGBA PNGs), its ground truth from the port's render_gt."""
    monkeypatch.setattr(jax_scene, "render_gt", scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "probe", H=8, W=8, n_train=100,
                             n_val=0, n_test=0)
    return tmp_path


def test_blender_alpha_arrays_match_jax_loader(probe_scene):
    """RGBA sources: the alpha channel kept beside the composited image,
    equal to the JAX loader's; the 8x8 probe views hold covered, empty and
    partly covered pixels."""
    kw = dict(data_root=str(probe_scene), split="train", H=8, W=8)
    ours, theirs = Dataset(CFG, **kw), JaxDataset(CFG, **kw)
    alphas = ours.alpha_arrays()
    assert alphas.shape == (100, 8, 8) and alphas.dtype == np.float32
    np.testing.assert_array_equal(alphas, theirs.alpha_arrays())
    np.testing.assert_array_equal(ours.as_arrays()[0], theirs.as_arrays()[0])
    assert alphas.min() == 0.0 and alphas.max() == 1.0
    assert ((alphas > 0) & (alphas < 1)).any()


def test_blender_alpha_arrays_none_for_rgb_sources(probe_scene):
    """A source without an alpha channel gives no alphas, in both loaders."""
    train = probe_scene / "probe" / "train"
    for name in os.listdir(train):
        Image.open(train / name).convert("RGB").save(train / name)
    kw = dict(data_root=str(probe_scene), split="train", H=8, W=8)
    assert Dataset(CFG, **kw).alpha_arrays() is None
    assert JaxDataset(CFG, **kw).alpha_arrays() is None


def test_train_views_alphas_match_generate_scene_rgba(probe_scene):
    """train_views' fourth array is the alpha of the RGBA files that
    generate_scene writes, as the JAX loader reads it."""
    idx = [0, 7, 99]
    images, _, _, alphas = scene.train_views("probe", 8, 8, idx)
    ref = JaxDataset(CFG, data_root=str(probe_scene), split="train", H=8, W=8)
    np.testing.assert_array_equal(alphas, ref.alpha_arrays()[idx])
    np.testing.assert_array_equal(images, ref.as_arrays()[0][idx])
    rgba = np.asarray(Image.open(probe_scene / "probe" / "train"
                                 / "r_7.png"))
    np.testing.assert_array_equal(np.round(alphas[1] * 255).astype(np.uint8),
                                  rgba[..., 3])


def _coded(n, H, W):
    """Images whose red and green are the pixel's u and v and whose blue
    is the image's number, and alphas that are a function of all three."""
    img = np.zeros((n, H, W, 3), np.uint8)
    img[..., 0] = np.arange(W)[None, None, :]
    img[..., 1] = np.arange(H)[None, :, None]
    img[..., 2] = np.arange(n)[:, None, None]
    code = img.astype(np.int64)
    alpha = (code[..., 0] * 5 + code[..., 1] * 3 + code[..., 2] * 7) % 256
    return img, alpha.astype(np.uint8)


@pytest.mark.parametrize("across", [False, True],
                         ids=["one image a step", "across images"])
def test_pipeline_alpha_matches_jax_pipeline(across):
    """Both pipelines return, for every pixel they draw, that pixel's
    alpha / 255 (the draws differ, so each batch's pixels are read back
    from its colours); without alphas a batch has no ``alpha``."""
    n, H, W = 3, 20, 24
    img, alpha = _coded(n, H, W)
    poses = np.stack([scene.look_at_pose(np.array([1.0, -3.0, 2.5]))] * n)
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    kw = dict(n_rays=512, sample_across_images=across)
    ours = DeviceRayPipeline(img, poses, K, alphas=alpha, **kw)
    theirs = JaxPipeline(img, poses, K, alphas=alpha, **kw)
    assert ours.alphas.dtype == torch.uint8
    batches = [ours.sample(torch.Generator().manual_seed(0)),
               theirs.sample(jax.random.key(0))]
    for b in batches:
        u, v, i = np.round(np.asarray(b["colors"]) * 255).astype(int).T
        got = np.asarray(b["alpha"])
        assert got.shape == (512,) and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, alpha[i, v, u].astype(np.float32) / np.float32(255.0))
        assert len(set(i)) == (3 if across else 1)
    plain = DeviceRayPipeline(img, poses, K, **kw)
    assert "alpha" not in plain.sample(torch.Generator().manual_seed(0))
    # float alphas in [0, 1] are stored as the same uint8
    as_float = DeviceRayPipeline(img, poses, K,
                                 alphas=alpha.astype(np.float32) / 255, **kw)
    assert torch.equal(as_float.alphas, ours.alphas)


@pytest.mark.parametrize("random_bkgd", [False, True])
def test_make_pipeline_uploads_alphas_only_for_random_bkgd(random_bkgd):
    """As train.py of the JAX package: the alphas reach the device only
    when ``task_arg.random_bkgd`` will read them; three arrays still do."""
    img, alpha = _coded(2, 8, 8)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]], np.float32)
    cfg = config.CN({"task_arg": {"N_rays": 16, "random_bkgd": random_bkgd}})
    pipeline = make_pipeline(cfg, (img, poses, K, alpha), "cpu")
    assert (pipeline.alphas is not None) == random_bkgd
    assert make_pipeline(cfg, (img, poses, K), "cpu").alphas is None
    assert make_pipeline(cfg, (img, poses, K, None), "cpu").alphas is None
