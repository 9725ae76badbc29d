"""Port parity for the host-side data path: the six samplers' index
streams, ``default_collate``, ``make_data_loader`` (train and test, plain
and distributed), the dataset catalog, the ``latent`` and ``light_stage``
datasets, ``generate_scene`` and ``run --type dataset``, against the JAX
package on the same numpy seeds and files.

Tolerances: index streams, batches and dataset items equal (bit for bit;
numpy draws them the same way in both packages); ``generate_scene``'s JSON
files equal and its PNGs within 1 uint8 level (the two packages integrate
the same field in float32 in different orders).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.datasets import collate as jax_collate
from nerf_replication_tpu.datasets import make_data_loader as jax_loader
from nerf_replication_tpu.datasets import samplers as jax_samplers
from nerf_replication_tpu.datasets.dataset_catalog import (
    DatasetCatalog as JaxCatalog,
)
from nerf_replication_tpu.datasets.latent import Dataset as JaxLatent
from nerf_replication_tpu.datasets.light_stage import Dataset as JaxLightStage
from nerf_replication_tpu.utils import synthetic_scene as jax_scene
from nerf_replication_tpu_torch import config, run
from nerf_replication_tpu_torch.datasets import (
    collate,
    make_data_loader,
    samplers,
)
from nerf_replication_tpu_torch.datasets.dataset_catalog import DatasetCatalog
from nerf_replication_tpu_torch.datasets.latent import Dataset as Latent
from nerf_replication_tpu_torch.datasets.light_stage import (
    Dataset as LightStage,
)
from nerf_replication_tpu_torch.utils import synthetic_scene as scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_LEVELS = 1


def _stream(it, epochs=(0, 1, 2)):
    """The sampler's indices in each epoch (set_epoch where it has one)."""
    out = []
    for e in epochs:
        if hasattr(it, "set_epoch"):
            it.set_epoch(e)
        out.append(list(it))
    return out


def _sampler_pairs():
    """(name, factory(module)) for each sampler and mode."""
    yield "sequential", lambda m: m.SequentialSampler(7)
    yield "random", lambda m: m.RandomSampler(9)
    yield "random_seeded", lambda m: m.RandomSampler(9, seed=4)
    for n, r in ((10, 3), (9, 3), (2, 4)):
        for rank in range(r):
            for shuffle in (True, False):
                yield (f"distributed_{n}_{r}_{rank}_{shuffle}",
                       lambda m, n=n, r=r, rank=rank, shuffle=shuffle:
                       m.DistributedSampler(n, r, rank, shuffle))
    for drop in (True, False):
        yield (f"batch_{drop}", lambda m, drop=drop: m.BatchSampler(
            m.RandomSampler(11), 4, drop))
    yield "iteration", lambda m: m.IterationBasedBatchSampler(
        m.BatchSampler(m.RandomSampler(5), 2, False), 7)
    yield "iteration_start", lambda m: m.IterationBasedBatchSampler(
        m.BatchSampler(m.DistributedSampler(6, 2, 1), 2, True), 9, 3)
    for strategy in ("range", "origin"):
        yield (f"image_size_{strategy}", lambda m, s=strategy:
               m.ImageSizeBatchSampler(
                   m.SequentialSampler(10), 3, False,
                   {"strategy": s, "min_hw": [100, 120],
                    "max_hw": [300, 400]}, seed=2))


SAMPLERS = dict(_sampler_pairs())


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_streams_match_jax(name):
    """Every epoch's index stream, its length, a distributed shard's
    padding, the image-size batches' (idx, h, w)."""
    ours, theirs = SAMPLERS[name](samplers), SAMPLERS[name](jax_samplers)
    assert len(ours) == len(theirs)
    assert _stream(ours) == _stream(theirs)
    if name.startswith("image_size_range"):
        sizes = {(h, w) for batch in _stream(ours, [0])[0]
                 for _, h, w in batch}
        assert all(h % 32 == 0 and w % 32 == 0 for h, w in sizes)
    if name.startswith("distributed_2_4"):
        assert len(list(ours)) == 1          # padded to one a rank


def test_distributed_shards_cover_and_pad():
    shards = [list(samplers.DistributedSampler(10, 3, r)) for r in range(3)]
    flat = sorted(i for s in shards for i in s)
    assert [len(s) for s in shards] == [4, 4, 4]
    assert set(flat) == set(range(10)) and len(flat) == 12
    with pytest.raises(ValueError):
        samplers.DistributedSampler(4, 2, 2)


def test_default_collate_matches_jax():
    g = np.random.default_rng(0)
    samples = [{"a": g.normal(size=(3, 2)).astype(np.float32),
                "meta": {"H": np.int32(4), "name": np.float64(i)},
                "pair": (np.arange(3) + i, np.float32(i)),
                "nested": [{"x": np.full(2, i)}]} for i in range(3)]
    ours = collate.default_collate(samples)
    theirs = jax_collate.default_collate(samples)

    def check(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                check(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b, strict=True):
                check(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    check(ours, theirs)
    assert ours["a"].shape == (3, 3, 2) and ours["pair"][0].shape == (3, 3)
    assert collate.default_collate([]) == {}
    cfg = config.CN({"train": {"collator": "default"},
                     "test": {"collator": "other"}})
    assert collate.make_collator(cfg, True) is collate.default_collate
    assert collate.make_collator(cfg, False) is collate.default_collate


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """A 16x16 hard scene, 5 train and 3 test views (the port's writer)."""
    root = tmp_path_factory.mktemp("loader")
    scene.generate_scene(str(root), "hard", H=16, W=16, n_train=5, n_val=0,
                         n_test=3)
    return str(root)


def _blender_cfgs(root, *opts):
    argv = ["--cfg_file", "configs/nerf/hard.yaml",
            "train_dataset.data_root", root, "test_dataset.data_root", root,
            "train_dataset.H", "16", "train_dataset.W", "16",
            "test_dataset.H", "16", "test_dataset.W", "16",
            "task_arg.N_rays", "32", "train.batch_size", "2", *opts]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        ours = config.make_cfg(config.parse_args(argv))
        theirs = jax_config.make_cfg(jax_config.parse_args(argv))
    finally:
        os.chdir(cwd)
    for cfg in (ours, theirs):
        cfg.train_dataset.seed = 9
    return ours, theirs


def _batches(loader):
    return [{k: v for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("mode", ["train", "train_distributed", "test",
                                  "test_distributed"])
def test_make_data_loader_batches_match_jax(blender_scene, mode):
    """Blender batches through make_data_loader, both packages on the same
    files: train (shuffled, 2 views a batch, 6 batches an epoch via
    max_iter) and test (sequential), and each as rank 1 of 2."""
    ours_cfg, theirs_cfg = _blender_cfgs(blender_scene)
    is_train = mode.startswith("train")
    kw = dict(is_train=is_train, max_iter=6 if is_train else -1)
    if mode.endswith("distributed"):
        kw.update(is_distributed=True, num_replicas=2, rank=1)
    ours = make_data_loader(ours_cfg, **kw)
    theirs = jax_loader(theirs_cfg, **kw)
    assert len(ours) == len(theirs)
    a, b = _batches(ours), _batches(theirs)
    assert len(a) == len(b) == len(ours)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    if is_train:
        assert a[0]["rays_o"].shape == (2, 32, 3)
    else:
        assert a[0]["colors"].shape == (1, 256, 3)


def test_run_dataset_prints_the_test_loader(blender_scene, capsys):
    ours, _ = _blender_cfgs(blender_scene)
    assert run.run_dataset(ours) == 3
    out = capsys.readouterr().out
    assert "rays_o shape: (1, 256, 3)" in out
    assert out.count("keys=") == 3


def test_run_dataset_cli(blender_scene, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    run.main(["--type", "dataset", "--cfg_file", "configs/nerf/hard.yaml",
              "test_dataset.data_root", blender_scene, "test_dataset.H", "16",
              "test_dataset.W", "16"])
    assert capsys.readouterr().out.count("keys=") == 3


def test_dataset_catalog_matches_jax():
    assert DatasetCatalog.dataset_attrs == JaxCatalog.dataset_attrs
    attrs = DatasetCatalog.get("LSTrain")
    attrs["split"] = "changed"
    assert DatasetCatalog.get("LSTrain") == JaxCatalog.get("LSTrain")


def test_latent_items_match_jax(tmp_path):
    data = np.random.default_rng(1).normal(size=(6, 200)).astype(np.float32)
    np.save(tmp_path / "lego.npy", data)
    kw = dict(data_root=str(tmp_path), batch_size=8)
    ours = Latent(config.CN({"scene": "lego"}), **kw)
    theirs = JaxLatent(jax_config.CN({"scene": "lego"}), **kw)
    assert len(ours) == len(theirs) == 6
    for x, y in zip(ours[0], theirs[0], strict=True):
        np.testing.assert_array_equal(x, y)
    assert [p.shape[1] for p in ours[0]] == [1, 31, 128, 40]


@pytest.fixture(scope="module")
def light_stage_rig(tmp_path_factory):
    """A 3-camera, 2-frame rig: annots.npy with K, R, T, seeded 20x24 RGB
    images, and one frame's vertices (the other has none)."""
    root = tmp_path_factory.mktemp("313_rig")
    g = np.random.default_rng(2)
    cams = {"K": [], "R": [], "T": [], "D": []}
    for c in range(3):
        K = np.array([[30.0 + c, 0, 12.0], [0, 31.0, 10.0], [0, 0, 1]])
        angle = 0.3 * c
        R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                      [-np.sin(angle), 0, np.cos(angle)]])
        cams["K"].append(K)
        cams["R"].append(R)
        cams["T"].append(np.array([[10.0], [-20.0], [3000.0 + c]]))
        cams["D"].append(np.zeros((5, 1)))
    ims = []
    for f in range(2):
        names = []
        for c in range(3):
            name = f"Camera_B{c + 1}/{f:06d}.jpg"
            os.makedirs(root / os.path.dirname(name), exist_ok=True)
            Image.fromarray(g.integers(0, 256, (20, 24, 3), dtype=np.uint8)
                            ).save(root / name, quality=100)
            names.append(name)
        ims.append({"ims": names})
    np.save(root / "annots.npy", {"cams": cams, "ims": ims},
            allow_pickle=True)
    os.makedirs(root / "new_vertices")
    np.save(root / "new_vertices" / "1.npy",
            g.normal(size=(50, 3)).astype(np.float32))
    return str(root)


@pytest.mark.parametrize("split,ratio", [("train", 1.0), ("test", 1.0),
                                         ("test", 0.5)])
def test_light_stage_items_match_jax(light_stage_rig, split, ratio):
    """Every item of a small rig, both packages: rays, colors, the
    frame's bounding box where its vertices exist; train items draw
    N_rays pixels from numpy's global generator, seeded alike."""
    kw = dict(data_root=light_stage_rig, split=split, input_ratio=ratio,
              cameras=[0, -1, 1], frames=[0, -1, 1])
    task = {"task_arg": {"N_rays": 37}}
    ours = LightStage(config.CN(task), **kw)
    theirs = JaxLightStage(jax_config.CN(task), **kw)
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        np.random.seed(i)
        a = ours[i]
        np.random.seed(i)
        b = theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "wbounds" in ours[0] and "wbounds" not in ours[5]
    n = 37 if split == "train" else int(20 * ratio) * int(24 * ratio)
    assert ours[0]["rays_d"].shape == (n, 3)


def test_generate_scene_matches_jax(tmp_path):
    """JSON files equal, every PNG within 1 uint8 level, at 24x24 (2
    train, 1 val, 2 test views with depth and normal maps)."""
    kw = dict(scene="hard", H=24, W=24, n_train=2, n_val=1, n_test=2)
    ours = scene.generate_scene(str(tmp_path / "ours"), **kw)
    theirs = jax_scene.generate_scene(str(tmp_path / "theirs"), **kw)
    names = sorted(os.path.relpath(os.path.join(d, f), theirs)
                   for d, _, fs in os.walk(theirs) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    assert sum(n.endswith("_normal_0001.png") for n in names) == 2
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)
        else:
            x = np.asarray(Image.open(a), dtype=np.int16)
            y = np.asarray(Image.open(b), dtype=np.int16)
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= PNG_LEVELS, name
