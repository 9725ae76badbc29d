"""utils.tracing: spans on only while a torch profiler records, their
tree over a training epoch and a frame, the store's limit, the totals,
and the benchmark metrics that read them. This file imports nothing of
JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_tracing.py

(the ``cuda`` test: the device times of a training step's stages).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import specs
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import Renderer
from nerf_replication_tpu_torch.train import make_trainer
from nerf_replication_tpu_torch.train.cli import make_pipeline
from nerf_replication_tpu_torch.train.recorder import SmoothedValue
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["network.nerf.D", "4", "network.nerf.skips", "[1]",
        "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "task_arg.N_rays", "16", "task_arg.precrop_iters", "0"]
STEP_CHILDREN = ["train.sample", "train.forward", "train.backward",
                 "train.optimizer"]
RENDER_STAGES = ["render.coarse", "render.resample", "render.fine"]


@pytest.fixture(autouse=True)
def empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _trainer(device, *opts, size=8, views=2):
    """A seeded trainer of configs/nerf/hard.yaml with ``opts`` and a
    pipeline over ``views`` random size x size views."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = make_cfg(parse_args(["--cfg_file", "configs/nerf/hard.yaml",
                                   "device", device.type, "seed", "3",
                                   *opts]))
    finally:
        os.chdir(cwd)
    g = np.random.default_rng(0)
    images = g.uniform(size=(views, size, size, 3)).astype(np.float32)
    poses = np.asarray(synthetic_scene.train_poses()[:views], np.float32)
    focal = size / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    trainer = make_trainer(cfg, make_network(cfg).to(device))
    return trainer, make_pipeline(cfg, (images, poses, K), device)


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def _is_user_annotation(event) -> bool:
    """A kineto event of a host ``record_function`` range; a PyTorch
    without ``activity_type()`` flags it itself."""
    if hasattr(event, "activity_type"):
        return event.activity_type() == "user_annotation"
    return (event.is_user_annotation()
            and event.device_type() == torch.autograd.DeviceType.CPU)


def test_span_off_records_nothing():
    """With no profiler, span is the shared no-op and a whole training
    epoch records nothing."""
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("train.step", root=0) is tracing.span("x")
    with tracing.span("train.step", root=0):
        pass
    trainer, pipeline = _trainer(torch.device("cpu"), *TINY)
    trainer.train_device(0, pipeline, n_steps=2)
    assert tracing.records() == [] and tracing.totals() == {}
    assert tracing.dropped() == 0


def test_train_device_spans_under_the_profiler():
    """A 3-step epoch under the profiler: three ``train.step`` roots whose
    ids are the global steps, each holding sample, forward, backward and
    optimizer, the render stages inside the forward; the epoch's end a
    root of its own; every span on the profiler's timeline as a user
    annotation."""
    trainer, pipeline = _trainer(torch.device("cpu"), *TINY)
    trainer.train_device(0, pipeline, n_steps=1)      # unprofiled: step 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_device(1, pipeline, n_steps=3)
    recs = tracing.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [(recs[i].name, recs[i].root) for i in roots] == [
        ("train.step", 1), ("train.step", 2), ("train.step", 3),
        ("train.epoch_end", 1)]
    for i in roots[:3]:
        assert _children(recs, i) == STEP_CHILDREN
        assert all(r.root == recs[i].root for r in recs if r.parent == i)
        (fwd,) = [j for j, r in enumerate(recs)
                  if r.parent == i and r.name == "train.forward"]
        assert _children(recs, fwd) == RENDER_STAGES
        assert recs[i].host_start_ns <= recs[fwd].host_start_ns \
            < recs[fwd].host_end_ns <= recs[i].host_end_ns
    t = tracing.totals()
    assert t["train.step"]["count"] == 3 and t["render.fine"]["count"] == 3
    assert t["train.step"]["device_ms"] is None       # no CUDA here
    assert t["train.step"]["host_ms"] >= sum(
        t[n]["host_ms"] for n in STEP_CHILDREN)
    annotations = {e.name() for e in prof.profiler.kineto_results.events()
                   if _is_user_annotation(e)}
    assert set(t) <= annotations


def test_host_loader_steps_are_spans():
    """``Trainer.train`` over host batches: a ``train.step`` a batch, its
    ``train.sample`` (the copy to the device) first."""
    trainer, pipeline = _trainer(torch.device("cpu"), *TINY)
    gen = torch.Generator().manual_seed(0)
    batches = [{k: v.numpy() for k, v in pipeline.sample(gen).items()}
               for _ in range(2)]

    recorder = SimpleNamespace(
        step=0, epoch=0, loss_stats={}, batch_time=SmoothedValue(),
        data_time=SmoothedValue(), update_loss_stats=lambda stats: None,
        record=lambda *args, **kwargs: None)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(0, batches, recorder)
    recs = tracing.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [(recs[i].name, recs[i].root) for i in roots] == [
        ("train.step", 0), ("train.step", 1)]
    assert all(_children(recs, i) == STEP_CHILDREN for i in roots)


def test_render_frame_spans():
    """One ``Renderer.render`` of 24 rays in chunks of 16: one
    ``render.frame`` root, and each chunk's coarse, resample and fine
    stages under it."""
    trainer, _ = _trainer(torch.device("cpu"), *TINY,
                          "task_arg.ray_chunk", "16")
    renderer = Renderer(trainer.network.eval(), trainer.cfg, mesh=None)
    g = np.random.default_rng(1)
    batch = {"rays_o": np.tile([[0.0, 0.0, 4.0]], (24, 1)),
             "rays_d": g.normal(size=(24, 3)) * 0.1 + [0.0, 0.0, -1.0]}
    renderer.render(batch)                            # unprofiled: frame 0
    with profile(activities=[ProfilerActivity.CPU]):
        rgb, _ = renderer.render(batch)
    assert rgb.shape == (24, 3)
    recs = tracing.records()
    assert [(r.name, r.root) for r in recs if r.parent < 0] == [
        ("render.frame", 1)]
    assert _children(recs, 0) == RENDER_STAGES * 2
    assert all(r.root == 1 for r in recs)


def test_store_stops_at_its_limit(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            with tracing.span("a", root=i):
                with tracing.span("b"):
                    pass
    assert [(r.name, r.root) for r in tracing.records()] == [
        ("a", 0), ("b", 0), ("a", 1), ("b", 1)]
    assert tracing.dropped() == 2
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_reset_inside_an_open_span_leaves_the_new_store_alone():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("old"):
            tracing.reset()
            with tracing.span("new", root=7):
                pass
    assert [(r.name, r.parent, r.root) for r in tracing.records()] == [
        ("new", -1, 7)]


def test_self_times_subtract_the_childrens():
    """Totals by name from hand-made spans: a step of 10 device ms whose
    two children take 3 and 4 keeps 3 of its own; a name with a span
    that has no device time reads None."""
    R = tracing.Record
    tracing._store.records = [
        R("s", -1, 0, 0, 2_000_000, device_ms=10.0),
        R("c", 0, 0, 100, 500_000, device_ms=3.0),
        R("d", 0, 0, 600_000, 1_000_000, device_ms=4.0),
        R("s", -1, 1, 2_000_000, 3_000_000, device_ms=5.0),
        R("c", 3, 1, 2_000_000, 2_500_000, device_ms=5.0),
        R("h", -1, 2, 3_000_000, 3_500_000)]
    t = tracing.totals()
    assert t["s"] == {"count": 2, "host_ms": 3.0, "device_ms": 15.0,
                      "self_device_ms": 3.0}
    assert t["c"]["device_ms"] == 8.0 and t["c"]["self_device_ms"] == 8.0
    assert t["h"]["device_ms"] is None and t["h"]["host_ms"] == 0.5


TOTALS = {"train.step": {"count": 20, "host_ms": 500.0, "device_ms": 600.0,
                         "self_device_ms": 2.0},
          "train.forward": {"count": 20, "host_ms": 100.0,
                            "device_ms": 120.0, "self_device_ms": 10.0},
          "train.backward": {"count": 20, "host_ms": 40.0,
                             "device_ms": 440.0, "self_device_ms": 440.0},
          "train.optimizer": {"count": 20, "host_ms": 30.0,
                              "device_ms": 16.0, "self_device_ms": 16.0},
          "render.frame": {"count": 3, "host_ms": 1200.0,
                           "device_ms": 1110.0, "self_device_ms": 0.0},
          "render.resample": {"count": 48, "host_ms": 10.0,
                              "device_ms": 60.0, "self_device_ms": 60.0}}


@pytest.mark.parametrize("metric, span, value", [
    ("step_host_ms.train", "train.step", 25.0),
    ("forward_ms.train", "train.forward", 6.0),
    ("backward_ms.train", "train.backward", 22.0),
    ("optimizer_ms.train", "train.optimizer", 0.8),
    ("resample_ms.dense", "render.resample", 20.0),
])
def test_span_metrics_read_the_totals(monkeypatch, metric, span, value):
    """Each program_span metric divides its span's total by its root's
    count; None without its span, or (device metrics) without device
    times."""
    m = specs.metric(metric)
    monkeypatch.setattr(tracing, "totals", lambda: TOTALS)
    assert m.read(None) == pytest.approx(value)
    monkeypatch.setattr(tracing, "totals", lambda: {
        k: v for k, v in TOTALS.items() if k != span})
    assert m.read(None) is None
    off_cuda = {k: {**v, "device_ms": None, "self_device_ms": None}
                for k, v in TOTALS.items()}
    monkeypatch.setattr(tracing, "totals", lambda: off_cuda)
    assert (m.read(None) is None) == (metric != "step_host_ms.train")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_stages_add_up_on_the_card(cuda):
    """Three steps at 1024 rays of 64+128 samples (the nn.Module MLP):
    each step's stages, by their CUDA events, add up to within 5% of the
    step's device time."""
    trainer, pipeline = _trainer(cuda, "task_arg.N_rays", "1024",
                                 "network.use_pallas_mlp_train", "False",
                                 "task_arg.precrop_iters", "0", size=64)
    trainer.train_device(0, pipeline, n_steps=2)      # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer.train_device(1, pipeline, n_steps=3)
    recs = tracing.records()
    steps = [i for i, r in enumerate(recs) if r.name == "train.step"]
    assert len(steps) == 3
    for i in steps:
        parts = [r.device_ms for r in recs if r.parent == i]
        assert len(parts) == 4 and recs[i].device_ms > 0
        assert sum(parts) == pytest.approx(recs[i].device_ms, rel=0.05)
