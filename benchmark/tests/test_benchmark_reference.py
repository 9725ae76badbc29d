"""The plain reference against the port at tiny sizes on the CPU, and
whole tiny runs with the timed path broken underneath, which must come
out not correct."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import specs
from benchmark.reference import field as ref_field


def test_reference_encodings_are_the_ports():
    from nerf_replication_tpu_torch.models.encoding.freq import freq_encode
    from nerf_replication_tpu_torch.models.encoding.sh import SHEncoder
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    g = torch.Generator().manual_seed(3)
    x = torch.rand(512, 3, generator=g)
    d = torch.randn(512, 3, generator=g)
    assert torch.equal(ref_field.freq_encode(x, 10), freq_encode(x, 10))
    assert torch.allclose(ref_field.sh_encode(d), SHEncoder(4)(d),
                          rtol=0, atol=1e-6)
    grid_cfg = specs.config("ngp-brick-hard")["model"]["grid"]
    grid = ref_field.BrickGrid(grid_cfg["num_levels"],
                               grid_cfg["base_resolution"],
                               grid_cfg["desired_resolution"],
                               grid_cfg["log2_bricks"], grid_cfg["bounds"])
    layout = hk.make_brick_layout(grid_cfg["num_levels"],
                                  grid_cfg["base_resolution"],
                                  grid_cfg["desired_resolution"],
                                  log2_bricks=grid_cfg["log2_bricks"])
    assert grid.n_rows == layout.n_rows == grid_cfg["table_rows"]
    table = torch.rand(grid.n_rows, 256, generator=g) * 2e-2 - 1e-2
    world = torch.rand(512, 3, generator=g) * 2.4 - 1.2
    ours = ref_field._BrickEncode.apply(table, grid.to_unit(world), grid)
    theirs = hk.brick_encode_reference(layout, table, grid.to_unit(world))
    assert torch.allclose(ours, theirs, rtol=0, atol=1e-7)


@pytest.mark.parametrize("cell,most", [
    ("ngp-train-tiny", {"grad_gap": 1e-5, "grad_diff_med": 1e-6,
                        "step_gap": 1e-4}),
    ("freq-train-tiny", {"grad_gap": 0.1, "step_gap": 0.1}),
    ("ngp-view-tiny", {"rms_levels": 0.0}),
    ("freq-dense-frame-tiny", {"rms_levels": 8.0}),
])
def test_reference_follows_the_port(run_tiny, cell, most):
    """The NGP model is f32 in both: its step and its viewer frame are the
    reference's up to the table gradient's summation order. The frequency
    model's products are bf16 in the port, f32 in the reference; at 8 + 8
    samples a bf16 rounding can move an inverse-CDF sample, so a 16x16
    frame reads up to ~5 levels (0.30 at the cell's own size)."""
    rc, result, _ = run_tiny(cell, seed=2 ** 31 + 5)
    assert rc == 0
    for name, bound in most.items():
        assert result["checks"][name]["value"] <= bound, (name, result)


def _half_batch(monkeypatch):
    from nerf_replication_tpu_torch.train.trainers import nerf

    loss_fn = nerf.NetworkWrapper.loss_fn

    def half(self, batch, generator=None, train=True):
        n = batch["rays_o"].shape[0] // 2
        return loss_fn(self, {k: v[:n] for k, v in batch.items()},
                       generator, train)

    monkeypatch.setattr(nerf.NetworkWrapper, "loss_fn", half)


def _unchanged_state(monkeypatch):
    from nerf_replication_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.ScheduledOptimizer, "step",
                        lambda self: None)


def _stale_batch(monkeypatch):
    """Every step of an epoch trains on the epoch's first batch (the
    generator still advances)."""
    from nerf_replication_tpu_torch.datasets.pipeline import (
        DeviceRayPipeline,
    )

    sample = DeviceRayPipeline.sample

    def stale(self, generator, step=1 << 30):
        batch = sample(self, generator, step)
        if getattr(self, "_stale_gen", None) is not generator:
            self._stale_gen, self._stale = generator, batch
        return self._stale

    monkeypatch.setattr(DeviceRayPipeline, "sample", stale)


def _crop_forever(monkeypatch):
    """The centre crop is never left: no whole-image draws."""
    from nerf_replication_tpu_torch.datasets.pipeline import (
        DeviceRayPipeline,
    )

    bounds = DeviceRayPipeline.bounds
    monkeypatch.setattr(DeviceRayPipeline, "bounds",
                        lambda self, step: bounds(self, 0))


def _altered_dense_answer(monkeypatch):
    from nerf_replication_tpu_torch.models.nerf.renderer import (
        volume_renderer,
    )

    render = volume_renderer.Renderer.render

    def altered(self, batch):
        rgb, depth = render(self, batch)
        rgb = rgb.clone()
        rgb[: rgb.shape[0] // 8] = 0.0
        return rgb, depth

    monkeypatch.setattr(volume_renderer.Renderer, "render", altered)


def _altered_view_answer(monkeypatch):
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer

    make = ngp_renderer.make_ngp_frame_renderer

    def altered(*args, **kwargs):
        fn = make(*args, **kwargs)

        def frame(pose):
            img, stats = fn(pose)
            img = img.clone()
            img[: img.shape[0] // 8] = 0
            return img, stats

        return frame

    monkeypatch.setattr(ngp_renderer, "make_ngp_frame_renderer", altered)


@pytest.mark.parametrize("cell,fault", [
    ("freq-train-tiny", _unchanged_state),
    ("freq-train-tiny", _half_batch),
    ("freq-train-tiny", _stale_batch),
    ("freq-train-tiny", _crop_forever),
    ("ngp-train-tiny", _unchanged_state),
    ("ngp-train-tiny", _half_batch),
    ("freq-dense-frame-tiny", _altered_dense_answer),
    ("ngp-view-tiny", _altered_view_answer),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(run_tiny, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    rc, result, err = run_tiny(cell)
    assert rc == 0
    assert result["correct"] is False, err
