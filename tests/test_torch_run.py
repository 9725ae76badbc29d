"""The port's entry points: JAX-free imports, the evaluate path on the
CPU, and the refusal to run without CUDA where CUDA is the default."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from nerf_replication_tpu_torch import run
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = [
    "nerf_replication_tpu_torch.run",
    "nerf_replication_tpu_torch.registry",
    "nerf_replication_tpu_torch.config",
    "nerf_replication_tpu_torch.utils.ckpt_utils",
    "nerf_replication_tpu_torch.utils.synthetic_scene",
    "nerf_replication_tpu_torch.models.encoding",
    "nerf_replication_tpu_torch.models.encoding.hashgrid",
    "nerf_replication_tpu_torch.models.encoding.triplane",
    "nerf_replication_tpu_torch.models.encoding.dnerf",
    "nerf_replication_tpu_torch.models.nerf.network",
    "nerf_replication_tpu_torch.models.nerf.renderer.volume_renderer",
    "nerf_replication_tpu_torch.ops.ray_ops",
    "nerf_replication_tpu_torch.ops.occupancy",
    "nerf_replication_tpu_torch.models.nerf.renderer.ngp_renderer",
    "nerf_replication_tpu_torch.raymarch_bench",
    "nerf_replication_tpu_torch.ops.mlp_kernel",
    "nerf_replication_tpu_torch.ops._build",
    "nerf_replication_tpu_torch.datasets.nerf.blender",
    "nerf_replication_tpu_torch.evaluators.nerf",
    "nerf_replication_tpu_torch.evaluators.img_fit",
    "nerf_replication_tpu_torch.datasets",
    "nerf_replication_tpu_torch.datasets.make_dataset",
    "nerf_replication_tpu_torch.datasets.samplers",
    "nerf_replication_tpu_torch.datasets.collate",
    "nerf_replication_tpu_torch.datasets.dataset_catalog",
    "nerf_replication_tpu_torch.datasets.latent",
    "nerf_replication_tpu_torch.datasets.light_stage",
    "nerf_replication_tpu_torch.datasets.img_fit.synthetic",
    "nerf_replication_tpu_torch.models.img_fit.network",
    "nerf_replication_tpu_torch.train.trainers.img_fit",
    "nerf_replication_tpu_torch.train.cli",
    "nerf_replication_tpu_torch.train.trainers.trainer",
    "nerf_replication_tpu_torch.train.trainers.nerf",
    "nerf_replication_tpu_torch.train.recorder",
    "nerf_replication_tpu_torch.datasets.pipeline",
    "nerf_replication_tpu_torch.parallel",
    "nerf_replication_tpu_torch.parallel.mesh",
    "nerf_replication_tpu_torch.parallel.dryrun",
    "chip_smoke",
]


def _python(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_slice_imports_neither_jax_nor_the_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nerf_replication_tpu'))\n"
            "assert not bad, bad\n")
    proc = _python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr


def test_run_evaluate_on_cpu(monkeypatch):
    """The evaluate path end to end at 16x16 with the trained weights;
    on the CPU the fused MLP's wrapper takes its plain version."""
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args([
        "--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
        "pretrain_path", "data/pretrain/hard", "device", "cpu",
        "save_result", "False"]))
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    launches = tracing.counts["fused_nerf_mlp_enc.launches"]
    calls = tracing.counts["fused_nerf_mlp_enc_reference.calls"]
    res = run.run_evaluate(cfg, loader=views)
    assert tracing.counts["fused_nerf_mlp_enc.launches"] == launches
    assert tracing.counts["fused_nerf_mlp_enc_reference.calls"] == calls + 2
    assert res["rgb"][0].shape == (256, 3) and len(res["net_time"]) == 1
    assert res["psnr"] > 28.0 and 0.9 < res["ssim"] <= 1.0


@pytest.mark.parametrize("run_type", ["evaluate", "network"])
def test_cli_on_a_scene_directory(run_type, tmp_path, monkeypatch, capsys):
    """The CLI with the config's own test split: a 12x12 hard scene in
    the NeRF-synthetic layout (written by the JAX package's
    generate_scene, with the port's ground truth for speed)."""
    from nerf_replication_tpu.utils import synthetic_scene as jax_scene

    monkeypatch.setattr(jax_scene, "render_gt", synthetic_scene.render_gt)
    jax_scene.generate_scene(str(tmp_path), "hard", H=12, W=12, n_train=0,
                             n_val=0, n_test=2)
    monkeypatch.chdir(ROOT)
    run.main(["--type", run_type, "--cfg_file", "configs/nerf/hard.yaml",
              "pretrain_path", "data/pretrain/hard", "device", "cpu",
              "test_dataset.data_root", str(tmp_path), "test_dataset.H",
              "12", "test_dataset.W", "12", "result_dir",
              str(tmp_path / "result")])
    out = capsys.readouterr().out
    assert "fused CUDA MLP: True" in out
    pngs = list((tmp_path / "result").rglob("*.png"))
    if run_type == "evaluate":
        assert "'psnr'" in out and "fps:" in out
        assert len(pngs) == 4  # pred + gt for 2 views
    else:
        assert out.count("psnr") == 2 and len(pngs) == 2


def test_cli_refuses_unported_types():
    with pytest.raises(SystemExit, match="not ported"):
        run.main(["--type", "mesh", "--cfg_file", "configs/nerf/hard.yaml"])


def test_cli_raises_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the error where CUDA is absent")
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--type", "evaluate", "--cfg_file",
                  "configs/nerf/hard.yaml", "pretrain_path",
                  "data/pretrain/hard"])


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(where, tmp_path):
    """No result line and a non-zero exit without CUDA, and in a
    directory holding chip_smoke.py and nothing else of the repo."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("checks the exit where CUDA is absent")
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _python(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
