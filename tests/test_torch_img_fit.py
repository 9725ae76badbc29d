"""Port parity for the img_fit task: the one-view dataset, ``ImgFitMLP``,
its MSE loss, the evaluator's float PSNR, 30 steps of the host-loader
``Trainer.train`` against the JAX package's, and the training CLI.

One 32x32 scene (the hard scene's first train view, written by the port's
``generate_scene``) serves every test; both packages read the same files
and draw pixels from the same numpy seeds. Tolerances: dataset batches bit
for bit; the network's output against Flax's on the same weights
(``params_from_jax``) within 1e-6 in float32; the loss within 1e-6
relative; the evaluator's PSNR within 1e-9 dB (both in float64); the 30
per-step losses of ``Trainer.train``, on the CPU in float32, within 1e-5
relative at every step, with dataset seeds 5, 6 and 7, and the JAX
package against itself with each batch's pixels permuted within 1e-6.
The port's Adam takes optax's float32 bias corrections
(``optimizer.optax_bias_scale``); with torch's float64 ones the seed-5
losses drift 1.02e-5 apart by step 16. With them the largest per-step
difference reads 2.8e-7, 1.6e-7 and 2.3e-7 at seeds 5, 6 and 7, and
the permuted JAX run 1.9e-7.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.datasets import make_data_loader as jax_loader
from nerf_replication_tpu.datasets.img_fit.synthetic import (
    Dataset as JaxDataset,
)
from nerf_replication_tpu.evaluators.img_fit import Evaluator as JaxEvaluator
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.train import make_trainer as jax_make_trainer
from nerf_replication_tpu.train.recorder import Recorder as JaxRecorder
from nerf_replication_tpu.train.trainers.img_fit import (
    NetworkWrapper as JaxWrapper,
)
from nerf_replication_tpu_torch import config
from nerf_replication_tpu_torch.datasets import make_data_loader
from nerf_replication_tpu_torch.datasets.img_fit.synthetic import Dataset
from nerf_replication_tpu_torch.evaluators import make_evaluator
from nerf_replication_tpu_torch.evaluators.img_fit import Evaluator
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.img_fit.network import ImgFitMLP
from nerf_replication_tpu_torch.registry import resolve
from nerf_replication_tpu_torch.train import make_recorder, make_trainer
from nerf_replication_tpu_torch.train.cli import main as train_main
from nerf_replication_tpu_torch.train.trainers.img_fit import NetworkWrapper
from nerf_replication_tpu_torch.utils import ckpt_utils
from nerf_replication_tpu_torch.utils import synthetic_scene as scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILE = "configs/img_fit/lego_view0.yaml"
SIZE = 32
STEPS = 30
FWD_ATOL = 1e-6
LOSS_RTOL = 1e-6
TRAJ_RTOL = 1e-5


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("img_fit")
    scene.generate_scene(str(root), "hard", H=SIZE, W=SIZE, n_train=1,
                         n_val=0, n_test=0)
    return str(root)


def _cfgs(scene_root, *opts, out=None, seed=5):
    """(port cfg, JAX cfg) of the img_fit config on the scene, float32."""
    out = out or scene_root
    argv = ["--cfg_file", os.path.join(ROOT, CFG_FILE), "scene", "hard",
            "network.dtype", "float32", "device", "cpu",
            "task_arg.N_pixels", "256", "ep_iter", str(STEPS),
            "train_dataset.data_root", scene_root,
            "test_dataset.data_root", scene_root,
            "trained_model_dir", os.path.join(out, "model"),
            "record_dir", os.path.join(out, "record"),
            "result_dir", os.path.join(out, "result"), *opts]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        ours = config.make_cfg(config.parse_args(argv))
        theirs = jax_config.make_cfg(jax_config.parse_args(
            [a for a in argv if a not in ("device", "cpu")]))
    finally:
        os.chdir(cwd)
    for cfg in (ours, theirs):
        cfg.train_dataset.seed = seed
    return ours, theirs


@pytest.fixture(scope="module")
def jax_init(scene_root):
    """The Flax init of the config's network (seed 0) and the port's
    ImgFitMLP carrying the same weights."""
    ours, theirs = _cfgs(scene_root)
    jnet = jax_make_network(theirs)
    sample = JaxDataset(theirs, **theirs.train_dataset)[0]
    params = jax.tree.map(np.asarray,
                          jnet.init(jax.random.key(0), sample))
    net = make_network(ours)
    net.load_state_dict(ckpt_utils.params_from_jax(params))
    return params, net


@pytest.mark.parametrize("split,ratio", [("train", 1.0), ("train", 0.5),
                                         ("test", 1.0), ("test", 0.5)])
def test_dataset_batches_are_bit_equal(scene_root, split, ratio):
    cfg = config.CN({"scene": "hard", "task_arg": {"N_pixels": 64}})
    jcfg = jax_config.CN({"scene": "hard", "task_arg": {"N_pixels": 64}})
    kw = dict(data_root=scene_root, split=split, view=0, input_ratio=ratio,
              seed=11)
    ours, theirs = Dataset(cfg, **kw), JaxDataset(jcfg, **kw)
    assert len(ours) == len(theirs) == 1
    for _ in range(3):                       # successive draws
        a, b = ours[0], theirs[0]
        for key in ("uv", "rgb"):
            assert a[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key])
        assert a["meta"] == b["meta"]
    side = int(SIZE * ratio)
    assert int(a["meta"]["H"]) == side and int(a["meta"]["W"]) == side


def test_registry_names_resolve():
    for kind, names in (
            ("dataset", ("src.datasets.img_fit.synthetic",
                         "nerf_replication_tpu.datasets.img_fit.synthetic")),
            ("network", ("src.models.img_fit.network",
                         "nerf_replication_tpu.models.img_fit.network")),
            ("loss", ("src.train.trainers.img_fit",
                      "src.train.losses.img_fit",
                      "nerf_replication_tpu.train.trainers.img_fit")),
            ("evaluator", ("src.evaluators.img_fit",
                           "nerf_replication_tpu.evaluators.img_fit"))):
        assert len({resolve(kind, n) for n in names}) == 1


def test_network_matches_flax(scene_root, jax_init):
    """Flax's init carried by params_from_jax: keys backbone.{i}, output;
    the forward on (batch, pixels, 2) uv within 1e-6."""
    params, net = jax_init
    assert sorted(net.state_dict()) == sorted(
        [f"backbone.{i}.{p}" for i in range(4) for p in ("weight", "bias")]
        + ["output.weight", "output.bias"])
    _, theirs = _cfgs(scene_root)
    uv = np.random.default_rng(3).uniform(0, 1, (2, 50, 2)).astype(
        np.float32)
    expect = jax_make_network(theirs).apply(params, {"uv": jnp.asarray(uv)})
    with torch.no_grad():
        out = net({"uv": torch.from_numpy(uv)})["rgb"]
    assert out.shape == (2, 50, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect["rgb"]),
                               atol=FWD_ATOL, rtol=0)


def test_network_init_is_flax_shaped(scene_root):
    """A fresh ImgFitMLP: Flax's shapes, zero biases, lecun-normal kernels
    (std 1/sqrt(fan_in) within 10%)."""
    ours, _ = _cfgs(scene_root)
    net = make_network(ours)
    assert isinstance(net, ImgFitMLP)
    assert net.backbone[0].weight.shape == (128, 42)
    for layer in [*net.backbone, net.output]:
        assert not layer.bias.any()
        std = float(layer.weight.detach().std()) * layer.in_features ** 0.5
        assert 0.9 < std < 1.1


def test_loss_matches_jax(scene_root, jax_init):
    params, net = jax_init
    ours, theirs = _cfgs(scene_root)
    batch = JaxDataset(theirs, **theirs.train_dataset)[0]
    jloss, (_, jstats, _) = JaxWrapper(jax_make_network(theirs),
                                       theirs).loss_fn(params, batch)
    loss, (out, stats, images) = NetworkWrapper(net, ours).loss_fn(
        {k: torch.from_numpy(v) for k, v in batch.items() if k != "meta"})
    assert images == {} and out["rgb"].shape == (256, 3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for key in ("loss", "color_mse", "psnr"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   rtol=LOSS_RTOL)


def test_evaluator_psnr_matches_jax(tmp_path):
    g = np.random.default_rng(4)
    gt = g.uniform(size=(1, 12 * 10, 3)).astype(np.float32)
    pred = np.clip(gt + g.normal(0, 0.03, gt.shape), 0, 1).astype(np.float32)
    batch = {"rgb": gt, "meta": {"H": np.array([12]), "W": np.array([10])}}
    cfg = config.CN({"result_dir": str(tmp_path / "ours")})
    jcfg = jax_config.CN({"result_dir": str(tmp_path / "theirs")})
    ours, theirs = Evaluator(cfg), JaxEvaluator(jcfg)
    a = ours.evaluate({"rgb": torch.from_numpy(pred)}, batch)["psnr"]
    b = theirs.evaluate({"rgb": pred}, batch)["psnr"]
    assert abs(a - b) < 1e-9
    assert ours.summarize() == pytest.approx(theirs.summarize(), abs=1e-9)
    for tag in ("ours", "theirs"):
        assert (tmp_path / tag / "vis" / "res.jpg").exists()
        with open(tmp_path / tag / "metrics.json") as f:
            assert json.load(f)["psnr"] == pytest.approx(a, abs=1e-9)


class _StepRecorder(JaxRecorder):
    """The JAX recorder, keeping every step's loss."""

    def update_loss_stats(self, loss_dict):
        self.losses.append(float(np.asarray(loss_dict["loss"])))
        super().update_loss_stats(loss_dict)


class _Permuted:
    """A loader whose batches hold their pixels in a seeded order: the
    same loss, summed in another order."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        g = np.random.default_rng(123)
        for batch in self.loader:
            order = g.permutation(batch["uv"].shape[1])
            yield {**batch, "uv": batch["uv"][:, order],
                   "rgb": batch["rgb"][:, order]}


def _jax_train(theirs, params, permute=False):
    """(trainer, recorder with the per-step losses, state) of one epoch
    of the JAX package's Trainer.train."""
    jtrainer = jax_make_trainer(theirs, jax_make_network(theirs))
    jrec = _StepRecorder(theirs)
    jrec.losses = []
    loader = jax_loader(theirs, True, max_iter=STEPS)
    state = jtrainer.init_state(jax.tree.map(jnp.asarray, params))
    state = jtrainer.train(0, _Permuted(loader) if permute else loader,
                           state, jrec)
    return jtrainer, jrec, state


def _port_train(ours, net):
    """(trainer, recorder, summary) of one epoch of the port's
    Trainer.train from ``net``'s weights."""
    port_net = make_network(ours)
    port_net.load_state_dict(net.state_dict())
    trainer = make_trainer(ours, port_net)
    recorder = make_recorder(ours)
    summary = trainer.train(0, make_data_loader(ours, True, max_iter=STEPS),
                            recorder)
    return trainer, recorder, summary


def test_train_loop_matches_jax_step_by_step(scene_root, jax_init,
                                             tmp_path):
    """30 steps of the port's Trainer.train over make_data_loader against
    30 of the JAX package's, from equal weights and the same dataset seed:
    every step's loss within 1e-5 relative; then both Trainer.val."""
    params, net = jax_init
    ours, theirs = _cfgs(scene_root, "log_interval", "7",
                         out=str(tmp_path))
    jtrainer, jrec, state = _jax_train(theirs, params)
    trainer, recorder, summary = _port_train(ours, net)
    assert summary["steps"] == STEPS == len(jrec.losses)
    assert trainer.step == recorder.step == STEPS
    expect = np.asarray(jrec.losses)
    np.testing.assert_allclose(summary["loss"], expect, rtol=TRAJ_RTOL)
    assert summary["rows"] == 256 and summary["data_time"].shape == (STEPS,)
    # the smoothed stats the log lines print
    assert recorder.loss_stats["loss"].avg == pytest.approx(
        jrec.loss_stats["loss"].avg, rel=TRAJ_RTOL)
    assert "batch:" in str(recorder) and "data:" in str(recorder)
    ev_ours = trainer.val(0, make_data_loader(ours, False),
                          make_evaluator(ours))
    ev_theirs = jtrainer.val(0, jax_loader(theirs, False), state,
                             JaxEvaluator(theirs))
    assert ev_ours["psnr"] == pytest.approx(ev_theirs["psnr"], abs=1e-3)


@pytest.mark.parametrize("seed", [6, 7])
def test_train_loop_matches_jax_at_other_dataset_seeds(scene_root, jax_init,
                                                       tmp_path, seed):
    """The 30-step comparison above with other pixel draws: every step's
    loss within 1e-5 relative."""
    params, net = jax_init
    ours, theirs = _cfgs(scene_root, out=str(tmp_path), seed=seed)
    _, jrec, _ = _jax_train(theirs, params)
    np.testing.assert_allclose(_port_train(ours, net)[2]["loss"],
                               np.asarray(jrec.losses), rtol=TRAJ_RTOL)


def test_jax_train_loop_drifts_less_under_a_permutation(scene_root,
                                                        jax_init, tmp_path):
    """The floor under the 1e-5 above: the JAX package against itself,
    each batch's pixels permuted (the same losses summed in another
    order), stays within 1e-6 relative at every step over the 30 steps."""
    params, _ = jax_init
    _, theirs = _cfgs(scene_root, out=str(tmp_path))
    plain = _jax_train(theirs, params)[1].losses
    permuted = _jax_train(theirs, params, permute=True)[1].losses
    np.testing.assert_allclose(permuted, plain, rtol=TRAJ_RTOL / 10)


def test_cli_trains_resumes_and_tests(scene_root, tmp_path, monkeypatch):
    """python -m nerf_replication_tpu_torch.train on the img_fit config:
    two epochs through the host loader save latest.ckpt, a resumed run
    continues the step count, --test reads back the PSNR the last eval
    wrote."""
    monkeypatch.chdir(ROOT)
    argv = ["--cfg_file", CFG_FILE, "scene", "hard", "device", "cpu",
            "task_arg.N_pixels", "256", "ep_iter", "10", "eval_ep", "1",
            "save_latest_ep", "1", "train_dataset.data_root", scene_root,
            "test_dataset.data_root", scene_root,
            "trained_model_dir", str(tmp_path / "model"),
            "record_dir", str(tmp_path / "record"),
            "result_dir", str(tmp_path / "result")]
    trainer = train_main(argv + ["train.epoch", "2", "resume", "False"])
    assert trainer.step == 20 and len(trainer.summaries) == 2
    model_dir = config.make_cfg(config.parse_args(argv)).trained_model_dir
    assert os.path.exists(os.path.join(model_dir, "latest.ckpt"))
    first, last = trainer.summaries
    assert last["loss"].mean() < first["loss"].mean()
    resumed = train_main(argv + ["train.epoch", "3"])
    assert resumed.step == 30 and [s["epoch"] for s in
                                   resumed.summaries] == [2]
    written = resumed.evals[-1]["psnr"]
    result = train_main(["--test"] + argv)
    assert result["psnr"] == pytest.approx(written, abs=1e-9)
    with open(os.path.join(config.make_cfg(config.parse_args(
            argv)).result_dir, "metrics.json")) as f:
        assert json.load(f)["psnr"] == pytest.approx(written, abs=1e-9)


def test_cli_needs_cuda_unless_told_cpu(scene_root, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the error where CUDA is absent")
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--cfg_file", CFG_FILE, "train_dataset.data_root",
                    scene_root])
