"""Training / test CLI of the port, the counterpart of the root train.py:

    python -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/hard.yaml
    python -m nerf_replication_tpu_torch.train --test --cfg_file ...

Fresh init from ``seed`` (``models.nerf.network.make_network``), or the
weights of ``pretrain`` (a directory holding ``pretrain.ckpt``), or, with
``resume`` (default True), the newest checkpoint under
``trained_model_dir`` with its optimizer state and epoch; ``resume False``
wipes that directory. Every epoch runs ``ep_iter`` steps on the
device-resident split (``Trainer.train_device``); checkpoints are saved
every ``save_ep`` epochs and as ``latest.ckpt`` every ``save_latest_ep``,
and the test split is evaluated every ``eval_ep``. ``--test`` evaluates
the checkpoint (or ``pretrain_path``) through ``Trainer.val``.

The device is the config's ``device`` (``cuda`` unless ``device cpu``).
``network.use_pallas_mlp_train`` (default True) trains the 8x256 MLP
through the fused CUDA kernels, ``False`` through the ``nn.Module`` with
autograd. A brick hash-grid NGP network (``configs/nerf/hard_ngp.yaml``)
trains through its encoder's CUDA kernels and the f32 ``nn.Module`` MLP
whatever that flag says; ``task_arg.random_bkgd`` needs RGBA sources.
"""

from __future__ import annotations

import os

import torch

from ..config import as_bool, make_cfg, parse_args
from ..datasets import DeviceRayPipeline, make_test_dataset, make_train_dataset
from ..evaluators import make_evaluator
from ..models import make_network
from ..run import load_model as load_eval_model
from ..run import resolve_device
from ..utils.ckpt_utils import (
    load_model,
    load_pretrain,
    params_from_jax,
    save_model,
)
from . import make_recorder, make_trainer


def make_pipeline(cfg, arrays, device) -> DeviceRayPipeline:
    """The device-resident sampler over ``arrays``: (images, poses, K) or
    (images, poses, K, alphas). The alphas go to the device only with
    ``task_arg.random_bkgd``, the one thing that reads them."""
    ta = cfg.task_arg
    images, poses, K, *rest = arrays
    random_bkgd = as_bool(ta.get("random_bkgd", False), "task_arg.random_bkgd")
    return DeviceRayPipeline(
        images, poses, K, n_rays=int(ta.get("N_rays", 1024)),
        precrop_iters=int(ta.get("precrop_iters", 0)),
        precrop_frac=float(ta.get("precrop_frac", 0.5)),
        sample_across_images=bool(ta.get("sample_across_images", False)),
        alphas=rest[0] if rest and random_bkgd else None, device=device)


def _pretrain_dir(name: str) -> str:
    return (name if os.path.isdir(name)
            else os.path.join("data", "trained_model", "pretrain", name))


def train(cfg, train_arrays=None, val_loader=None):
    """Train per the config; returns the Trainer. ``train_arrays``
    (images, poses, K and, for ``random_bkgd``, alphas) and ``val_loader``
    replace the config's splits."""
    device = resolve_device(cfg)
    network = make_network(cfg).to(device)
    trainer = make_trainer(cfg, network)
    recorder = make_recorder(cfg)
    evaluator = make_evaluator(cfg)

    begin_epoch = 0
    payload = load_model(cfg.trained_model_dir, resume=cfg.resume)
    if payload is not None:
        network.load_state_dict(params_from_jax(payload["net"]))
        trainer.optimizer.load_state_dict(payload["optim"])
        recorder.load_state_dict(payload["recorder"])
        begin_epoch = payload["epoch"] + 1
    elif cfg.pretrain:
        network.load_state_dict(params_from_jax(
            load_pretrain(_pretrain_dir(cfg.pretrain))))

    if train_arrays is None:
        dataset = make_train_dataset(cfg)
        train_arrays = (*dataset.as_arrays(), dataset.alpha_arrays())
    pipeline = make_pipeline(cfg, train_arrays, device)
    for epoch in range(begin_epoch, int(cfg.train.epoch)):
        trainer.train_device(epoch, pipeline, recorder)
        ckpt = (network, trainer.optimizer.state_dict(),
                {"step": trainer.step}, recorder.state_dict(), epoch,
                cfg.trained_model_dir)
        if (epoch + 1) % cfg.save_ep == 0:
            save_model(*ckpt)
        if (epoch + 1) % cfg.save_latest_ep == 0:
            save_model(*ckpt, latest=True)
        if (epoch + 1) % cfg.eval_ep == 0:
            loader = make_test_dataset(cfg) if val_loader is None \
                else val_loader
            trainer.val(epoch, loader, evaluator, recorder)
    return trainer


def test(cfg, val_loader=None) -> dict:
    """Evaluate the trained weights on the test split through
    ``Trainer.val``."""
    network = load_eval_model(cfg, resolve_device(cfg))
    trainer = make_trainer(cfg, network)
    loader = make_test_dataset(cfg) if val_loader is None else val_loader
    return trainer.val(-1, loader, make_evaluator(cfg))


def main(argv=None):
    # ray geometry and the nn.Module MLP's f32 products stay in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = parse_args(argv)
    cfg = make_cfg(args)
    if args.test:
        return test(cfg)
    return train(cfg)
