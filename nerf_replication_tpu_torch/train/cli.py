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

Where the JAX package's train.py takes its host loader (:84-110), when
``task`` is ``img_fit`` or the train dataset has no ``as_arrays``, every
epoch runs ``Trainer.train`` over ``make_data_loader(cfg, is_train=True,
is_distributed=cfg.distributed, max_iter=cfg.ep_iter)`` instead, e.g.
``python -m nerf_replication_tpu_torch.train --cfg_file
configs/img_fit/lego_view0.yaml`` (a ``data_root`` holding the scene). The
val loader is ``make_data_loader(cfg, is_train=False)``.

The device is the config's ``device`` (``cuda`` unless ``device cpu``).
``network.use_pallas_mlp_train`` (default True) trains the 8x256 MLP
through the fused CUDA kernels, ``False`` through the ``nn.Module`` with
autograd. A brick hash-grid NGP network (``configs/nerf/hard_ngp.yaml``)
trains through its encoder's CUDA kernels and the f32 ``nn.Module`` MLP
whatever that flag says; ``task_arg.random_bkgd`` needs RGBA sources.

Data-parallel training, one process a device (JAX train.py:47-52)::

    torchrun --standalone --nproc_per_node=N \
        -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/hard.yaml

When the process group has more than one rank, each rank builds the mesh
(``parallel.mesh.make_mesh``: ``nccl`` when each rank has a card of its
own, ``gloo`` when ranks share one or run with ``device cpu``), puts the
network on its device and trains its share of every global batch with the
gradients averaged over the ranks (``Trainer``). Every rank reads the same
checkpoint on resume; only rank 0 writes checkpoints (then all wait at a
barrier), logs and records; every rank renders the val views sharded and
rank 0 evaluates them. With ``distributed True`` the host loader's sampler
gives each rank its own items (``num_replicas`` and ``rank`` from the
group).
"""

from __future__ import annotations

import os

import torch

from ..config import as_bool, make_cfg, parse_args
from ..datasets import (
    DeviceRayPipeline,
    make_data_loader,
    make_loader,
    make_train_dataset,
)
from ..evaluators import make_evaluator
from ..models import make_network
from ..run import load_model as load_eval_model
from ..run import make_run_mesh, resolve_device
from ..utils.ckpt_utils import (
    load_model,
    load_pretrain,
    params_from_jax,
    save_model,
)
from . import make_recorder, make_trainer


def make_pipeline(cfg, arrays, device) -> DeviceRayPipeline:
    """The device-resident sampler over ``arrays``: (images, poses, K),
    (images, poses, K, alphas) or (images, poses, K, alphas, times). The
    alphas go to the device only with ``task_arg.random_bkgd``, the one
    thing that reads them; a dynamic scene's times always."""
    ta = cfg.task_arg
    images, poses, K, *rest = arrays
    times = rest[1] if len(rest) > 1 else None
    random_bkgd = as_bool(ta.get("random_bkgd", False), "task_arg.random_bkgd")
    return DeviceRayPipeline(
        images, poses, K, n_rays=int(ta.get("N_rays", 1024)),
        precrop_iters=int(ta.get("precrop_iters", 0)),
        precrop_frac=float(ta.get("precrop_frac", 0.5)),
        sample_across_images=bool(ta.get("sample_across_images", False)),
        alphas=rest[0] if rest and random_bkgd else None, times=times,
        device=device)


def _pretrain_dir(name: str) -> str:
    return (name if os.path.isdir(name)
            else os.path.join("data", "trained_model", "pretrain", name))


def train(cfg, train_arrays=None, val_loader=None):
    """Train per the config; returns the Trainer. ``train_arrays``
    (images, poses, K and, for ``random_bkgd``, alphas) replace the
    config's split on the device-resident path, and ``val_loader``
    replaces the config's test loader."""
    mesh = make_run_mesh(cfg)
    device = resolve_device(cfg, mesh)
    network = make_network(cfg).to(device)
    trainer = make_trainer(cfg, network, mesh=mesh)
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

    # the host loader where the JAX package's train.py takes it
    host = dict(is_train=True,
                is_distributed=as_bool(cfg.distributed, "distributed"),
                max_iter=cfg.ep_iter,
                num_replicas=1 if mesh is None else mesh.size,
                rank=0 if mesh is None else mesh.rank)
    loader = None
    if train_arrays is None and cfg.task == "img_fit":
        loader = make_data_loader(cfg, **host)
    elif train_arrays is None:
        dataset = make_train_dataset(cfg)
        if hasattr(dataset, "as_arrays"):
            train_arrays = (*dataset.as_arrays(), dataset.alpha_arrays(),
                            dataset.time_arrays())
        else:
            loader = make_loader(cfg, dataset, **host)
    pipeline = (None if loader is not None
                else make_pipeline(cfg, train_arrays, device))
    for epoch in range(begin_epoch, int(cfg.train.epoch)):
        if pipeline is None:
            trainer.train(epoch, loader, recorder)
        else:
            trainer.train_device(epoch, pipeline, recorder)
        ckpt = (network, trainer.optimizer.state_dict(),
                {"step": trainer.step}, recorder.state_dict(), epoch,
                cfg.trained_model_dir)
        saves = [latest for latest, every in ((False, cfg.save_ep),
                                              (True, cfg.save_latest_ep))
                 if (epoch + 1) % every == 0]
        if saves and trainer.is_main:
            for latest in saves:
                save_model(*ckpt, latest=latest)
        if saves and mesh is not None:
            mesh.barrier()
        if (epoch + 1) % cfg.eval_ep == 0:
            if val_loader is None:
                val_loader = make_data_loader(cfg, is_train=False)
            trainer.val(epoch, val_loader, evaluator, recorder)
    return trainer


def test(cfg, val_loader=None) -> dict:
    """Evaluate the trained weights on the test split through
    ``Trainer.val`` (sharded over the ranks of a group)."""
    mesh = make_run_mesh(cfg)
    network = load_eval_model(cfg, resolve_device(cfg, mesh))
    trainer = make_trainer(cfg, network, mesh=mesh)
    loader = (make_data_loader(cfg, is_train=False) if val_loader is None
              else val_loader)
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
