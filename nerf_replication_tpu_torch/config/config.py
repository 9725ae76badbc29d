"""Config defaults, YAML loading and CLI for the port.

The same YAML schema as nerf_replication_tpu/config/config.py: recursive
``parent_cfg`` inheritance, CLI ``opts`` overrides with an ``other_opts``
terminator, and the ``<base>/<task>/<scene>/<exp_name>`` output
directories. The defaults hold the keys the port reads; a YAML key
without a default is taken as it is.

Port-only keys: ``device`` (default ``cuda``) and ``pretrain_path`` (a
``data/pretrain/<name>`` directory to evaluate instead of
``trained_model_dir``). The training and host-loader keys (``train``,
``test``, ``distributed``, ``log_interval``, the cadence) and their
defaults are the JAX package's; ``train.num_workers`` is read by no code
(the loader reads in-process). So are the data-parallel keys: ``mesh.data``
(-1, the whole process group; any other value must equal the group's size,
``parallel.mesh.make_mesh``) and ``local_rank`` (``--local_rank``, else the
``LOCAL_RANK`` that ``torchrun`` sets, else 0).
"""

from __future__ import annotations

import argparse
import os

from .cfg_node import CN


def default_cfg() -> CN:
    c = CN()
    c.scene = "lego"
    c.task = "nerf-replication"
    c.exp_name = "nerf"
    c.save_tag = "default"
    c.save_result = True
    c.device = "cuda"
    c.pretrain_path = ""
    c.pretrain = ""
    c.resume = True
    c.seed = 0
    c.distributed = False
    c.mesh = CN({"data": -1})     # -1: every rank of the process group
    c.local_rank = 0

    # pluggable modules: registry names (see registry.py)
    c.train_dataset_module = "src.datasets.nerf.blender"
    c.test_dataset_module = "src.datasets.nerf.blender"
    c.network_module = "src.models.nerf.network"
    c.renderer_module = "src.models.nerf.renderer.volume_renderer"
    c.evaluator_module = "src.evaluators.nerf"
    c.loss_module = "src.train.trainers.nerf"

    c.task_arg = CN()

    # training (nerf_replication_tpu/config/config.py defaults)
    c.ep_iter = -1
    c.save_ep = 100000
    c.save_latest_ep = 1
    c.eval_ep = 1
    c.log_interval = 20
    c.train = CN()
    c.train.epoch = 10000
    c.train.num_workers = 8
    c.train.collator = "default"
    c.train.batch_sampler = "default"
    c.train.sampler_meta = CN()
    c.train.shuffle = True
    c.train.eps = 1e-8
    c.train.optim = "adam"
    c.train.lr = 5e-4
    c.train.weight_decay = 0.0
    c.train.scheduler = CN(
        {"type": "multi_step", "milestones": [80, 120, 200, 240], "gamma": 0.5})
    c.train.batch_size = 4
    c.train.clip_grad_value = 40.0

    # the host loader (datasets/make_dataset.py)
    c.test = CN()
    c.test.batch_size = 1
    c.test.collator = "default"
    c.test.epoch = -1
    c.test.batch_sampler = "default"
    c.test.sampler_meta = CN()

    c.trained_model_dir = "data/trained_model"
    c.record_dir = "data/record"
    c.result_dir = "data/result"

    c.network = CN()
    c.network.dtype = "bfloat16"
    return c


def parse_cfg(cfg: CN, args=None) -> None:
    """Post-merge output-directory derivation and ``local_rank``."""
    if not cfg.task:
        raise ValueError("task must be specified")
    sub = os.path.join(cfg.task, cfg.scene, cfg.exp_name)
    cfg.trained_model_dir = os.path.join(cfg.trained_model_dir, sub)
    cfg.record_dir = os.path.join(cfg.record_dir, sub)
    cfg.result_dir = os.path.join(cfg.result_dir, sub, cfg.save_tag)
    local_rank = getattr(args, "local_rank", None)
    cfg.local_rank = int(local_rank if local_rank is not None
                         else os.environ.get("LOCAL_RANK", 0))


def load_cfg_tree(cfg_file: str, base: CN) -> CN:
    """Merge ``cfg_file`` (with recursive ``parent_cfg``, a path relative
    to the working directory) into ``base``."""
    import yaml

    with open(cfg_file) as f:
        current = yaml.safe_load(f) or {}
    if "parent_cfg" in current:
        base = load_cfg_tree(current["parent_cfg"], base)
    base.merge_from_other(current)
    return base


def make_cfg(args) -> CN:
    cfg = default_cfg()
    if getattr(args, "type", ""):
        cfg.task = "run"
    cfg = load_cfg_tree(args.cfg_file, cfg)
    opts = list(getattr(args, "opts", []) or [])
    if "other_opts" in opts:
        opts = opts[: opts.index("other_opts")]
    cfg.merge_from_list(opts)
    parse_cfg(cfg, args)
    return cfg


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default="configs/nerf/hard.yaml", type=str)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--type", type=str, default="")
    parser.add_argument("--local_rank", type=int, default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def parse_args(argv=None):
    return make_parser().parse_args(argv)


def as_bool(value, key: str) -> bool:
    """A config flag as a strict boolean: bools, and the integers 0 and 1
    that the shipped YAML uses (``white_bkgd: 1``). Anything else raises;
    ``bool("false")`` would be True."""
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    raise TypeError(f"config key '{key}' must be a boolean, got {value!r}")
