"""The measured program, reached through its public entry points only:
its config loader, network factory, trainer, device ray pipeline,
renderer and frame renderers. Imported when a run starts, never when
this module is."""

from __future__ import annotations

import torch


def cfg(config: dict, device: torch.device, seed: int | None = None,
        checkpoint: bool = False):
    """The port's config for a configuration file's ``port`` section:
    its YAML, its overrides, the device, and the seed or the checkpoint
    (``pretrain_path``)."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args

    p = config["port"]
    argv = ["--cfg_file", p["cfg_file"], *p.get("overrides", []),
            "device", device.type, "save_result", "False"]
    if seed is not None:
        argv += ["seed", str(int(seed))]
    if checkpoint:
        argv = ["--type", "evaluate", *argv, "pretrain_path",
                p["checkpoint"]]
    return make_cfg(parse_args(argv))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
