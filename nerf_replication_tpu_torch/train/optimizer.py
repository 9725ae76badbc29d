"""Optimizer: adam / radam / sgd with weight decay, the schedule, and the
element-wise gradient value clip ahead of each step.

The counterpart of nerf_replication_tpu/train/optimizer.py:19-45, which
composes ``optax.chain(optax.clip(40), optax.adam(schedule, eps))``. The
JAX package computes the update in XLA, not in a kernel, so ``torch.optim``
computes it here: Adam, decoupled AdamW for ``weight_decay`` > 0 (optax
``adamw``), RAdam and SGD with L2 weight decay added to the gradient
(optax ``add_decayed_weights`` before the update).
"""

from __future__ import annotations

import torch

from .scheduler import make_lr_schedule


class ScheduledOptimizer:
    """``torch.optim`` optimizer + step -> lr schedule + value clip. Its
    k-th :meth:`step` (``count`` k, from 0) clips every gradient to
    [-clip, clip], sets the learning rate to ``schedule(k)`` and updates."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule,
                 clip: float):
        self.optimizer, self.schedule, self.clip = optimizer, schedule, clip
        self.count = 0

    @property
    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        if self.clip > 0:
            torch.nn.utils.clip_grad_value_(self.params, self.clip)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def lr(self) -> float:
        """The learning rate of the last update."""
        return self.schedule(max(self.count - 1, 0))

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_optimizer(cfg, params, lr_schedule=None) -> ScheduledOptimizer:
    tc = cfg.train
    if lr_schedule is None:
        lr_schedule = make_lr_schedule(cfg)
    params = list(params)
    wd = float(tc.get("weight_decay", 0.0))
    eps = float(tc.get("eps", 1e-8))
    kind = tc.get("optim", "adam")
    lr0 = lr_schedule(0)
    if kind == "adam":
        opt = (torch.optim.AdamW(params, lr=lr0, eps=eps, weight_decay=wd)
               if wd > 0 else torch.optim.Adam(params, lr=lr0, eps=eps))
    elif kind == "radam":
        opt = torch.optim.RAdam(params, lr=lr0, eps=eps, weight_decay=wd)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr0,
                              momentum=float(tc.get("momentum", 0.9)),
                              weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer: {kind!r}")
    return ScheduledOptimizer(opt, lr_schedule,
                              float(tc.get("clip_grad_value", 40.0)))
