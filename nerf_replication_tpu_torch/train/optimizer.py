"""Optimizer: adam / radam / sgd with weight decay, the schedule, and the
element-wise gradient value clip ahead of each step.

The counterpart of nerf_replication_tpu/train/optimizer.py:19-45, which
composes ``optax.chain(optax.clip(40), optax.adam(schedule, eps))``. The
JAX package computes the update in XLA, not in a kernel, so ``torch.optim``
computes it here: Adam, decoupled AdamW for ``weight_decay`` > 0 (optax
``adamw``), RAdam and SGD with L2 weight decay added to the gradient
(optax ``add_decayed_weights`` before the update).

optax takes Adam's bias corrections ``1 - b**t`` in float32, from ``b``
rounded to float32 (``1 - 0.999`` comes out 1.3e-5 below 0.001), where
``torch.optim`` takes them in float64; so early updates in the JAX package
are ~6e-6 smaller. :func:`optax_bias_scale` scales the learning rate of each
Adam step to give optax's update.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scheduler import make_lr_schedule


def _bias_correction_f32(b: float, t: int) -> float:
    """optax's ``1 - b**t`` in float32, as XLA computes it (its float32
    ``pow`` is the correctly rounded power of the float32 ``b``)."""
    power = np.float32(float(np.float32(b)) ** t)
    return float(np.float32(1) - power)


def optax_bias_scale(betas, t: int) -> float:
    """The factor on the learning rate of torch's Adam step ``t`` (from 1)
    that makes it optax's: ``lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)``
    with float64 corrections becomes ``lr / bc1_f32 * m / (sqrt(v) /
    sqrt(bc2_f32) + eps')``, where eps' = eps * sqrt(bc2 / bc2_f32) is
    within 1e-5 of eps."""
    b1, b2 = betas
    return ((1 - b1 ** t) / _bias_correction_f32(b1, t)
            * math.sqrt(_bias_correction_f32(b2, t) / (1 - b2 ** t)))


class ScheduledOptimizer:
    """``torch.optim`` optimizer + step -> lr schedule + value clip. Its
    k-th :meth:`step` (``count`` k, from 0) clips every gradient to
    [-clip, clip], sets the learning rate to ``schedule(k)`` (for Adam
    times :func:`optax_bias_scale`) and updates."""

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
        adam = isinstance(self.optimizer,
                          (torch.optim.Adam, torch.optim.AdamW))
        for group in self.optimizer.param_groups:
            group["lr"] = (lr * optax_bias_scale(group["betas"],
                                                 self.count + 1)
                           if adam else lr)
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
