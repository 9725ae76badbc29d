"""Learning-rate schedules as step -> lr functions.

The counterpart of nerf_replication_tpu/train/scheduler.py:20-63:
``exponential`` (gamma^(epoch / decay_epochs)), ``multi_step`` and
``warmup_multi_step``, with epoch = step // ep_iter (or step / ep_iter with
``smooth``). The optimizer's k-th update, counted from 0, uses
``schedule(k)``, as optax does.
"""

from __future__ import annotations

import bisect


def make_lr_schedule(cfg):
    tc = cfg.train
    base_lr = float(tc.lr)
    sc = tc.scheduler
    kind = sc.get("type", "multi_step")
    ep_iter = max(int(cfg.get("ep_iter", -1)), 1)

    if kind == "exponential":
        gamma = float(sc.get("gamma", 0.1))
        decay_epochs = float(sc.get("decay_epochs", 500))
        smooth = bool(sc.get("smooth", False))

        def schedule(step: int) -> float:
            epoch = step / ep_iter if smooth else step // ep_iter
            return base_lr * gamma ** (epoch / decay_epochs)

        return schedule

    milestones = sorted(int(m) for m in sc.get("milestones",
                                               [80, 120, 200, 240]))
    gamma = float(sc.get("gamma", 0.5))

    def decay(epoch: int) -> float:
        # gamma ^ (number of milestones <= epoch)
        return gamma ** bisect.bisect_right(milestones, epoch)

    if kind == "multi_step":
        return lambda step: base_lr * decay(step // ep_iter)

    if kind == "warmup_multi_step":
        warmup_epochs = int(sc.get("warmup_epochs", sc.get("warmup_iters", 5)))
        warmup_factor = float(sc.get("warmup_factor", 1.0 / 3))

        def schedule(step: int) -> float:
            epoch = step // ep_iter
            alpha = min(max(epoch / max(warmup_epochs, 1), 0.0), 1.0)
            wf = (1.0 if epoch >= warmup_epochs
                  else warmup_factor * (1 - alpha) + alpha)
            return base_lr * wf * decay(epoch)

        return schedule

    raise ValueError(f"unknown scheduler type: {kind!r}")
