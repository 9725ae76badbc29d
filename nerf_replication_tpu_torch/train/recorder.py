"""Training recorder: window-20 smoothed scalars and a scalar log.

The counterpart of nerf_replication_tpu/train/recorder.py: the same
``SmoothedValue``, ``<prefix>/<name>`` tags, step/epoch state for
checkpoints and log-dir wipe on a fresh run (``resume`` False).
tensorboardX is used where it is installed, else a JSONL writer
(``<record_dir>/events.jsonl``).
"""

from __future__ import annotations

import json
import os
import shutil
from collections import deque

import numpy as np


class SmoothedValue:
    """Window-smoothed scalar (reference recorder.py:10-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)

    def update(self, value: float):
        self.deque.append(float(value))

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0


class JsonlWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class Recorder:
    def __init__(self, cfg):
        self.log_dir = cfg.record_dir
        if not cfg.get("resume", True) and os.path.exists(self.log_dir):
            print(f"remove contents of directory {self.log_dir}")
            shutil.rmtree(self.log_dir, ignore_errors=True)
        os.makedirs(self.log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(log_dir=self.log_dir)
        except ImportError:
            self.writer = JsonlWriter(self.log_dir)
        self.step = 0
        self.epoch = 0
        self.loss_stats: dict[str, SmoothedValue] = {}

    def update_loss_stats(self, loss_dict: dict):
        for k, v in loss_dict.items():
            self.loss_stats.setdefault(k, SmoothedValue()).update(float(v))

    def record(self, prefix: str, step: int = -1, loss_stats=None):
        step = step if step >= 0 else self.step
        stats = loss_stats if loss_stats is not None else self.loss_stats
        for k, v in stats.items():
            v = v.median if isinstance(v, SmoothedValue) else float(v)
            self.writer.add_scalar(f"{prefix}/{k}", v, step)

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: dict):
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))


def make_recorder(cfg) -> Recorder:
    return Recorder(cfg)
