"""Training recorder: window-20 smoothed scalars, images and a log.

The counterpart of nerf_replication_tpu/train/recorder.py: the same
``SmoothedValue`` (median and mean of the window, mean of all values),
``<prefix>/<name>`` tags, the loss stats, batch and data times and image
stats, step/epoch state for checkpoints, the log-dir wipe on a fresh run
(``resume`` False) and side effects on process 0 only. tensorboardX is
used where it is installed, else a JSONL writer
(``<record_dir>/events.jsonl``, which drops images).
"""

from __future__ import annotations

import json
import os
import shutil
from collections import deque

import numpy as np

from ..parallel.mesh import rank


class SmoothedValue:
    """Window-smoothed scalar (reference recorder.py:10-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class JsonlWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def add_image(self, tag, img, step, dataformats="HWC"):
        pass

    def close(self):
        self._f.close()


class Recorder:
    def __init__(self, cfg, process_index: int = 0):
        self.process_index = process_index
        self.log_dir = cfg.record_dir
        self.writer = None
        if process_index == 0:
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
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self.image_stats: dict = {}

    def update_loss_stats(self, loss_dict: dict):
        if self.process_index != 0:
            return
        for k, v in loss_dict.items():
            self.loss_stats.setdefault(k, SmoothedValue()).update(
                float(np.asarray(v).mean()))

    def update_image_stats(self, image_stats: dict):
        if self.process_index != 0:
            return
        self.image_stats.update(image_stats)

    def record(self, prefix: str, step: int = -1, loss_stats=None,
               image_stats=None):
        if self.writer is None:
            return
        step = step if step >= 0 else self.step
        stats = loss_stats if loss_stats is not None else self.loss_stats
        for k, v in stats.items():
            v = (v.median if isinstance(v, SmoothedValue)
                 else float(np.asarray(v).mean()))
            self.writer.add_scalar(f"{prefix}/{k}", v, step)
        images = image_stats if image_stats is not None else self.image_stats
        for k, v in (images or {}).items():
            self.add_image(f"{prefix}/{k}", v, step)
        self.image_stats = {}

    def add_image(self, tag: str, img, step: int):
        """One (H, W, C) image under ``tag``."""
        if self.writer is not None:
            self.writer.add_image(tag, np.asarray(img), step,
                                  dataformats="HWC")

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: dict):
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))

    def __str__(self):
        loss_state = "  ".join(
            f"{k}: {v.avg:.4f}" for k, v in self.loss_stats.items())
        return (f"epoch: {self.epoch}  step: {self.step}  {loss_state}  "
                f"batch: {self.batch_time.avg:.4f}  "
                f"data: {self.data_time.avg:.4f}")


def make_recorder(cfg, process_index: int | None = None) -> Recorder:
    """The Recorder of this process: ``process_index`` defaults to the rank
    in the process group (0 without one), so that only rank 0's
    ``record_dir`` comes into existence (JAX recorder.py:138-146)."""
    if process_index is None:
        process_index = rank()
    return Recorder(cfg, process_index)
