"""Batch collation, the counterpart of
nerf_replication_tpu/datasets/collate.py: a table of task collators
(``train.collator`` / ``test.collator``), falling back to stacking."""

from __future__ import annotations

from typing import Callable

import numpy as np

_collators: dict[str, Callable] = {}


def default_collate(samples: list):
    """Stack a list of samples into one batch of numpy arrays, recursing
    into dicts, lists and tuples."""
    if not samples:
        return {}
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate(list(x)) for x in zip(*samples))
    return np.stack([np.asarray(s) for s in samples])


def make_collator(cfg, is_train: bool) -> Callable:
    name = cfg.train.collator if is_train else cfg.test.collator
    return _collators.get(name, default_collate)
