"""Datasets of the port: ``cfg.train_dataset_module`` and
``cfg.test_dataset_module`` resolve through the port's registry."""

from ..registry import resolve
from . import nerf  # noqa: F401 (registry side effect)
from .pipeline import DeviceRayPipeline


def make_train_dataset(cfg):
    """The config's train split."""
    kwargs = {**dict(cfg.train_dataset), "split": "train"}
    return resolve("dataset", cfg.train_dataset_module)(cfg, **kwargs)


def make_test_dataset(cfg):
    """The config's test split, iterable as batch dicts."""
    kwargs = {**dict(cfg.test_dataset), "split": "test"}
    return resolve("dataset", cfg.test_dataset_module)(cfg, **kwargs)


__all__ = ["DeviceRayPipeline", "make_test_dataset", "make_train_dataset"]
