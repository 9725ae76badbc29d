"""Datasets of the port: ``cfg.train_dataset_module`` and
``cfg.test_dataset_module`` resolve through the port's registry;
``make_data_loader`` is the host loader."""

from . import img_fit, latent, light_stage, nerf  # noqa: F401 (registry)
from .make_dataset import (
    DataLoader,
    make_data_loader,
    make_dataset,
    make_loader,
)
from .pipeline import DeviceRayPipeline


def make_train_dataset(cfg):
    """The config's train split."""
    return make_dataset(cfg, True, split="train")


def make_test_dataset(cfg):
    """The config's test split, iterable as batch dicts."""
    return make_dataset(cfg, False, split="test")


__all__ = ["DataLoader", "DeviceRayPipeline", "make_data_loader",
           "make_dataset", "make_loader", "make_test_dataset",
           "make_train_dataset"]
