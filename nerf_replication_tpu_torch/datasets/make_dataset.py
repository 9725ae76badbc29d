"""Dataset and host loader factory, the counterpart of
nerf_replication_tpu/datasets/make_dataset.py.

``make_data_loader(cfg, is_train, is_distributed, max_iter, num_replicas,
rank)`` builds a batch iterator from the config's dataset, a sampler
(sequential, shuffled, or rank-sharded when distributed), a batch sampler
(``default`` or ``image_size``), wrapped to exactly ``max_iter`` batches
an epoch unless ``max_iter`` is -1, and the config's collator. Batches are
dicts of numpy arrays on the host, read in this process (no worker
processes); ``Trainer.train`` moves them to the device. The NeRF training
path samples on the device instead (``datasets.pipeline``).
"""

from __future__ import annotations

from ..registry import resolve
from .collate import make_collator
from .samplers import (
    BatchSampler,
    DistributedSampler,
    ImageSizeBatchSampler,
    IterationBasedBatchSampler,
    RandomSampler,
    SequentialSampler,
)


def make_dataset(cfg, is_train: bool, **overrides):
    """The config's train (or test) dataset, built with its
    ``train_dataset`` (``test_dataset``) keys and ``overrides``."""
    ds_cfg = cfg.train_dataset if is_train else cfg.test_dataset
    module = cfg.train_dataset_module if is_train else cfg.test_dataset_module
    return resolve("dataset", module)(cfg, **{**dict(ds_cfg), **overrides})


def _make_sampler(dataset, shuffle: bool, is_distributed: bool,
                  num_replicas: int = 1, rank: int = 0):
    if is_distributed:
        return DistributedSampler(len(dataset), num_replicas, rank,
                                  shuffle=shuffle)
    if shuffle:
        return RandomSampler(len(dataset))
    return SequentialSampler(len(dataset))


def _make_batch_sampler(cfg, sampler, batch_size, drop_last, max_iter,
                        is_train):
    kind = cfg.train.batch_sampler if is_train else cfg.test.batch_sampler
    meta = cfg.train.sampler_meta if is_train else cfg.test.sampler_meta
    if kind == "image_size":
        bs = ImageSizeBatchSampler(sampler, batch_size, drop_last, meta)
    else:
        bs = BatchSampler(sampler, batch_size, drop_last)
    if max_iter != -1:
        bs = IterationBasedBatchSampler(bs, max_iter)
    return bs


class DataLoader:
    """Batch sampler -> ``dataset[i]`` for each index -> collate."""

    def __init__(self, dataset, batch_sampler, collate):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate

    def __iter__(self):
        for batch_idx in self.batch_sampler:
            # the image_size sampler yields (idx, h, w)
            yield self.collate([
                self.dataset[i[0] if isinstance(i, tuple) else i]
                for i in batch_idx])

    def __len__(self):
        return len(self.batch_sampler)


def make_data_loader(cfg, is_train: bool = True, is_distributed: bool = False,
                     max_iter: int = -1, num_replicas: int = 1,
                     rank: int = 0) -> DataLoader:
    return make_loader(cfg, make_dataset(cfg, is_train), is_train,
                       is_distributed, max_iter, num_replicas, rank)


def make_loader(cfg, dataset, is_train: bool = True,
                is_distributed: bool = False, max_iter: int = -1,
                num_replicas: int = 1, rank: int = 0) -> DataLoader:
    """:func:`make_data_loader` over a dataset built elsewhere."""
    if is_train:
        batch_size = cfg.train.batch_size
        shuffle = bool(cfg.train.shuffle)
    else:
        batch_size = cfg.test.batch_size
        shuffle = is_distributed
    sampler = _make_sampler(dataset, shuffle, is_distributed, num_replicas,
                            rank)
    batch_sampler = _make_batch_sampler(cfg, sampler, batch_size, False,
                                        max_iter, is_train)
    return DataLoader(dataset, batch_sampler, make_collator(cfg, is_train))
