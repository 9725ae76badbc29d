"""Host-side index samplers, the counterpart of
nerf_replication_tpu/datasets/samplers.py: plain-Python iterables over
indices and index batches, shuffled by numpy generators seeded as the JAX
package seeds them, so both packages draw the same streams.

* :class:`IterationBasedBatchSampler` makes an epoch exactly
  ``num_iterations`` batches (``ep_iter``), re-seeding the wrapped sampler
  through ``set_epoch`` each pass;
* :class:`DistributedSampler` shards an epoch-seeded permutation over
  ``num_replicas`` ranks, padded to equal shards (the caller passes the
  rank and the replica count);
* :class:`ImageSizeBatchSampler` draws a random (H, W), multiples of 32,
  per batch.
"""

from __future__ import annotations

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    """A permutation from ``default_rng(seed + epoch)``; without a seed,
    from ``default_rng(2 * epoch)``, as the JAX package draws it."""

    def __init__(self, n: int, seed: int | None = None):
        self.n = n
        self._epoch = 0
        self._seed = seed

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self):
        seed = self._seed if self._seed is not None else self._epoch
        g = np.random.default_rng(seed + self._epoch)
        return iter(g.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class DistributedSampler:
    """Rank ``rank``'s shard of an epoch-seeded permutation (or of
    0..n-1 without ``shuffle``), padded from its start to
    ``num_replicas * ceil(n / num_replicas)`` indices."""

    def __init__(self, n: int, num_replicas: int, rank: int,
                 shuffle: bool = True):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.num_samples = -(-n // num_replicas)
        self.total_size = self.num_samples * num_replicas
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self):
        if self.shuffle:
            indices = np.random.default_rng(self._epoch).permutation(
                self.n).tolist()
        else:
            indices = list(range(self.n))
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank: self.total_size: self.num_replicas])

    def __len__(self):
        return self.num_samples


class BatchSampler:
    def __init__(self, sampler, batch_size: int, drop_last: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))


class IterationBasedBatchSampler:
    """Exactly ``num_iterations`` batches, passing over the wrapped batch
    sampler as often as needed; each pass calls ``set_epoch(iteration)``
    on its sampler first."""

    def __init__(self, batch_sampler, num_iterations: int,
                 start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        while iteration < self.num_iterations:
            if hasattr(self.batch_sampler.sampler, "set_epoch"):
                self.batch_sampler.sampler.set_epoch(iteration)
            for batch in self.batch_sampler:
                yield batch
                iteration += 1
                if iteration >= self.num_iterations:
                    break

    def __len__(self):
        return self.num_iterations


class ImageSizeBatchSampler:
    """Batches of ``(idx, h, w)``: one (h, w) a batch from
    ``default_rng(seed)``, each rounded up past the next multiple of 32
    (``strategy`` ``origin``: -1, -1)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False,
                 sampler_meta=None, seed: int = 0):
        meta = sampler_meta or {}
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.strategy = meta.get("strategy", "range")
        self.hmin, self.wmin = meta.get("min_hw", [256, 256])
        self.hmax, self.wmax = meta.get("max_hw", [480, 640])
        self.divisor = 32
        self._rng = np.random.default_rng(seed)

    def _generate_height_width(self):
        if self.strategy == "origin":
            return -1, -1
        h = self._rng.integers(self.hmin, self.hmax + 1)
        w = self._rng.integers(self.wmin, self.wmax + 1)
        h = (h | (self.divisor - 1)) + 1
        w = (w | (self.divisor - 1)) + 1
        return int(h), int(w)

    def __iter__(self):
        batch = []
        h, w = self._generate_height_width()
        for idx in self.sampler:
            batch.append((idx, h, w))
            if len(batch) == self.batch_size:
                yield batch
                h, w = self._generate_height_width()
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))
