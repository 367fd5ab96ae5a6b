"""Duration-bucketed batch samplers (the JAX package's ``data/sampler.py``).

The manifest is already duration-sorted, so chunking consecutive indices
into fixed-size bins batches similar lengths together (reference
data_loader_aug.py:560-579). SortaGrad = no shuffle on epoch 0 (reference
train.py:89-94, 669-671) is the caller's choice to skip ``shuffle(epoch)``.

``DistributedBucketingSampler`` shards the bins over data-parallel
replicas: replica r takes every Nth bin after padding to a replica
multiple, with an epoch-seeded shuffle that every replica derives alike
(reference data_loader_aug.py:582-617). Its replica index is the rank's
data index (``parallel.Mesh.data_index``): the model ranks of one data
shard read the same bins.
"""

from __future__ import annotations

import numpy as np


class BucketingSampler:
    """Fixed-size bins of consecutive indices; within-bin shuffle at
    iteration, across-bin shuffle per epoch."""

    def __init__(self, data_source_len: int, batch_size: int = 1,
                 drop_last: bool = False):
        ids = list(range(data_source_len))
        self.bins = [ids[i:i + batch_size]
                     for i in range(0, len(ids), batch_size)]
        if drop_last and self.bins and len(self.bins[-1]) < batch_size:
            self.bins.pop()
        self._rng = np.random.default_rng(0)

    def __iter__(self):
        for ids in self.bins:
            ids = list(ids)
            self._rng.shuffle(ids)
            yield ids

    def __len__(self):
        return len(self.bins)

    def shuffle(self, epoch: int):
        self._rng = np.random.default_rng(epoch)
        self._rng.shuffle(self.bins)

    def reverse(self):
        """Longest-first bins (reference --reverse-sort, train.py:93-94)."""
        self.bins = list(reversed(self.bins))


class DistributedBucketingSampler:
    """Rank-strided bins, padded to a replica multiple
    (reference data_loader_aug.py:582-617)."""

    def __init__(self, data_source_len: int, batch_size: int = 1,
                 num_replicas: int = 1, rank: int = 0):
        ids = list(range(data_source_len))
        self.bins = [ids[i:i + batch_size]
                     for i in range(0, len(ids), batch_size)]
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = -(-len(self.bins) // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        bins = self.bins + self.bins[: self.total_size - len(self.bins)]
        return iter(bins[self.rank::self.num_replicas])

    def __len__(self):
        return self.num_samples

    def shuffle(self, epoch: int):
        # epoch-seeded so every replica derives the same permutation
        perm = np.random.default_rng(epoch).permutation(len(self.bins))
        self.bins = [self.bins[i] for i in perm]

    def reverse(self):
        """Longest-first bins (reference --reverse-sort, train.py:93-94)."""
        self.bins = list(reversed(self.bins))
