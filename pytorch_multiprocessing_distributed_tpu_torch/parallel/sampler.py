"""Deterministic per-rank dataset sharding (the port of the JAX package's
``parallel/sampler.py``).

The semantics of ``torch.utils.data.distributed.DistributedSampler`` as
the reference uses it on both splits: an epoch permutation from
``torch.randperm`` with a generator seeded ``seed + epoch``, wraparound
padding so every rank gets ``ceil(N / world)`` samples, and rank ``r``
taking the strided slice ``indices[r::world]``. The JAX package draws
the same ``torch.randperm``, so the two give index-identical shards.
:meth:`DistributedShardSampler.valid_mask` marks the padding duplicates,
which the eval step leaves out of its sums.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np
import torch


def padded_epoch_indices(dataset_size: int, num_replicas: int, *,
                         shuffle: bool = True, seed: int = 0,
                         epoch: int = 0, drop_last: bool = False
                         ) -> List[int]:
    """The epoch's padded (or truncated) index list shared by all
    ranks; rank ``r``'s shard is the strided slice ``[r::world]``."""
    if shuffle:
        g = torch.Generator()
        g.manual_seed(seed + epoch)
        indices = torch.randperm(dataset_size, generator=g).tolist()
    else:
        indices = list(range(dataset_size))

    if drop_last and dataset_size % num_replicas:
        num_samples = dataset_size // num_replicas
    else:
        num_samples = math.ceil(dataset_size / num_replicas)
    total_size = num_samples * num_replicas

    if not drop_last:
        padding = total_size - len(indices)
        if padding > 0:
            if padding <= len(indices):
                indices += indices[:padding]
            else:  # tiny dataset: repeat the whole list (torch semantics)
                reps = math.ceil(padding / len(indices))
                indices += (indices * reps)[:padding]
    else:
        indices = indices[:total_size]
    if len(indices) != total_size:
        raise AssertionError(f"{len(indices)} indices, want {total_size}")
    return indices


class DistributedShardSampler:
    """Index sampler for one rank of a sharded dataset.

    Args:
      dataset_size: total number of samples.
      rank: this rank's index.
      num_replicas: the number of ranks (the reference's ``world_size``).
      shuffle: epoch-seeded shuffle (the reference shuffles both splits).
      seed: base seed (torch's default 0).
      drop_last: drop the tail instead of padding (torch semantics).
    """

    def __init__(self, dataset_size: int, rank: int, num_replicas: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = math.ceil(dataset_size / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch (torch's ``set_epoch``)."""
        self.epoch = epoch

    def indices(self) -> List[int]:
        """This rank's index list for the current epoch."""
        padded = padded_epoch_indices(
            self.dataset_size, self.num_replicas, shuffle=self.shuffle,
            seed=self.seed, epoch=self.epoch, drop_last=self.drop_last)
        return padded[self.rank:self.total_size:self.num_replicas]

    def valid_mask(self) -> np.ndarray:
        """True where the shard position holds a real sample, False where
        it holds a wraparound-padding duplicate (flat positions ``>=
        dataset_size``; shard ``r`` holds positions ``r, r + world,
        ...``)."""
        positions = self.rank + self.num_replicas * np.arange(
            self.num_samples)
        return positions < self.dataset_size

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
