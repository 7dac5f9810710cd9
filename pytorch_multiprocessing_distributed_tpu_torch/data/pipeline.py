"""Per-rank sharded image batches with a one-ahead device copy (the port
of the JAX package's ``data/pipeline.py``: the CIFAR route here, the
ImageNet route through :mod:`.imagenet`).

The reference's loader stack is a ``DistributedSampler`` per rank and a
``DataLoader(batch_size // world_size, pin_memory=True)``.
:class:`ShardedLoader` draws the epoch permutation once, slices the
shards of the ranks it assembles (in the port: one process per rank, so
``replica_ids=[rank]``) and applies the augmentations with one random
stream per (seed, epoch, rank), as the JAX loader does — the same rank
gets the same images and augmentations in both packages.
:func:`prefetch` replaces the JAX ``prefetch_to_device``: each host
batch goes to pinned memory and is copied ``non_blocking`` one batch
ahead, so the copy of step k+1 overlaps the compute of step k.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.dist import get_rank
from ..parallel.sampler import DistributedShardSampler, padded_epoch_indices
from ..train.lm import to_device
from .cifar import load_cifar10, synthetic_cifar10
from .transforms import normalize, random_crop_flip


# the shuffle and augmentation seed: torch DistributedSampler's default,
# which the reference (and the JAX loader) leave as it is; both splits
# shuffle, as in the reference
SEED = 0


class ShardedLoader:
    """Epoch batches for the given ranks of a data-parallel group.

    Args:
      images, labels: the whole split (uint8 NHWC, int labels).
      batch_size: the GLOBAL batch; each rank takes
        ``batch_size // world_size`` rows (the reference's split).
      world_size: the number of ranks.
      replica_ids: the ranks this loader assembles, in order (default
        all of them).
      train: random crop and flip.
      with_valid: also yield the bool mask of real (not padding) rows.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 batch_size: int, world_size: int,
                 replica_ids: Optional[Sequence[int]] = None,
                 train: bool = True, with_valid: bool = False):
        if batch_size % world_size:
            raise ValueError(
                f"global batch {batch_size} not divisible by world "
                f"{world_size}")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.per_replica = batch_size // world_size
        self.world_size = world_size
        self.replica_ids = (list(range(world_size)) if replica_ids is None
                            else list(replica_ids))
        self.train = train
        self.with_valid = with_valid
        self.samplers = [
            DistributedShardSampler(len(images), r, world_size,
                                    seed=SEED)
            for r in self.replica_ids]
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        for s in self.samplers:
            s.set_epoch(epoch)

    def __len__(self) -> int:
        # torch's DataLoader keeps a ragged last batch (drop_last=False);
        # the sampler has padded the shards to equal length
        return -(-self.samplers[0].num_samples // self.per_replica)

    @property
    def dataset_size(self) -> int:
        return len(self.images)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """``(images f32 NHWC, labels int32[, valid bool])`` host batches
        of ``len(replica_ids) * per_replica`` rows in rank order."""
        padded = np.asarray(padded_epoch_indices(
            len(self.images), self.world_size, seed=SEED, epoch=self._epoch))
        shards = [padded[r::self.world_size] for r in self.replica_ids]
        valids = [s.valid_mask() for s in self.samplers]
        # one augmentation stream per rank, seeded by (seed, epoch, rank):
        # a rank draws the same augmentations whoever assembles it
        aug_rngs = [np.random.default_rng(
            np.random.SeedSequence([SEED, self._epoch, int(r)]))
            for r in self.replica_ids]
        for b in range(len(self)):
            lo, hi = b * self.per_replica, (b + 1) * self.per_replica
            idx = np.concatenate([np.asarray(s[lo:hi]) for s in shards])
            imgs = self.images[idx]
            if self.train:
                imgs = np.concatenate([
                    random_crop_flip(part, rng) for part, rng in zip(
                        np.array_split(imgs, len(aug_rngs)), aug_rngs)])
            out = (normalize(imgs), self.labels[idx].astype(np.int32))
            if self.with_valid:
                out = out + (np.concatenate([v[lo:hi] for v in valids]),)
            yield out


def prefetch(loader, device: torch.device) -> Iterator[Tuple[torch.Tensor,
                                                              ...]]:
    """Yield ``loader``'s batches as tensors on ``device``; on a card the
    pinned, non-blocking copy of the next batch is issued before the
    current one is handed out (plain tensors on the CPU)."""
    def put(batch):
        return None if batch is None else tuple(to_device(x, device)
                                                for x in batch)

    it = iter(loader)
    pending = put(next(it, None))
    while pending is not None:
        current, pending = pending, put(next(it, None))
        yield current


def synthetic_sizes() -> Tuple[int, int]:
    """(train, test) sizes of the synthetic set: 50000/10000, or under
    ``PMDT_SMALL_SYNTH=N`` (an integer > 1) N and N // 4, and 2048/512
    for any other value (the JAX ``get_loader``'s rule)."""
    small = os.environ.get("PMDT_SMALL_SYNTH")
    if not small:
        return 50000, 10000
    try:
        n = int(small)
    except ValueError:
        n = 1
    return (n, max(1, n // 4)) if n > 1 else (2048, 512)


def imagenet_synthetic_sizes() -> Tuple[int, int]:
    """(train, test) nominal sizes of the synthetic ImageNet set:
    1,281,167/50,000, or 1024/256 under any ``PMDT_SMALL_SYNTH`` (the
    JAX ``get_loader``'s rule for ImageNet, not CIFAR's)."""
    if os.environ.get("PMDT_SMALL_SYNTH"):
        return 1024, 256
    return 1_281_167, 50_000


def _imagenet_loaders(args, world_size: int, rank: int):
    """The ImageNet route: :class:`.imagenet.IndexedLoader` over the
    on-demand synthetic set (``--synthetic``) or a ``train/`` + ``val/``
    image tree at ``--data_root``."""
    from .imagenet import FolderImageNet, IndexedLoader, SyntheticImageNet

    image_size = getattr(args, "image_size", 0) or 224
    if getattr(args, "synthetic", False):
        num_classes = getattr(args, "num_classes", 0) or 1000
        n_tr, n_te = imagenet_synthetic_sizes()
        train_ds = SyntheticImageNet(n_tr, image_size=image_size,
                                     num_classes=num_classes, seed=0)
        test_ds = SyntheticImageNet(n_te, image_size=image_size,
                                    num_classes=num_classes, seed=1)
    else:
        root = getattr(args, "data_root", "") or "./imagenet"
        train_ds = FolderImageNet(root, "train", image_size=image_size)
        test_ds = FolderImageNet(root, "val", image_size=image_size)
    train_loader = IndexedLoader(train_ds, batch_size=args.batch_size,
                                 world_size=world_size, train=True,
                                 replica_ids=[rank])
    test_loader = IndexedLoader(test_ds, batch_size=args.batch_size,
                                world_size=world_size, train=False,
                                replica_ids=[rank], with_valid=True)
    return train_loader, test_loader


def get_loader(args, *, world_size: int = 1, rank: int = 0):
    """``(train_loader, test_loader)`` for this rank — the JAX
    ``get_loader``. ``args`` needs ``batch_size`` and optionally
    ``dataset`` (``cifar`` | ``imagenet``), ``synthetic``,
    ``data_root``, ``image_size`` and ``num_classes``; the shuffle seed
    is 0, as in JAX. The primary rank prints the reference's dataset
    banner."""
    if getattr(args, "dataset", "cifar") == "imagenet":
        train_loader, test_loader = _imagenet_loaders(args, world_size, rank)
    else:
        train_loader, test_loader = _cifar_loaders(args, world_size, rank)
    if rank == 0 and get_rank() == 0:  # not the other model ranks
        print("-------------------Make loader-------------------")
        print("Train Dataset :", train_loader.dataset_size,
              "   Test Dataset :", test_loader.dataset_size)
    return train_loader, test_loader


def _cifar_loaders(args, world_size: int, rank: int):
    """The CIFAR route: :class:`ShardedLoader` over the synthetic set or
    the ``cifar-10-batches-py`` files at ``--data_root``."""
    if getattr(args, "synthetic", False):
        n_tr, n_te = synthetic_sizes()
        tr_x, tr_y = synthetic_cifar10(n_tr, seed=0)
        te_x, te_y = synthetic_cifar10(n_te, seed=1)
    else:
        root = getattr(args, "data_root", "") or "./cifar10_data"
        tr_x, tr_y = load_cifar10(root, train=True)
        te_x, te_y = load_cifar10(root, train=False)
    train_loader = ShardedLoader(tr_x, tr_y, batch_size=args.batch_size,
                                 world_size=world_size, train=True,
                                 replica_ids=[rank])
    test_loader = ShardedLoader(te_x, te_y, batch_size=args.batch_size,
                                world_size=world_size, train=False,
                                replica_ids=[rank], with_valid=True)
    return train_loader, test_loader
