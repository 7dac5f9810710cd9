"""ImageNet-scale input (the port of the JAX package's
``data/imagenet.py``; BASELINE configs #2-#5).

Two lazy sources behind one protocol (:class:`IndexedDataset`):

- :class:`SyntheticImageNet`: class-separable images computed per index
  on demand, byte-equal to the JAX set (the per-class 8x8 patterns from
  ``default_rng(seed)``, the golden-ratio label hash, the uint32 noise
  hash), so ImageNet-shaped runs need no files at any nominal size;
- :class:`FolderImageNet`: a ``root/<split>/<wnid>/*`` tree (the
  torchvision ``ImageFolder`` layout), class ids by sorted wnid, decoded
  lazily by Pillow on a thread pool (Pillow is imported at first decode:
  a machine without it can still run the synthetic set).

:class:`IndexedLoader` shards them as the CIFAR loader does
(``padded_epoch_indices``, the same ``set_epoch``), draws the
augmentations from one stream per (seed, epoch, 77, rank) as JAX does,
and assembles batches on a background thread; the trainer then copies
each batch to the card through pinned memory
(:func:`.pipeline.prefetch`). Train augmentation: RandomResizedCrop and
a horizontal flip (a flip alone for the synthetic set); eval: Resize to
``size * 256 / 224`` and a center crop; then the ImageNet mean/std.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.sampler import padded_epoch_indices

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(images: np.ndarray) -> np.ndarray:
    """uint8 [N, H, W, C] -> f32 normalized by the ImageNet mean/std."""
    x = images.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


class IndexedDataset:
    """The lazy-dataset protocol: ``len(ds)`` and ``ds.get(indices, rng,
    train) -> (uint8 images [n, H, W, C], int32 labels [n])``."""

    image_size: int = 224
    num_classes: int = 1000

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, indices, rng, train):  # pragma: no cover - interface
        raise NotImplementedError


class SyntheticImageNet(IndexedDataset):
    """Images computed per index: a fixed low-frequency pattern per class
    plus noise hashed from (seed, index), so any slice is reproducible
    without storing it. The default nominal size is ImageNet-1k train's.
    """

    def __init__(self, n: int = 1_281_167, *, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self._n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        rng = np.random.default_rng(seed)
        self._patterns = rng.integers(
            64, 192, size=(num_classes, 8, 8, 3)).astype(np.uint8)

    def __len__(self) -> int:
        return self._n

    def label_of(self, idx: np.ndarray) -> np.ndarray:
        """The index's label (golden-ratio hash: classes stay balanced)."""
        return ((idx * 2654435761) % self.num_classes).astype(np.int32)

    def get(self, indices, rng, train):
        idx = np.asarray(indices, np.int64)
        labels = self.label_of(idx)
        s = self.image_size
        reps = -(-s // 8)
        base = np.repeat(np.repeat(self._patterns[labels], reps, axis=1),
                         reps, axis=2)[:, :s, :s, :]
        # per-index noise from a vectorised integer hash (no RNG state):
        # sample i's pixels depend only on (seed, index i)
        pix = np.arange(s * s * 3, dtype=np.uint32).reshape(1, s, s, 3)
        h = ((idx[:, None, None, None] + self.seed).astype(np.uint32)
             * np.uint32(2654435761)) ^ (pix * np.uint32(2246822519))
        h ^= h >> np.uint32(13)
        noise = (h % np.uint32(49)).astype(np.int32) - 24
        images = np.clip(base.astype(np.int32) + noise, 0,
                         255).astype(np.uint8)
        return images, labels


class FolderImageNet(IndexedDataset):
    """A ``root/<split>/<wnid>/*`` image tree, decoded lazily by Pillow.

    Class ids follow sorted wnids (torchvision ``ImageFolder``). Decoding
    runs on a persistent thread pool (Pillow releases the GIL while it
    decodes); ``num_workers=0`` decodes serially with the same per-image
    seeds, so both give the same bytes. Truncated files decode as
    torchvision pipelines do (``LOAD_TRUNCATED_IMAGES``); a file that
    cannot be decoded at all raises with its path.
    """

    _EXTS = (".jpeg", ".jpg", ".png", ".bmp")

    def __init__(self, root: str, split: str = "train", *,
                 image_size: int = 224, num_workers: Optional[int] = None):
        self.image_size = image_size
        self.num_workers = (num_workers if num_workers is not None
                            else min(8, os.cpu_count() or 1))
        self._pool = None
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            raise FileNotFoundError(f"no ImageNet split dir at {base}")
        self.paths: List[str] = []
        labels: List[int] = []
        wnids = sorted(d for d in os.listdir(base)
                       if os.path.isdir(os.path.join(base, d)))
        self.wnid_to_label = {w: i for i, w in enumerate(wnids)}
        self.num_classes = max(len(wnids), 1)
        for w in wnids:
            d = os.path.join(base, w)
            for name in sorted(os.listdir(d)):
                if name.lower().endswith(self._EXTS):
                    self.paths.append(os.path.join(d, name))
                    labels.append(self.wnid_to_label[w])
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.paths)

    def _ensure_pool(self):
        if self._pool is None and self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.num_workers,
                                            thread_name_prefix="pmdt-decode")
        return self._pool

    def get(self, indices, rng, train, seeds=None):
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        idx = np.asarray(indices)
        s = self.image_size
        out = np.empty((len(idx), s, s, 3), np.uint8)
        # per-image seeds drawn once from the epoch stream: the
        # augmentations do not depend on decode order or worker count
        seeds = (rng.integers(0, 2**63, size=len(idx)) if seeds is None
                 else np.asarray(seeds))

        def work(row: int) -> None:
            r = np.random.default_rng(seeds[row])
            path = self.paths[idx[row]]
            try:
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    out[row] = (_random_resized_crop(im, s, r) if train
                                else _center_crop(im, s))
            except Exception as e:
                raise RuntimeError(
                    f"cannot decode image {path!r}: {type(e).__name__}: "
                    f"{e}") from e

        pool = self._ensure_pool()
        if pool is None:
            for row in range(len(idx)):
                work(row)
        else:
            list(pool.map(work, range(len(idx))))  # re-raises a failure
        return out, self.labels[idx]

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_pool"] = None  # executors don't pickle; recreated on demand
        return d


def _random_resized_crop(im, size: int, rng: np.random.Generator):
    """torchvision RandomResizedCrop(size): area in [0.08, 1], aspect in
    [3/4, 4/3], 10 tries then the center-crop fallback; then a
    horizontal flip with probability 1/2."""
    w, h = im.size
    area = w * h
    arr = None
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            box = (x0, y0, x0 + cw, y0 + ch)
            arr = np.asarray(im.resize((size, size), box=box), np.uint8)
            break
    if arr is None:
        arr = _center_crop(im, size)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return arr


def _center_crop(im, size: int):
    """Resize (short side -> size * 256 / 224), then CenterCrop(size)."""
    w, h = im.size
    scale = (size * 256 // 224) / min(w, h)
    im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))))
    w, h = im.size
    x0 = (w - size) // 2
    y0 = (h - size) // 2
    return np.asarray(im.crop((x0, y0, x0 + size, y0 + size)), np.uint8)


def _synthetic_train_aug(images: np.ndarray, rng: np.random.Generator
                         ) -> np.ndarray:
    """Train augmentation of already-sized synthetic images: a random
    flip only."""
    flips = rng.random(images.shape[0]) < 0.5
    images = images.copy()
    images[flips] = images[flips, :, ::-1, :]
    return images


_DONE = object()


class IndexedLoader:
    """Epoch batches of a lazy :class:`IndexedDataset` for the given
    ranks of a data-parallel group (the twin of
    :class:`.pipeline.ShardedLoader`; in the port one process per rank,
    so ``replica_ids=[rank]``).

    Yields ``(images f32 NHWC, labels int32[, valid bool])`` host batches
    of ``len(replica_ids) * batch_size // world_size`` rows in rank
    order, assembled ``prefetch_batches`` ahead on a background thread
    (0 assembles inline).
    """

    def __init__(self, dataset: IndexedDataset, *, batch_size: int,
                 world_size: int, replica_ids: Optional[Sequence[int]] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, with_valid: bool = False,
                 prefetch_batches: int = 2):
        if batch_size % world_size:
            raise ValueError(
                f"global batch {batch_size} not divisible by world "
                f"{world_size}")
        self.dataset = dataset
        self.prefetch_batches = prefetch_batches
        self.batch_size = batch_size
        self.per_replica = batch_size // world_size
        self.world_size = world_size
        self.replica_ids = (list(replica_ids) if replica_ids is not None
                            else list(range(world_size)))
        self.train = train
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.with_valid = with_valid
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    @property
    def dataset_size(self) -> int:
        return len(self.dataset)

    def _shard_len(self) -> int:
        n, w = len(self.dataset), self.world_size
        return n // w if (self.drop_last and n % w) else -(-n // w)

    def __len__(self) -> int:
        n = self._shard_len()
        return (n // self.per_replica if self.drop_last
                else -(-n // self.per_replica))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self.prefetch_batches <= 0:
            yield from self._produce()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._produce():
                    if not put(item):
                        return
                item = _DONE
            except BaseException as e:  # raised again by the consumer
                item = e
            put(item)

        t = threading.Thread(target=producer, daemon=True,
                             name="pmdt-batch-assembly")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _produce(self) -> Iterator[Tuple[np.ndarray, ...]]:
        padded = np.asarray(padded_epoch_indices(
            len(self.dataset), self.world_size, shuffle=self.shuffle,
            seed=self.seed, epoch=self._epoch, drop_last=self.drop_last))
        shards = [padded[r::self.world_size] for r in self.replica_ids]
        positions = [np.asarray(r) + self.world_size
                     * np.arange(self._shard_len())
                     for r in self.replica_ids]
        # one augmentation stream per rank (seed, epoch, 77, rank): a rank
        # draws the same augmentations whoever assembles it
        rngs = [np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, 77, int(r)]))
            for r in self.replica_ids]
        for b in range(len(self)):
            lo, hi = b * self.per_replica, (b + 1) * self.per_replica
            parts = [np.asarray(s[lo:hi]) for s in shards]
            if isinstance(self.dataset, FolderImageNet):
                # seeds per rank stream, one decode round for all ranks
                seeds = np.concatenate([r.integers(0, 2**63, size=len(p))
                                        for p, r in zip(parts, rngs)])
                images, labels = self.dataset.get(
                    np.concatenate(parts), None, self.train, seeds=seeds)
            elif isinstance(self.dataset, SyntheticImageNet):
                images, labels = self.dataset.get(np.concatenate(parts),
                                                  rngs[0], self.train)
                if self.train:
                    images = np.concatenate([
                        _synthetic_train_aug(part, r) for part, r in zip(
                            np.array_split(images, len(rngs)), rngs)])
            else:
                got = [self.dataset.get(p, r, self.train)
                       for p, r in zip(parts, rngs)]
                images = np.concatenate([g[0] for g in got])
                labels = np.concatenate([g[1] for g in got])
            out = (normalize_imagenet(images), labels.astype(np.int32))
            if self.with_valid:
                out = out + (np.concatenate(
                    [p[lo:hi] < len(self.dataset) for p in positions]),)
            yield out
