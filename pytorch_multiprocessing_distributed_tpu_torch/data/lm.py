"""Token-stream data for language-model training.

The port's own copy of the JAX package's ``data/lm.py`` (numpy only,
index-identical): a flat token stream is cut into fixed ``[batch,
seq_len]`` windows and epoch-seed shuffled, and ``synthetic_tokens``
makes a deterministic Zipf stream so LM training runs data-free. The
loader yields the GLOBAL batch on every rank; each data-parallel rank
takes its contiguous rows (:func:`..train.lm.local_rows`) and moves them
to the card with one pinned, non-blocking copy
(:func:`..train.lm.to_device`).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_tokens(n: int, vocab_size: int = 257, seed: int = 0
                     ) -> np.ndarray:
    """Deterministic pseudo-text: a Zipf-distributed int32 stream (the
    same values as the JAX package's for the same arguments)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    return rng.choice(vocab_size, size=n, p=probs).astype(np.int32)


class TokenLoader:
    """Epoch iterator of ``[global_batch, seq_len]`` windows.

    Windows are non-overlapping contiguous ``seq_len`` slices of the
    stream (the next-token shift happens inside the train step); the
    final partial window is dropped.

    Args:
      tokens: 1-D int array, the corpus.
      batch_size: GLOBAL batch (split over ``world_size`` ranks).
      seq_len: tokens per sample.
      world_size: data-parallel size; ``batch_size`` must divide by it.
      shuffle: epoch-seeded shuffle of window order.
      drop_last: drop the ragged final batch (default True); False pads
        it by wraparound.
    """

    def __init__(self, tokens: np.ndarray, *, batch_size: int,
                 seq_len: int, world_size: int = 1, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
        if batch_size % world_size:
            raise ValueError(
                f"global batch {batch_size} must divide by world_size "
                f"{world_size}")
        n_windows = len(tokens) // seq_len
        if n_windows < batch_size:
            raise ValueError(
                f"corpus of {len(tokens)} tokens yields {n_windows} windows "
                f"of {seq_len} — fewer than one global batch ({batch_size})")
        self.windows = tokens[: n_windows * seq_len].reshape(n_windows,
                                                             seq_len)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.windows)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.windows))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size: (b + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                idx = np.concatenate([idx,
                                      order[: self.batch_size - len(idx)]])
            yield self.windows[idx]
