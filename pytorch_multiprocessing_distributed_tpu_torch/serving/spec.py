"""Self-drafting n-gram tables for speculative decode (the port of the
JAX package's ``serving/spec.py``).

Speculative decode (:func:`...inference.generate._decode_horizon` with
``draft_k > 0``) needs ``k`` proposals per slot per pass. Self-drafting
takes them from the request's own prompt and emitted tokens: a per-slot
unigram index mapping each token (hashed with the device formula,
:func:`...inference.generate.draft_bucket`) to the ``k`` tokens that
followed its most recent occurrence. Repetitive text makes those
proposals match the target's own greedy outputs.

The table is a host mirror with a lazy upload, as
``PagePool.device_table()``: refreshed at drain and admission boundaries
by a bounded backward scan over the recent history (host numpy), and
uploaded only when a slot's index changed, as a fresh tensor copied on
the current stream from a pinned snapshot, so a horizon still queued
keeps reading the old table.

Correctness never depends on the table: a stale, missing (``-1``) or
colliding entry only lowers acceptance, since every emitted token is the
target model's greedy output, verified on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..inference.generate import DRAFT_HASH_PRIME

__all__ = ["NgramDrafter", "ngram_bucket"]


def ngram_bucket(tokens, n_buckets: int) -> np.ndarray:
    """Host (numpy) twin of :func:`...inference.generate.draft_bucket`:
    uint32 wraparound multiply, then the bucket."""
    arr = np.asarray(tokens, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = arr * np.uint32(DRAFT_HASH_PRIME)
    return (h % np.uint32(n_buckets)).astype(np.int32)


class NgramDrafter:
    """Per-slot unigram draft tables, ``[max_slots, buckets, k]`` int32
    (``-1`` = no proposal, never accepted).

    ``note_history(slot, history)`` refreshes one slot's index from its
    request's tokens (prompt + emitted). The most recent occurrence of a
    token wins its bucket, so the rebuild walks backward and stops once
    every bucket is owned, and in any case after ``scan_window``
    positions (a recency window: an unbounded walk would cost O(history)
    host work per drained block). A stream that settles into a loop
    converges to a fixed index and the uploads stop."""

    def __init__(self, max_slots: int, draft_k: int,
                 n_buckets: int = 64,
                 device: Union[str, torch.device] = "cpu",
                 scan_window: Optional[int] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if n_buckets < 1:
            raise ValueError(
                f"n_buckets must be >= 1, got {n_buckets}")
        self.max_slots = int(max_slots)
        self.k = int(draft_k)
        self.n_buckets = int(n_buckets)
        self.scan_window = (int(scan_window) if scan_window is not None
                            else 4 * self.n_buckets)
        if self.scan_window < 1:
            raise ValueError(
                f"scan_window must be >= 1, got {self.scan_window}")
        self.device = torch.device(device)
        self._table = np.full(
            (self.max_slots, self.n_buckets, self.k), -1, np.int32)
        self._dev: Optional[torch.Tensor] = None
        self._dirty = True
        self.uploads = 0  # how often the mirror moved to the device

    def build_row(self, history: Sequence[int]) -> np.ndarray:
        """One slot's ``[buckets, k]`` index from a token history: a
        backward walk over at most the ``scan_window`` most recent
        context positions, stopped once every bucket is owned."""
        row = np.full((self.n_buckets, self.k), -1, np.int32)
        hist = np.asarray(list(history), np.int32)
        if hist.size < 2:
            return row
        lo = max(0, hist.size - 1 - self.scan_window)
        buckets = ngram_bucket(hist[lo:-1], self.n_buckets)
        filled = np.zeros((self.n_buckets,), bool)
        left = self.n_buckets
        for j in range(hist.size - 2, lo - 1, -1):
            b = buckets[j - lo]
            if filled[b]:
                continue  # a later occurrence already owns the bucket
            filled[b] = True
            nxt = hist[j + 1:j + 1 + self.k]
            row[b, :nxt.size] = nxt
            left -= 1
            if not left:
                break
        return row

    def note_history(self, slot: int, history: Sequence[int]) -> None:
        """Refresh ``slot``'s index; the device copy goes stale only
        when the index actually changed."""
        row = self.build_row(history)
        if not np.array_equal(row, self._table[slot]):
            self._table[slot] = row
            self._dirty = True

    def device_table(self) -> torch.Tensor:
        """The ``[max_slots, buckets, k]`` int32 table on the device,
        uploaded again only after a change: a fresh tensor each time,
        copied on the current stream from a private (pinned, on a card)
        snapshot of the mirror, so kernels still queued keep reading the
        old one."""
        if self._dirty or self._dev is None:
            snap = torch.from_numpy(self._table.copy())
            if self.device.type == "cuda":
                snap = snap.pin_memory()
            self._dev = snap.to(self.device, non_blocking=True)
            self._dirty = False
            self.uploads += 1
        return self._dev
