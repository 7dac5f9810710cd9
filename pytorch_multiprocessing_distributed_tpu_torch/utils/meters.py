"""Streaming scalar meters (ported from the JAX package's
``utils/meters.py``): :class:`AverageMeter` (the reference's weighted
running average) and :class:`PercentileMeter` (the same surface plus
exact, linearly interpolated percentiles over every sample), and
:func:`throughput`, the training summaries' rates."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


def throughput(items: float, seconds: float,
               world_size: int) -> Tuple[float, float]:
    """``(world rate, per-card rate)`` of ``items`` processed by all
    ``world_size`` ranks together in ``seconds``: the summaries report
    the first as ``images_per_sec``/``tokens_per_sec`` (the JAX CLIs'
    rate) and the second as ``*_per_card``."""
    rate = items / max(seconds, 1e-9)
    return rate, rate / world_size


class AverageMeter:
    """Most recent value and the running weighted average:
    ``update(v, n)`` adds ``v * n`` to the sum and ``n`` to the count."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def exact_percentile(values: Sequence[float], q: float) -> float:
    """``np.percentile(values, q)`` (linear interpolation) over a plain
    list; 0.0 for no samples."""
    n = len(values)
    if n == 0:
        return 0.0
    values = sorted(values)
    if n == 1:
        return float(values[0])
    rank = (q / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    if lo >= n - 1:
        return float(values[-1])
    frac = rank - lo
    return float(values[lo] + (values[lo + 1] - values[lo]) * frac)


class PercentileMeter(AverageMeter):
    """AverageMeter that keeps its samples for exact percentiles
    (``update(v, n)`` records ``v`` n times)."""

    def reset(self) -> None:
        super().reset()
        self.values: List[float] = []

    def update(self, val, n: int = 1) -> None:
        super().update(val, n)
        self.values.extend([val] * n)

    def percentile(self, q: float) -> float:
        return exact_percentile(self.values, q)

    def percentiles(self, qs: Sequence[float] = (50, 90, 95, 99)
                    ) -> Dict[str, float]:
        vals = sorted(self.values)
        return {f"p{q:g}": exact_percentile(vals, q) for q in qs}
