"""Tracing and step timing (the port of the JAX package's
``utils/profiler.py``, over ``torch.profiler``).

- :func:`trace`: capture the enclosed region into ``logdir`` as a
  TensorBoard-loadable trace (``*.pt.trace.json`` through
  ``torch.profiler.tensorboard_trace_handler``): host ops and, on a
  card, the CUDA kernels (``main --profile LOGDIR``);
- :func:`annotate`: a named region of the timeline
  (``torch.profiler.record_function``);
- :func:`sync` and :class:`StepTimer`: step timing whose tick boundary
  waits for the card (``torch.cuda.synchronize``), with warmup ticks
  kept apart.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch


def sync(step_output=None) -> None:
    """Wait for the work queued on the card (a no-op without one). The
    output is not read: ``torch.cuda.synchronize`` waits for all of it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, *, worker_name: Optional[str] = None):
    """Profile the enclosed region into ``logdir`` (made if missing):
    CPU activity always, CUDA activity when a card is present. The
    trace file is written when the region ends."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       logdir, worker_name=worker_name))
    with prof:
        yield prof
        sync()  # the card's last kernels inside the trace


def annotate(name: str):
    """A named region visible in the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall time: :meth:`tick` waits for the card before it
    reads the clock. The first ``warmup`` ticks are kept apart."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self.warmup_times: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, step_output=None) -> float:
        sync(step_output)
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        if len(self.warmup_times) < self.warmup:
            self.warmup_times.append(dt)
        else:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.mean else 0.0
