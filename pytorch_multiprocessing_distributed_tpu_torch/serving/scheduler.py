"""FIFO request scheduling + admission control for the serving engine.

Pure host-side bookkeeping, ported from the JAX package's
``serving/scheduler.py``: the bounded FIFO queue, the static-fit check
against the pool's ``s_max``, each request's lifecycle record, the
prefill bucket ladder and the adaptive decode horizon. Chunked-prefill
plans, speculative draft lengths, deadlines and withdrawal are not in
this slice (ROADMAP.md).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, List, Optional, Sequence


def bucket_length(length: int, min_bucket: int, s_max: int) -> int:
    """Smallest power-of-two >= ``length`` (floored at ``min_bucket``,
    capped at ``s_max``): the padded prompt widths prefill runs at."""
    b = min_bucket
    while b < length:
        b *= 2
    return min(b, s_max)


def pick_horizon(h_max: int, window: int, max_pos: int,
                 min_remaining: int, admission_pending: bool) -> int:
    """Adaptive fused-decode horizon, snapped to the ``{1, h_max}``
    ladder: the candidate ``min(h_max, window - max_pos,
    min_remaining)`` (steps before the highest slot's write crosses the
    window bucket; the shortest remaining budget) realises as ``h_max``
    only when nothing cuts it, else 1; pending admission forces 1 so a
    queued request joins within one step."""
    if h_max <= 1 or admission_pending:
        return 1
    h = min(h_max, window - max_pos, min_remaining)
    return h_max if h >= h_max else 1


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity — the
    engine's backpressure signal (callers step the engine and retry, or
    shed the request); every rejection is counted in
    ``ServingMetrics.requests_shed``."""


# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"

_uid_counter = itertools.count()


class Request:
    """One serving request and its lifecycle record: ``tokens`` (the
    generated ids, prompt excluded), ``slot`` while RUNNING, the host
    ``perf_counter`` stamps ``submit_time``/``admit_time``/
    ``first_token_time``/``finish_time`` (TTFT = first token - submit,
    queue wait included) and ``finish_reason`` (``"eos"`` or
    ``"length"``)."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: Optional[int] = None, uid=None):
        self.prompt = list(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.uid = next(_uid_counter) if uid is None else uid
        self.state = QUEUED
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.submit_time: Optional[float] = None
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.finish_reason: Optional[str] = None

    def __repr__(self) -> str:
        return (f"Request(uid={self.uid}, state={self.state}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.tokens)})")


class FIFOScheduler:
    """Bounded FIFO queue with static-fit admission control.

    Args:
      s_max: the pool's per-slot capacity; ``len(prompt) +
        max_new_tokens`` must fit or submission raises ``ValueError``
        (the request could never run).
      max_queue: queued-request bound (None = unbounded); beyond it
        :class:`QueueFull`.
    """

    def __init__(self, s_max: int, max_queue: Optional[int] = None):
        self.s_max = int(s_max)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: Deque[Request] = deque()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, request: Request) -> Request:
        """Validate and enqueue."""
        n_prompt = len(request.prompt)
        if n_prompt < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens}")
        if n_prompt + request.max_new_tokens > self.s_max:
            raise ValueError(
                f"prompt {n_prompt} + max_new_tokens "
                f"{request.max_new_tokens} exceeds the slot capacity "
                f"s_max={self.s_max}")
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            raise QueueFull(
                f"queue at capacity ({self.max_queue}); resubmit later")
        self._queue.append(request)
        return request

    def next_to_admit(self) -> Optional[Request]:
        """Pop the FIFO head for admission (None when empty)."""
        if not self._queue:
            return None
        request = self._queue.popleft()
        request.state = RUNNING
        return request

    def complete(self, request: Request, reason: str) -> None:
        request.state = DONE
        request.finish_reason = reason
        request.slot = None
