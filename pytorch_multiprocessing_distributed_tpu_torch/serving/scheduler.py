"""FIFO request scheduling + admission control for the serving engine.

Pure host-side bookkeeping, ported from the JAX package's
``serving/scheduler.py``: the bounded FIFO queue, the static-fit check
against the pool's ``s_max``, each request's lifecycle record, the
prefill bucket ladder, the adaptive decode horizon and the chunked
prefill plan, the speculative draft length, the per-request deadlines
and the queue withdrawals the fleet's router uses (``withdraw_uid``,
``withdraw_tail``, ``requeue_tail``).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple


def bucket_length(length: int, min_bucket: int, s_max: int) -> int:
    """Smallest power-of-two >= ``length`` (floored at ``min_bucket``,
    capped at ``s_max``): the padded prompt widths prefill runs at."""
    b = min_bucket
    while b < length:
        b *= 2
    return min(b, s_max)


def pick_horizon(h_max: int, window: int, max_pos: int,
                 min_remaining: int, admission_pending: bool,
                 per_step: int = 1) -> int:
    """Adaptive fused-decode horizon, snapped to the ``{1, h_max}``
    ladder: the candidate ``min(h_max, (window - max_pos) // per_step,
    min_remaining)`` (passes before the highest slot's writes cross the
    window bucket, ``per_step`` being the worst-case columns a pass
    writes and reads — 1 for plain decode, ``draft_k + 1`` under
    speculation; the shortest remaining budget) realises as ``h_max``
    only when nothing cuts it, else 1; pending admission forces 1 so a
    queued request joins within one step."""
    if h_max <= 1 or admission_pending:
        return 1
    h = min(h_max, (window - max_pos) // max(1, per_step),
            min_remaining)
    return h_max if h >= h_max else 1


def pick_draft_k(k_max: int, accept_ema: Optional[float],
                 cooldown_active: bool, probe: bool = False,
                 min_accept: float = 0.125) -> int:
    """Adaptive draft length for speculative decode, snapped to the
    ``{0, k_max}`` ladder (the JAX package's ``pick_draft_k``).

    Collapses to 0 (the plain decode pass) during a post-fault cooldown
    (``cooldown_active``; the port has no fault cooldown, so its engine
    passes False) and when ``accept_ema``, the engine's decayed mean of
    accepted drafts over ``k`` per verify pass, has fallen below
    ``min_accept``: drafts that never match cost ``k + 1`` query rows
    for one token. ``probe`` overrides the collapse for one dispatch so
    a stream that turned repetitive again can re-arm. ``accept_ema=None``
    (nothing measured yet) arms optimistically.
    """
    if k_max <= 0 or cooldown_active:
        return 0
    if (accept_ema is not None and accept_ema < min_accept
            and not probe):
        return 0
    return k_max


class PrefillPlan:
    """Chunk schedule for one joining prompt (the JAX package's
    ``PrefillPlan``).

    The prompt (length ``L``) is prefilled into a standalone cache of
    ``width`` columns — its length bucket rounded UP to whole
    ``chunk``-sized pieces, so every chunk call has the shape ``[1,
    chunk]`` against the same cache width. ``width`` may overshoot
    ``s_max`` by up to ``chunk - 1`` pad columns; the engine's splice
    drops them (valid columns are ``[0, L)`` and ``L < s_max``).

    ``starts`` are the chunk offsets ``start_at, start_at + chunk,
    ...``; the last chunk is right-padded to ``chunk`` (its pad columns
    lie beyond ``L``, where the decode mask keeps them invisible until
    decode overwrites them). ``start_at`` (a prefix-cache resume) skips
    the leading columns a shared-prefix hit already holds; it must be
    ``< L``.
    """

    def __init__(self, request: "Request", chunk: int, min_bucket: int,
                 s_max: int, start_at: int = 0):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        length = len(request.prompt)
        if not 0 <= start_at < length:
            raise ValueError(
                f"start_at must be in [0, {length}), got {start_at}")
        self.request = request
        self.chunk = int(chunk)
        self.length = length
        self.start_at = int(start_at)
        bucket = bucket_length(length, min_bucket, s_max)
        self.width = -(-bucket // chunk) * chunk
        self.starts: Tuple[int, ...] = tuple(
            range(self.start_at, length, chunk))
        self._next = 0

    @property
    def done(self) -> bool:
        return self._next >= len(self.starts)

    def next_chunk(self) -> Tuple[int, int, bool]:
        """Claim the next chunk: ``(start, valid_len, is_last)``."""
        start = self.starts[self._next]
        self._next += 1
        return (start, min(self.chunk, self.length - start),
                self._next >= len(self.starts))


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity — the
    engine's backpressure signal (callers step the engine and retry, or
    shed the request); every rejection is counted in
    ``ServingMetrics.requests_shed``."""


class RequestWithdrawn(RuntimeError):
    """The error recorded on a request evicted by
    :meth:`~.engine.ServingEngine.withdraw`: its client abandoned it, so
    the engine reclaims its slot and pages now instead of decoding to
    the token budget for nobody. The request leaves FAILED with reason
    ``"withdraw"``."""


# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"

_uid_counter = itertools.count()


class Request:
    """One serving request and its lifecycle record: ``tokens`` (the
    generated ids, prompt excluded), ``slot`` while RUNNING, the host
    ``perf_counter`` stamps ``submit_time``/``admit_time``/
    ``first_token_time``/``finish_time`` (TTFT = first token - submit,
    queue wait included) and ``finish_reason`` (``"eos"`` or
    ``"length"`` once DONE; once FAILED, with the error in ``error``,
    ``"error"`` for a request quarantined by a fault, ``"deadline"``
    past its deadline, ``"drain"`` at the drain deadline and ``"pages"``
    when the page pool could never hold it). ``prefix_hit`` is
    ``"full"``, ``"partial"`` or None: whether the request joined
    through the shared-prefix cache. ``deadline_s``: an optional budget
    of wall seconds from ``submit_time``; past it the engine evicts the
    request, queued or running, as FAILED with a
    :class:`~..runtime.faults.DeadlineExceeded`."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: Optional[int] = None, uid=None,
                 deadline_s: Optional[float] = None):
        self.prompt = list(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.uid = next(_uid_counter) if uid is None else uid
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.state = QUEUED
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.prefix_hit: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.submit_time: Optional[float] = None
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.finish_reason: Optional[str] = None

    def overdue(self, now: float) -> bool:
        """Past the per-request deadline (False when none is set)."""
        return (self.deadline_s is not None
                and self.submit_time is not None
                and now - self.submit_time > self.deadline_s)

    def timeline(self) -> dict:
        """The lifecycle as latencies from the engine's ``perf_counter``
        stamps (JAX's ``Request.timeline``): queue wait, TTFT, decode
        tail and total, only the phases the request reached. The CLI
        emits one ``request.timeline`` event per terminal request."""
        out = {"uid": self.uid, "state": self.state,
               "finish_reason": self.finish_reason,
               "prompt_len": len(self.prompt),
               "tokens": len(self.tokens)}
        if self.error is not None:
            out["error"] = type(self.error).__name__
        t = self.submit_time
        if t is None:
            return out
        if self.admit_time is not None:
            out["queue_wait_s"] = self.admit_time - t
        if self.first_token_time is not None:
            out["ttft_s"] = self.first_token_time - t
        if self.finish_time is not None:
            out["total_s"] = self.finish_time - t
            if self.first_token_time is not None:
                out["decode_s"] = self.finish_time - self.first_token_time
        return out

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

    def peek(self) -> Optional[Request]:
        """The FIFO head without popping it: the paged engine checks the
        head's page demand before it commits to admitting it."""
        return self._queue[0] if self._queue else None

    def next_to_admit(self) -> Optional[Request]:
        """Pop the FIFO head for admission (None when empty)."""
        if not self._queue:
            return None
        request = self._queue.popleft()
        request.state = RUNNING
        return request

    def withdraw_tail(self) -> Optional[Request]:
        """Remove and return the queue TAIL, still QUEUED (the router's
        work stealing: the request that would wait longest here moves to
        an idle peer; its ``submit_time`` travels with it). None when
        the queue is empty."""
        return self._queue.pop() if self._queue else None

    def withdraw_uid(self, uid) -> Optional[Request]:
        """Remove and return the QUEUED request carrying ``uid``, or
        None when no queued request has it."""
        for request in self._queue:
            if request.uid == uid:
                self._queue.remove(request)
                return request
        return None

    def requeue_tail(self, request: Request) -> None:
        """Put a withdrawn request back at the TAIL (a theft the thief
        refused after all). Skips the bound: the request was already
        counted against it."""
        self._queue.append(request)

    def complete(self, request: Request, reason: str) -> None:
        request.state = DONE
        request.finish_reason = reason
        request.slot = None

    def fail(self, request: Request, error: BaseException,
             reason: str = "error") -> None:
        """The request leaves the engine as FAILED with its error
        recorded, never re-admitted."""
        request.state = FAILED
        request.finish_reason = reason
        request.error = error
        request.slot = None

    def take(self, uids) -> List[Request]:
        """Remove and return the QUEUED requests whose uid is in
        ``uids``, in queue order (the engine's deadline expiry: running
        requests hold slots, which the engine evicts itself)."""
        want = set(uids)
        taken = [r for r in self._queue if r.uid in want]
        for request in taken:
            self._queue.remove(request)
        return taken
