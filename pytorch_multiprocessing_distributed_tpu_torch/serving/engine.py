"""Continuous-batching serving engine over the shared KV-cache decode.

The port of the JAX package's ``serving/engine.py``, dense subset:

- the KV cache is a :class:`~.kv_slots.SlotPool` of fixed
  ``[layers, max_slots, s_max, heads, head_dim]`` tensors, written in
  place;
- **prefill-on-join**: a joining prompt is right-padded to its
  power-of-two bucket, run through the shared
  :func:`...inference.generate._prefill`, its first token sampled from
  the prefill logits (``generate``'s ``tok0``), and its cache columns
  spliced into a free slot;
- **length-bucketed decode**: each decode step attends over the cache
  prefix ``[0, W)``, ``W`` the smallest ladder bucket covering the
  longest ACTIVE sequence (tracked on the host, no device read);
- **decode horizon**: when no admission is pending, up to
  ``decode_horizon`` steps run back to back
  (:func:`...inference.generate._decode_horizon`, the body ``generate``
  decodes on) with the eos/budget freeze gates on the device and ONE
  token-block readback; in steady state horizon ``h+1`` is launched
  before horizon ``h`` is read back, so the host does not sit between
  the card and its next work;
- decode attention is the hand-written CUDA flash-decode kernel on the
  card (``decode_attn="auto"``), the plain PyTorch version on the CPU.

Greedy decode through the engine is token-for-token identical to
per-request :func:`...inference.generate` (same helpers, same
dtype/eps conventions).

Not in this slice, each rejected with ``NotImplementedError`` at
construction (ROADMAP.md, "Port: serving features still to port"):
tensor parallelism (``mesh``), paged KV (``kv_layout="paged"``,
``page_size``, ``num_pages``, ``prefix_cache``), int8 KV
(``kv_dtype="int8"``), speculative decode (``draft_k``,
``draft_model``, ``draft_params``), chunked prefill (``prefill_chunk``),
the request journal (``journal``), fault retries and the readback
watchdog (``dispatch_retries > 1``, ``readback_timeout_s``) and
per-request deadlines (``submit(deadline_s=...)``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.generate import _decode_horizon, _logits, _prefill, _sample
from ..ops import resolve_impl
from ..utils.metrics import ServingMetrics
from .kv_slots import SlotPool
from .scheduler import DONE, FIFOScheduler, QueueFull, Request, \
    bucket_length, pick_horizon

__all__ = ["ServingEngine", "Request"]

# constructor options of the JAX engine this slice does not port, with
# the value that means "off" (accepted, so a caller passing the default
# explicitly is not rejected)
_NOT_PORTED = {
    "mesh": None, "kv_layout": "dense", "kv_dtype": "model",
    "page_size": None, "num_pages": None, "prefix_cache": 0,
    "draft_k": 0, "draft_model": None, "draft_params": None,
    "prefill_chunk": None, "journal": None, "dispatch_retries": 1,
    "readback_timeout_s": None,
}

Event = Tuple[Request, int, bool]


class _TokenBlock:
    """One launched decode horizon awaiting readback: the device
    ``[h, slots]`` token block plus which request held each slot at
    launch."""

    __slots__ = ("tokens", "h", "window", "slots")

    def __init__(self, tokens, h, window, slots):
        self.tokens = tokens
        self.h = h
        self.window = window
        self.slots = slots


class ServingEngine:
    """Slot-based continuous-batching engine.

    Args:
      model: the bound ``GPT`` (params loaded); the engine runs on its
        device.
      max_slots: concurrent requests decoded per step (the pool size).
      s_max: per-slot token capacity (default ``model.max_seq_len``).
      max_queue: bound on QUEUED requests (None = unbounded).
      temperature/top_k/top_p: sampling config (0/0/0 = greedy, the
        mode pinned equivalent to ``generate``).
      generator: ``torch.Generator`` on the model's device, required
        when ``temperature > 0``.
      eos_id: default stop token (per-request ``eos_id`` overrides).
      min_bucket: smallest prefill bucket and first decode-window rung.
      decode_buckets: attention-window ladder (None = powers of two from
        ``min_bucket`` to ``s_max``; an empty sequence = always the
        full ``s_max`` window).
      decode_horizon: max decode steps per launched block (realised on
        the ``{1, H}`` ladder by :func:`~.scheduler.pick_horizon`).
      decode_attn: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see
        :mod:`...ops`).
    """

    def __init__(self, model, *, max_slots: int,
                 s_max: Optional[int] = None,
                 max_queue: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, min_bucket: int = 16,
                 decode_buckets: Optional[Sequence[int]] = None,
                 decode_horizon: int = 1, decode_attn: str = "auto",
                 **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(
                    f"ServingEngine got an unexpected argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to PyTorch yet "
                    "(ROADMAP.md, 'Port: serving features still to "
                    "port')")
        if model.device.type == "meta":
            raise ValueError(
                "model has no params: bind them first with "
                "model.load_state_dict(params, assign=True)")
        if temperature > 0.0 and generator is None:
            raise ValueError(
                "sampling (temperature > 0) requires a generator")
        if top_k < 0 or top_k > model.vocab_size:
            raise ValueError(
                f"top_k must be in [0, vocab_size={model.vocab_size}], "
                f"got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        if decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        self.model = model
        self.eos_id = eos_id
        self.min_bucket = int(min_bucket)
        self.pool = SlotPool(model, max_slots, s_max)
        resolve_impl(decode_attn, self.pool.k_caches)  # device check
        self._attn_impl = decode_attn
        self.scheduler = FIFOScheduler(self.pool.s_max, max_queue)
        self.metrics = ServingMetrics()
        self._sampling = (float(temperature), int(top_k), float(top_p))
        self._generator = generator
        self._running: Dict[int, Request] = {}
        self._horizon_max = int(decode_horizon)
        # launched-but-unread token blocks (<= 2: double-buffered)
        self._blocks: Deque[_TokenBlock] = deque()
        self._buckets = self._build_buckets(decode_buckets)
        self._programs: set = set()  # (window, horizon) launched

    def _build_buckets(self, decode_buckets) -> Tuple[int, ...]:
        """Ascending window ladder, capped by and ending at ``s_max``."""
        s_max = self.pool.s_max
        if decode_buckets is None:
            ladder = []
            b = self.min_bucket
            while b < s_max:
                ladder.append(b)
                b *= 2
            ladder.append(s_max)
            return tuple(ladder)
        ladder = sorted({int(b) for b in decode_buckets})
        if ladder and ladder[0] < 1:
            raise ValueError(
                f"decode_buckets must be >= 1, got {ladder[0]}")
        ladder = [b for b in ladder if b <= s_max]
        if not ladder or ladder[-1] != s_max:
            ladder.append(s_max)
        return tuple(ladder)

    # ---- introspection -------------------------------------------------
    @property
    def decode_horizon(self) -> int:
        return self._horizon_max

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def decode_programs(self) -> Tuple[Tuple[int, int], ...]:
        """Distinct ``(window, horizon)`` decode shapes launched."""
        return tuple(sorted(self._programs))

    @property
    def decode_windows(self) -> Tuple[int, ...]:
        return tuple(sorted({w for w, _ in self._programs}))

    # ---- request lifecycle ---------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: Optional[int] = None, uid=None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue a request (FIFO). Raises ValueError when it can never
        fit a slot, ``QueueFull`` at the queue bound."""
        if deadline_s is not None:
            raise NotImplementedError(
                "per-request deadlines are not ported to PyTorch yet "
                "(ROADMAP.md, 'Port: serving features still to port')")
        return self.enqueue(Request(
            prompt, max_new_tokens,
            self.eos_id if eos_id is None else eos_id, uid))

    def enqueue(self, request: Request) -> Request:
        """Queue a pre-built :class:`Request`; ``submit_time`` is
        stamped on the first attempt and survives ``QueueFull``
        retries, so TTFT includes backpressure wait."""
        if request.submit_time is None:
            request.submit_time = time.perf_counter()
        if request.prompt and (
                min(request.prompt) < 0
                or max(request.prompt) >= self.model.vocab_size):
            raise ValueError(
                f"prompt token ids must be in [0, vocab_size="
                f"{self.model.vocab_size})")
        try:
            return self.scheduler.submit(request)
        except QueueFull:
            self.metrics.record_shed()
            raise

    def _finished(self, request: Request, token: int) -> Optional[str]:
        if request.eos_id is not None and token == request.eos_id:
            return "eos"
        if len(request.tokens) >= request.max_new_tokens:
            return "length"
        return None

    def _complete(self, request: Request, reason: str) -> None:
        request.finish_time = time.perf_counter()
        self.scheduler.complete(request, reason)
        self.metrics.record_completion(len(request.tokens))

    def _pop_admission(self) -> Optional[Request]:
        request = self.scheduler.next_to_admit()
        if request is not None:
            request.admit_time = time.perf_counter()
            self.metrics.record_admission(
                request.admit_time - request.submit_time)
        return request

    def _first_token(self, request: Request, token: int,
                     events: List[Event]) -> Optional[int]:
        """Stamp TTFT, record the prefill token, and retire an
        already-finished request or acquire its slot (None = retired)."""
        request.first_token_time = time.perf_counter()
        self.metrics.record_first_token(
            request.first_token_time - request.submit_time)
        request.tokens.append(token)
        reason = self._finished(request, token)
        if reason is not None:
            self._complete(request, reason)
            events.append((request, token, True))
            return None
        slot = self.pool.acquire()
        request.slot = slot
        self._running[slot] = request
        events.append((request, token, False))
        return slot

    def _prefill(self, prompt: List[int], length: int):
        """Whole-prompt prefill of one request right-padded to its
        bucket (causality keeps the pad columns out of the real
        prefix); returns ``(tok0 device scalar, k_pref, v_pref)``."""
        bucket = bucket_length(length, self.min_bucket, self.pool.s_max)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :length] = prompt
        tokens = torch.from_numpy(padded).to(self.model.device)
        x, k_pref, v_pref = _prefill(self.model, tokens, bucket)
        logits = _logits(self.model, x[:, length - 1:length],
                         self.model.ln_eps)[:, 0]
        tok0 = _sample(logits, *self._sampling, self._generator)
        return tok0[0].to(torch.int32), k_pref, v_pref

    def _insert(self, request: Request, slot: int, k_pref, v_pref,
                length: int, tok0) -> None:
        """Splice a prefilled request into ``slot`` (in place): cache
        columns ``[0, bucket)`` overwrite the previous tenant's, the
        position starts at the prompt length, the pending token is the
        prefill's sample, and the finish gates arm (``max_new_tokens -
        1`` decode tokens owed; the stop id or ``-1``)."""
        pool = self.pool
        width = k_pref.shape[2]
        pool.k_caches[:, slot, :width] = k_pref[:, 0]
        pool.v_caches[:, slot, :width] = v_pref[:, 0]
        pool.positions[slot] = length
        pool.last_tokens[slot] = tok0
        pool.active[slot] = True
        pool.budgets[slot] = request.max_new_tokens - 1
        pool.eos_ids[slot] = -1 if request.eos_id is None \
            else request.eos_id
        pool.note_insert(slot, length)

    def _admit(self) -> List[Event]:
        """Fill every free slot from the FIFO head, one prefill each."""
        events: List[Event] = []
        while self.pool.free_slots > 0:
            request = self._pop_admission()
            if request is None:
                break
            length = len(request.prompt)
            tok0, k_pref, v_pref = self._prefill(request.prompt, length)
            # the TTFT boundary: the host reads the first token here
            slot = self._first_token(request, int(tok0), events)
            if slot is not None:
                self._insert(request, slot, k_pref, v_pref, length, tok0)
        return events

    # ---- horizon scheduling / launch / drain ----------------------------
    def _inflight_steps(self) -> int:
        return sum(block.h for block in self._blocks)

    def _min_remaining_eff(self) -> int:
        """Shortest remaining budget over running requests, discounted
        by steps already launched against each slot."""
        rem = []
        for slot, request in self._running.items():
            assumed = sum(block.h for block in self._blocks
                          if block.slots.get(slot) is request)
            rem.append(request.max_new_tokens - len(request.tokens)
                       - assumed)
        return min(rem) if rem else 0

    def _pick_schedule(self) -> Tuple[int, int]:
        """``(window, horizon)``: the smallest bucket covering the
        highest possible next write, and the adaptive horizon."""
        max_eff = self.pool.max_active_pos + self._inflight_steps()
        window = self._buckets[-1]
        for b in self._buckets:
            if b >= max_eff + 1:
                window = b
                break
        h = pick_horizon(self._horizon_max, window, max_eff,
                         self._min_remaining_eff(),
                         self.scheduler.queue_depth > 0)
        return window, h

    def _dispatch(self, overlapped: bool = False) -> None:
        """Launch one decode horizon over every slot; the token block
        stays on the device until :meth:`_drain_one` reads it."""
        pool = self.pool
        window, h = self._pick_schedule()
        temperature, top_k, top_p = self._sampling
        tokens, (pool.positions, pool.last_tokens, pool.active,
                 pool.budgets) = _decode_horizon(
            self.model, pool.k_caches, pool.v_caches, pool.positions,
            pool.last_tokens, pool.active, pool.budgets, pool.eos_ids, h,
            window=window, attn_impl=self._attn_impl,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=self._generator)
        self._programs.add((window, h))
        self._blocks.append(_TokenBlock(tokens, h, window,
                                        dict(self._running)))
        self.metrics.record_dispatch(h, overlapped)

    def _overlap_ok(self) -> bool:
        """Launch horizon h+1 before reading horizon h back? Only in
        steady state: horizons on, one block in flight, nothing queued,
        and some running request with budget beyond what is launched."""
        return (self._horizon_max > 1
                and len(self._blocks) == 1
                and bool(self._running)
                and self.scheduler.queue_depth == 0
                and self._min_remaining_eff() >= 1)

    def _drain_one(self, events: List[Event]) -> Tuple[int, int]:
        """Read the OLDEST block back (the horizon's one host sync) and
        attribute its tokens: append per request, replay the finish
        rules the device applied (``-1`` marks rows it froze), release
        finished slots, advance the position mirror by the realised
        per-slot steps. Returns ``(window, tokens_emitted)``."""
        pool = self.pool
        block = self._blocks.popleft()
        tokens = block.tokens.cpu().numpy()
        realized: Dict[int, int] = {}
        for row in range(block.h):
            for slot, request in block.slots.items():
                if self._running.get(slot) is not request:
                    continue  # finished earlier in this or a prior block
                token = int(tokens[row, slot])
                if token < 0:
                    continue  # the device froze the row before this step
                request.tokens.append(token)
                realized[slot] = realized.get(slot, 0) + 1
                reason = self._finished(request, token)
                if reason is not None:
                    self._complete(request, reason)
                    pool.release(slot)
                    del self._running[slot]
                events.append((request, token, reason is not None))
        pool.note_advance_slots(realized)
        return block.window, sum(realized.values())

    def step(self) -> List[Event]:
        """One engine iteration: admit (a whole prompt per free slot),
        launch a decode horizon at the active-length window (plus, in
        steady state, the next one), then read back exactly one token
        block. Returns ``(request, token, finished)`` events, admission
        first tokens included."""
        events = self._admit()
        if self._running or self._blocks:
            t0 = time.perf_counter()
            if self._running and not self._blocks:
                self._dispatch()
            if self._overlap_ok():
                self._dispatch(overlapped=True)
            occupancy = self.pool.occupancy
            window, emitted = self._drain_one(events)
            self.metrics.record_decode_step(
                time.perf_counter() - t0, emitted, occupancy,
                self.scheduler.queue_depth, window)
        return events

    @property
    def in_flight(self) -> int:
        """Work somewhere in the engine: queued, decoding, or a launched
        but unread block (drive loops step until 0)."""
        return (self.scheduler.queue_depth + len(self._running)
                + (1 if self._blocks else 0))

    def run(self) -> Iterable[Event]:
        """Step until queue and pool drain, streaming token events."""
        while self.in_flight:
            yield from self.step()

    def drain(self) -> List[Event]:
        """Finish every in-flight request; returns their events."""
        return list(self.run())

    def serve(self, requests: Iterable[Tuple[Sequence[int], int]]
              ) -> List[Request]:
        """Submit ``(prompt, max_new_tokens)`` pairs, run to drain, and
        return the ``Request`` records in submission order."""
        submitted = [self.submit(p, n) for p, n in requests]
        for _ in self.run():
            pass
        if any(r.state != DONE for r in submitted):
            raise RuntimeError("serve() drained with unfinished requests")
        return submitted
