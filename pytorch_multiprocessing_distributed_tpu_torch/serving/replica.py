"""Replica handles and the prefill-to-decode transfer of the serving
fleet (the port of the JAX package's ``serving/replica.py``).

A :class:`ServingReplica` wraps one :class:`~.engine.ServingEngine` with
an identity (``rid``), a **role** (``"both"``: prefills and decodes;
``"prefill"``: runs only the prefill and hands each finished block off;
``"decode"``: receives transferred blocks and decodes them), an
**admission window** the router places against, and the stats and
health dicts the router reads. The router reaches an engine only
through these dicts (:meth:`ServingReplica.snapshot`,
:meth:`ServingReplica.health`, the shapes of a live replica's
``/snapshot.json`` and ``/healthz``) and the verbs ``enqueue``,
``step``, ``admit_prefilled`` and ``withdraw_queued``.

**The transfer.** A prefill replica runs a request through the prefill
admission runs (:meth:`~.engine.ServingEngine.prefill_detached`, whole
or chunked) and exports the standalone ``[L, 1, W, H, Dh]`` block as a
:class:`PageTransfer`; the decode replica splices it at its own slot or
pages (:meth:`~.engine.ServingEngine.admit_prefilled`), so the
continuation is token-exact with a monolithic admission. An in-process
engine exports the block on its device (``prefill_detached_resident``:
no host bounce); an engine without that method takes the host numpy
path (``prefill_detached_wire``). A torch tensor handed across could be
written by whoever else holds it, so the exported tensors are fresh
ones of that call, held only by the transfer until the splice
(:meth:`PageTransfer.consumed`) or a drop (:meth:`PageTransfer.release`)
ends its hold on the ownership ledger (:mod:`..runtime.life`).

**Admission windows.** Each handle keeps a window in ``[min_window,
window_max]`` that halves when the replica signals pressure (a
``QueueFull`` at placement, or growth of the engine's ``page_holds`` or
``requests_shed`` between steps) and grows by one a pressure-free step
(AIMD). The router admits to a replica only while its ``in_flight`` is
below the window.

All host side: no kernel and no device program changes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..runtime import life
from ..runtime import scope as graftscope
from ..runtime.faults import (DeadlineExceeded, FaultInjected,
                              GraftFaultError)
from .scheduler import DONE, FAILED, QueueFull, Request

__all__ = ["PageTransfer", "ServingReplica", "ROLES"]

ROLES = ("both", "prefill", "decode")


class PageTransfer:
    """One finished prefill leaving its prefill replica: the request
    (its lifecycle record, and so its TTFT clock, travels with it), the
    first token, and the standalone block, device tensors (the
    same-process path) or host numpy (the wire form). An int8 engine's
    blocks travel already quantized with their f32 ``k_scale`` and
    ``v_scale`` (None on a model-dtype transfer)."""

    __slots__ = ("request", "tok0", "k_block", "v_block", "k_scale",
                 "v_scale", "src_rid", "born")

    def __init__(self, request: Request, tok0: int, k_block, v_block,
                 k_scale=None, v_scale=None,
                 src_rid: Optional[str] = None):
        self.request = request
        self.tok0 = int(tok0)
        self.k_block = k_block
        self.v_block = v_block
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.src_rid = src_rid
        # the handoff clock: the router reads prefill-to-splice seconds
        self.born = time.perf_counter()
        led = life.active_ledger()
        if led is not None:
            led.acquire("transfer", id(self), holder=request.uid)

    @property
    def resident(self) -> bool:
        """True while the blocks are device tensors (the same-process
        path); False for the host numpy form."""
        return not isinstance(self.k_block, np.ndarray)

    @property
    def nbytes(self) -> int:
        """The payload's bytes, scales included."""
        n = int(self.k_block.nbytes) + int(self.v_block.nbytes)
        if self.k_scale is not None:
            n += int(self.k_scale.nbytes) + int(self.v_scale.nbytes)
        return n

    def release(self) -> None:
        """End this transfer's hold on its blocks WITHOUT a splice (the
        router's drop sites: a permanent request error, a withdrawal, the
        drain). Idempotent."""
        self.consumed()

    def consumed(self) -> None:
        """Mark the transfer finished: after a splice the block lives in
        the decode engine's pool; the transfer drops its references and
        its ledger hold."""
        led = life.active_ledger()
        if led is not None:
            led.release("transfer", id(self))
        self.k_block = self.v_block = None
        self.k_scale = self.v_scale = None


class ServingReplica:
    """One engine behind the router.

    Args:
      rid: replica id (journal names, directory keys, reports).
      engine: the wrapped :class:`~.engine.ServingEngine`.
      role: ``"both"`` | ``"prefill"`` | ``"decode"``. A prefill replica
        never decodes: requests queue host side here and leave as
        :class:`PageTransfer` s. A decode replica admits transfers (and
        ordinary requests when the router must).
      journal: the replica's redelivery WAL (default ``engine.journal``),
        what the router replays to peers when this replica dies.
      min_window / window_max: the admission window's bounds (default
        ``max_slots`` plus the queue bound, or ``max(2, max_slots)``
        without one).
      address: ``host:port`` of this replica's stats server, published
        to the fleet directory.
    """

    def __init__(self, rid: str, engine, role: str = "both",
                 journal=None, min_window: int = 1,
                 window_max: Optional[int] = None,
                 address: Optional[str] = None):
        if role not in ROLES:
            raise ValueError(
                f"role must be one of {ROLES}, got {role!r}")
        self.rid = str(rid)
        self.engine = engine
        self.role = role
        self.journal = journal if journal is not None else engine.journal
        self.address = address
        slots = engine.pool.max_slots
        queue_allow = engine.scheduler.max_queue
        if window_max is None:
            window_max = slots + (queue_allow if queue_allow is not None
                                  else max(2, slots))
        if min_window < 1:
            raise ValueError(
                f"min_window must be >= 1, got {min_window}")
        self.min_window = int(min_window)
        self.window_max = max(int(window_max), self.min_window)
        self.window = self.window_max
        # the pressure counters at the last poll: their growth between
        # polls is the backpressure signal
        self._holds_base = engine.metrics.page_holds
        self._shed_base = engine.metrics.requests_shed
        self._prefill_queue: Deque[Request] = deque()
        self._born = time.perf_counter()
        self._prefill_s = 0.0  # a prefill replica's productive seconds
        self.transfers_out = 0
        self.reaped = False  # the router's: dead and redelivered
        # warm-up work before the router admitted traffic here, which
        # the fleet's merged counters subtract
        self.prewarm_tokens = 0
        self.prewarm_requests = 0

    # ---- identity and health (the /healthz shape) ---------------------
    @property
    def decode_capable(self) -> bool:
        return self.role in ("both", "decode")

    @property
    def dead(self) -> bool:
        return self.engine.health.dead

    def health(self) -> Dict:
        """The replica's ``/healthz`` payload (the health machine's
        snapshot) with its ``rid`` and ``role``."""
        out = dict(self.engine.health.snapshot())
        out["rid"] = self.rid
        out["role"] = self.role
        return out

    # ---- stats (the /snapshot.json shape) -----------------------------
    @property
    def in_flight(self) -> int:
        """The engine's own in-flight work plus the prompts waiting in
        the prefill queue."""
        return self.engine.in_flight + len(self._prefill_queue)

    def snapshot(self) -> Dict:
        """The placement stats the router reads: queue depths, free
        slots and pages, the pressure counters, the admission window and
        this replica's goodput fraction (productive decode and prefill
        seconds over its wall seconds)."""
        engine = self.engine
        m = engine.metrics
        wall = time.perf_counter() - self._born
        productive = m.decode_elapsed_s + self._prefill_s
        return {
            "rid": self.rid,
            "role": self.role,
            "state": engine.health.state,
            "state_name": engine.health.state.upper(),
            "queue_depth": engine.scheduler.queue_depth,
            "prefill_queue_depth": len(self._prefill_queue),
            "in_flight": self.in_flight,
            "free_slots": engine.pool.free_slots,
            "free_pages": getattr(engine.pool, "free_pages", -1),
            "page_holds": m.page_holds,
            "requests_shed": m.requests_shed,
            "requests_completed": m.requests_completed,
            "requests_redelivered": m.requests_redelivered,
            "tokens_generated": m.tokens_generated,
            "transfers_out": self.transfers_out,
            "admit_window": self.window,
            "goodput_frac": (productive / wall if wall > 0 else 0.0),
            # JAX's key: a rollout's weight version (no rollout here)
            "model_tag": None,
        }

    # ---- the admission window (AIMD) ------------------------------------
    def admittable(self) -> bool:
        """READY and inside the admission window (a DRAINING replica
        keeps stepping but admits nothing)."""
        return self.engine.health.ready and self.in_flight < self.window

    def load(self) -> Tuple[int, int]:
        """The least-loaded key: in-flight first, then more free pages
        (a dense pool's -1 ties)."""
        return (self.in_flight,
                -int(getattr(self.engine.pool, "free_pages", -1)))

    def note_pressure(self) -> None:
        """One pressure signal (a ``QueueFull`` at placement): halve the
        window."""
        new = max(self.min_window, self.window // 2)
        if new != self.window:
            graftscope.emit("route.window", cat="serving",
                            rid=self.rid, window=new, was=self.window)
        self.window = new

    def poll_pressure(self) -> None:
        """After each step: growth of ``page_holds`` or
        ``requests_shed`` since the last poll halves the window, a
        pressure-free step grows it by one."""
        m = self.engine.metrics
        pressured = (m.page_holds > self._holds_base
                     or m.requests_shed > self._shed_base)
        self._holds_base = m.page_holds
        self._shed_base = m.requests_shed
        if pressured:
            self.note_pressure()
        elif self.window < self.window_max:
            self.window += 1

    # ---- placement verbs ------------------------------------------------
    def enqueue(self, request: Request) -> Request:
        """Place one ordinary request (decode-capable roles only)."""
        if not self.decode_capable:
            raise ValueError(
                f"replica {self.rid} is prefill-only; the router "
                "routes ordinary admissions to decode-capable "
                "replicas")
        return self.engine.enqueue(request)

    def submit_prefill(self, request: Request) -> Request:
        """Queue one request for detached prefill (prefill role)."""
        if self.role != "prefill":
            raise ValueError(
                f"replica {self.rid} has role {self.role!r}; "
                "submit_prefill is the prefill-role intake")
        if not self.engine.health.ready:
            raise QueueFull(
                f"prefill replica {self.rid} is "
                f"{self.engine.health.state}; place elsewhere")
        if request.submit_time is None:
            request.submit_time = time.perf_counter()
        self._prefill_queue.append(request)
        return request

    def withdraw_prefill(self) -> List[Request]:
        """Empty the prefill intake (death or drain: the router places
        these again; no token exists yet, so a plain re-route is
        exact)."""
        out = list(self._prefill_queue)
        self._prefill_queue.clear()
        return out

    def prewarm(self, prompts, max_new: int = 1,
                max_steps: int = 10_000) -> int:
        """Run ``prompts`` through this replica before the router admits
        traffic to it (its prefix cache fills with the fleet's hot
        prompts). The tokens and the requests that finished are counted
        in ``prewarm_tokens``/``prewarm_requests``, which the fleet's
        merge subtracts. Returns the prompts warmed."""
        if not self.decode_capable:
            return 0
        warmed = []
        for i, prompt in enumerate(prompts):
            request = Request(list(prompt), int(max_new),
                              self.engine.eos_id,
                              uid=f"warm-{self.rid}-{i}")
            try:
                self.enqueue(request)
            except QueueFull:
                break
            except ValueError:
                continue
            warmed.append(request)
        steps = 0
        while self.engine.in_flight and steps < max_steps:
            self.step()
            steps += 1
        # only DONE ones: the merge subtracts these from
        # requests_completed, which never counted a failed one
        self.prewarm_requests += sum(1 for r in warmed if r.state == DONE)
        self.prewarm_tokens += sum(len(r.tokens) for r in warmed)
        graftscope.emit("scale.prewarm", cat="serving", rid=self.rid,
                        prompts=len(warmed), tokens=self.prewarm_tokens)
        return len(warmed)

    # ---- drive ----------------------------------------------------------
    def step(self) -> List[Tuple[Request, int, bool]]:
        """One engine step (decode-capable roles; a prefill replica
        works in :meth:`prefill_step`)."""
        if not self.decode_capable:
            return []
        return self.engine.step()

    def step_submit(self):
        """Phase 1 of a pipelined fleet step: an engine with an
        asynchronous ``step_async`` returns its handle; an in-process
        engine has none, so None (the router steps it in
        :meth:`step_complete`)."""
        if not self.decode_capable or self.dead:
            return None
        submit = getattr(self.engine, "step_async", None)
        if submit is None:
            return None
        return submit()

    def step_complete(self, handle) -> List[Tuple[Request, int, bool]]:
        """Phase 2: the events of a :meth:`step_submit` handle (None =
        the synchronous step now)."""
        if handle is None:
            return self.step()
        return self.engine.step_complete(handle)

    def prefill_step(self) -> Optional[PageTransfer]:
        """Run ONE queued prompt through detached prefill and export its
        block (prefill role; one prompt a router step). An in-process
        engine exports it on its device, another the host numpy form. A
        per-request failure fails that request named and returns None;
        a named fatal marks the replica DEAD and propagates (the router
        reaps it and places its queue again)."""
        if not self._prefill_queue:
            return None
        request = self._prefill_queue.popleft()
        t0 = time.perf_counter()
        resident_fn = getattr(self.engine, "prefill_detached_resident",
                              None)
        try:
            if resident_fn is not None:
                (tok0, k_block, v_block, k_scale,
                 v_scale) = resident_fn(
                     request, chunk=self.engine._prefill_chunk)
            else:
                (tok0, k_block, v_block, k_scale,
                 v_scale) = self.engine.prefill_detached_wire(
                     request, chunk=self.engine._prefill_chunk)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            if (isinstance(e, GraftFaultError)
                    and not isinstance(e, (FaultInjected,
                                           DeadlineExceeded))):
                self.engine.health.to_dead(type(e).__name__)
                raise
            request.state = FAILED
            request.finish_reason = "error"
            request.error = e
            request.finish_time = time.perf_counter()
            self.engine.metrics.record_failure()
            graftscope.emit("request.failed", cat="request",
                            req=request.uid, error=type(e).__name__,
                            where="detached_prefill")
            return None
        self._prefill_s += time.perf_counter() - t0
        self.transfers_out += 1
        transfer = PageTransfer(request, tok0, k_block, v_block,
                                k_scale=k_scale, v_scale=v_scale,
                                src_rid=self.rid)
        graftscope.emit("route.transfer", cat="serving",
                        req=request.uid, src=self.rid,
                        nbytes=transfer.nbytes,
                        resident=transfer.resident)
        return transfer
