"""The serving fleet: one load- and cache-aware router over N engine
replicas (the port of the JAX package's ``serving/router.py``).

A :class:`Router` turns N engines (:class:`~.replica.ServingReplica`)
into one service with the engine's verbs (``submit``, ``step``,
``run``, ``serve``, ``begin_drain``, ``drain``). Host side only; every
replica decodes through the engine's own kernels. Four parts:

1. **Placement by load and by cache.** A fleet-level
   :class:`PrefixCacheDirectory`, keyed as the engine's
   :class:`~.kv_pages.PrefixCache` is (page-aligned token prefixes,
   hash-routed, token-verified), sends a prompt whose prefix a replica
   already holds to that replica, where its own cache turns it into a
   hit. Everything else goes to the least-loaded admittable replica
   (in-flight first, free pages second), read through
   :meth:`~.replica.ServingReplica.snapshot`. A stale hint only costs a
   miss.
2. **Backpressure.** Each replica carries an AIMD admission window.
   When no replica admits, the router HOLDS the request in its own
   bounded queue and past that bound sheds it with
   :class:`FleetSaturated`. A replica that empties its queue while a
   peer has a backlog steals the peer's queue tail (the handoff
   journaled, so exactly one replica owns a uid).
3. **Prefill/decode split.** ``role="prefill"`` replicas only prefill
   (:meth:`~.engine.ServingEngine.prefill_detached`) and hand each
   request off as a :class:`~.replica.PageTransfer`; the router places
   it on the least-loaded decode replica, which splices it at its own
   slot or pages (:meth:`~.engine.ServingEngine.admit_prefilled`):
   token-exact with a monolithic admission.
4. **Supervision.** A replica whose step dies named is REAPED: its
   slots, pages and pending buffers are released
   (:meth:`~.engine.ServingEngine.hard_reclaim`) and its journal's
   unfinished entries (or, without a journal, the router's own records)
   are redelivered to READY peers under their original uids,
   token-exact. DRAINING replicas finish their work and admit nothing;
   :meth:`Router.healthz` aggregates the replicas' states. The fleet
   dies (:class:`FleetDead`) only when no decode-capable replica is
   left.

**Metrics.** :meth:`Router.merged_metrics` sums the replicas' counters
and subtracts the replayed prefixes of redelivered requests
(``redelivery_replayed_tokens``: the dead replica counted them and the
peer counts them again), so the fleet's ``tokens_generated`` is the
number of tokens its clients received.

Placement, stealing and reaping decide from host state that the engines'
token streams determine; with one process and one card per fleet no
decision needs another rank.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..runtime import heal
from ..runtime import scope as graftscope
from ..runtime.faults import DeadlineExceeded, GraftFaultError
from .replica import PageTransfer, ServingReplica
from .scheduler import DONE, FAILED, QueueFull, Request

__all__ = ["Router", "PrefixCacheDirectory", "FleetSaturated",
           "FleetDead"]


class FleetSaturated(QueueFull):
    """Every admittable replica is at its admission window AND the
    router's own hold queue is at its bound — the fleet-level
    backpressure signal. A ``QueueFull`` subclass: callers' existing
    shed/retry handling (``submit_retrying``-style step-and-retry)
    applies unchanged, one level up."""


class FleetDead(GraftFaultError):
    """No decode-capable replica remains alive: the fleet cannot make
    progress. Named-fatal — a supervisor's restart budget consumes it
    like any engine fatal, rebuilding the fleet and replaying the
    per-replica journals."""


class PrefixCacheDirectory:
    """Fleet-level index: WHICH replica holds cached pages for a
    prompt prefix. Keyed identically to
    :class:`~.kv_pages.PrefixCache` — page-aligned token-tuple
    prefixes, hash-routed and token-verified, walked longest-first —
    so a directory hit is exactly the lookup the target replica's own
    cache will re-run at admission. Advisory by construction: the
    replica's cache is the authority (LRU eviction there makes a
    directory entry stale, and a stale hit simply admits as a miss);
    the directory only has to be RIGHT OFTEN to earn its TTFT win,
    never right always for correctness."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        # (n_pages, hash(prefix)) -> (prefix tokens, rid) — the same
        # two-level shape as PrefixCache._by_prefix, with the replica
        # id in place of the page entry
        self._by_prefix: Dict[Tuple[int, int],
                              Tuple[Tuple[int, ...], str]] = {}
        self._full: Dict[int, Tuple[Tuple[int, ...], str]] = {}
        self._max_full = 0
        self._hits: Dict[int, int] = {}  # full-prompt hit counts

    def __len__(self) -> int:
        return len(self._full) + len(self._by_prefix)

    @staticmethod
    def _key(tokens: Sequence[int]) -> int:
        return hash(tuple(tokens))

    def register(self, prompt: Sequence[int], rid: str) -> None:
        """Record that ``rid`` (is about to) hold ``prompt``'s
        page-aligned prefix pages — called at placement time on
        replicas with an armed engine-level prefix cache. First
        registration wins per key (matching ``PrefixCache.register``'s
        ``setdefault`` discipline): the first holder stays the routing
        target until it is dropped."""
        tokens = tuple(int(t) for t in prompt)
        ps = self.page_size
        n_full = len(tokens) // ps
        if n_full < 1:
            return
        for k in range(1, n_full + 1):
            self._by_prefix.setdefault(
                (k, self._key(tokens[:k * ps])),
                (tokens[:k * ps], rid))
        self._full.setdefault(self._key(tokens), (tokens, rid))
        self._max_full = max(self._max_full, n_full)

    def lookup(self, prompt: Sequence[int]) -> Optional[str]:
        """The replica holding the longest registered prefix of
        ``prompt`` (full-prompt entries first), or None. Hash routes,
        token comparison verifies — identical to the engine cache's
        lookup discipline."""
        tokens = tuple(int(t) for t in prompt)
        key = self._key(tokens)
        hit = self._full.get(key)
        if hit is not None and hit[0] == tokens:
            self._hits[key] = self._hits.get(key, 0) + 1
            return hit[1]
        ps = self.page_size
        for k in range(min(len(tokens) // ps, self._max_full), 0, -1):
            hit = self._by_prefix.get((k, self._key(tokens[:k * ps])))
            if hit is not None and hit[0] == tokens[:k * ps]:
                return hit[1]
        return None

    def drop_replica(self, rid: str) -> None:
        """Forget every entry pointing at ``rid`` (reaped/drained
        replica: its pages are gone — routing to it would be worse
        than a miss)."""
        self._by_prefix = {k: v for k, v in self._by_prefix.items()
                           if v[1] != rid}
        self._full = {k: v for k, v in self._full.items()
                      if v[1] != rid}
        self._max_full = max(
            (k for k, _h in self._by_prefix), default=0)
        self._hits = {k: v for k, v in self._hits.items()
                      if k in self._full}

    def hot_prompts(self, n: int) -> List[Tuple[int, ...]]:
        """The up-to-``n`` hottest full prompts held anywhere in the
        fleet (routing hit count, longest first as the tiebreak):
        the PREWARM set for a joining decode replica — replaying
        them through its engine populates its own prefix cache
        before the router admits traffic to it, so its first client
        request pays a warm TTFT."""
        if n <= 0:
            return []
        ranked = sorted(
            self._full.values(),
            key=lambda tv: (self._hits.get(self._key(tv[0]), 0),
                            len(tv[0])),
            reverse=True)
        return [tokens for tokens, _rid in ranked[:n]]


class Router:
    """Front N :class:`~.replica.ServingReplica` handles as one
    engine-shaped service: ``submit`` / ``step`` / ``run`` / ``serve``
    / ``begin_drain`` / ``drain`` mirror :class:`~.engine
    .ServingEngine`'s verbs, so the CLI and benches drive a fleet the
    way they drive one engine.

    Args:
      replicas: the handles. At least one decode-capable
        (``role in ("both", "decode")``) replica is required; prefill
        replicas additionally require a decode replica to hand to.
      max_pending: bound on the router's own hold queue (requests no
        replica would admit right now). Beyond it ``submit`` raises
        :class:`FleetSaturated`. None = unbounded holding.
      steal: arm cross-replica work stealing (default True).
      store / run_uid: optional control-plane store — the router
        publishes each replica's ``{role, state, address}`` under
        ``fleet/<run_uid>/replica/<rid>``
        (:func:`~..runtime.fleet.publish_replica`), the discovery
        seam a REMOTE router bootstraps from
        (:func:`~..runtime.fleet.replica_directory`).
    """

    def __init__(self, replicas: Sequence[ServingReplica], *,
                 max_pending: Optional[int] = None, steal: bool = True,
                 store=None, run_uid: str = "run"):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        rids = [r.rid for r in replicas]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate replica ids: {rids}")
        self.replicas: List[ServingReplica] = list(replicas)
        self._by_rid = {r.rid: r for r in self.replicas}
        if not any(r.decode_capable for r in self.replicas):
            raise ValueError(
                "no decode-capable replica (role 'both' or 'decode') "
                "— a prefill-only fleet can never emit a token")
        self.max_pending = (None if max_pending is None
                            else int(max_pending))
        self.steal = bool(steal)
        self.store = store
        self.run_uid = str(run_uid)
        # fleet prefix directory: keyed off the first decode-capable
        # replica with an armed engine prefix cache (one page size per
        # fleet — mixed page sizes would split the key space)
        self._directory: Optional[PrefixCacheDirectory] = None
        for r in self.replicas:
            if (r.decode_capable
                    and getattr(r.engine, "_prefix_cache", None)
                    is not None):
                self._directory = PrefixCacheDirectory(
                    r.engine.pool.page_size)
                break
        self._pending: Deque[Request] = deque()
        self._transfers: Deque[PageTransfer] = deque()
        # client-visible records, LATEST incarnation per uid (a
        # redelivered request appends a fresh Request under the same
        # uid; serve()/records() report the terminal one)
        self._records: Dict[object, Request] = {}
        self._assigned: Dict[object, str] = {}
        # fleet counters (the merge's dedup inputs)
        self.requests_redelivered = 0
        self.redelivery_replayed_tokens = 0
        self.redelivery_replayed_decode_tokens = 0
        self.redelivered_uids: List = []  # bench: recovery TTFT join
        self.prefix_routed = 0
        self.steals = 0
        self.transfers_routed = 0
        self.transfer_bytes = 0  # host-round-trip KV block payload
        # graftlink attribution: prefill-finish → decode-splice wall
        # time per placed transfer (the handoff the pipelined wire
        # takes off the TTFT critical path) — bench-join material
        self.transfer_handoff_s: List[float] = []
        self.requests_shed_fleet = 0
        self._draining = False
        # graftscale: counters of replicas REMOVED from the fleet
        # (drained + retired by the autoscaler / a rolling rollout) —
        # folded into merged_metrics so scale-down never makes fleet
        # totals go backwards
        self._retired_totals: Dict[str, float] = {}
        self._retired_prewarm_tokens = 0
        self._retired_prewarm_requests = 0
        self.replicas_retired = 0
        for r in self.replicas:
            self._publish(r)

    # ---- store-published replica directory ----------------------------
    def _publish(self, replica: ServingReplica) -> None:
        if self.store is None:
            return
        from ..runtime import fleet as graftfleet

        graftfleet.publish_replica(
            self.store, replica.rid,
            role=replica.role,
            state=replica.engine.health.state,
            address=replica.address,
            run_uid=self.run_uid)

    def _unpublish(self, replica: ServingReplica) -> None:
        if self.store is None:
            return
        from ..runtime import fleet as graftfleet

        graftfleet.unpublish_replica(self.store, replica.rid,
                                     run_uid=self.run_uid)

    # ---- graftscale: runtime membership -------------------------------
    def add_replica(self, replica: ServingReplica) -> None:
        """Join one replica to a LIVE fleet (graftscale scale-up /
        rollout join): registered for placement immediately and
        published to the store directory. The caller prewarms first
        (:meth:`~.replica.ServingReplica.prewarm`) — by the time the
        router sees the handle, its caches are hot."""
        if replica.rid in self._by_rid:
            raise ValueError(
                f"duplicate replica id {replica.rid!r}: already in "
                "the fleet")
        self.replicas.append(replica)
        self._by_rid[replica.rid] = replica
        if (self._directory is None and replica.decode_capable
                and getattr(replica.engine, "_prefix_cache", None)
                is not None):
            self._directory = PrefixCacheDirectory(
                replica.engine.pool.page_size)
        self._publish(replica)
        graftscope.emit("scale.join", cat="serving", rid=replica.rid,
                        role=replica.role,
                        replicas=len(self.replicas))

    def remove_replica(self, rid: str) -> ServingReplica:
        """Retire one DEAD (drained or reaped) replica from the fleet
        (graftscale scale-down / rollout takeover): its counters fold
        into the retired totals so the fleet merge never goes
        backwards, its directory entries drop, and its store record
        is deleted. Removing a live replica is a caller bug — drain
        it first (``begin_drain`` + step to empty)."""
        replica = self._by_rid.get(rid)
        if replica is None:
            raise ValueError(f"unknown replica id {rid!r}")
        if not (replica.dead or replica.reaped):
            raise ValueError(
                f"replica {rid!r} is {replica.engine.health.state!r} "
                "with work possibly in flight — drain it before "
                "removing it from the fleet")
        snap = replica.engine.metrics.snapshot()
        for key in self._SUM_KEYS:
            if key in snap:
                self._retired_totals[key] = (
                    self._retired_totals.get(key, 0) + snap[key])
        self._retired_prewarm_tokens += replica.prewarm_tokens
        self._retired_prewarm_requests += replica.prewarm_requests
        self.replicas_retired += 1
        if self._directory is not None:
            self._directory.drop_replica(rid)
        del self._by_rid[rid]
        self.replicas.remove(replica)
        self._unpublish(replica)
        graftscope.emit("scale.retire", cat="serving", rid=rid,
                        replicas=len(self.replicas))
        return replica

    # ---- placement ----------------------------------------------------
    def _alive(self) -> List[ServingReplica]:
        return [r for r in self.replicas if not r.dead and not r.reaped]

    def _decode_replicas(self) -> List[ServingReplica]:
        return [r for r in self._alive() if r.decode_capable]

    def _prefill_replicas(self) -> List[ServingReplica]:
        return [r for r in self._alive() if r.role == "prefill"
                and r.engine.health.ready]

    def _place(self, request: Request) -> Optional[ServingReplica]:
        """Choose a decode-capable replica for an ordinary admission:
        directory prefix hit first (when that replica currently
        admits), else least-loaded admittable."""
        if self._directory is not None:
            rid = self._directory.lookup(request.prompt)
            if rid is not None:
                hit = self._by_rid.get(rid)
                if (hit is not None and hit.decode_capable
                        and hit.admittable()):
                    self.prefix_routed += 1
                    graftscope.emit("route.prefix_hit", cat="serving",
                                    req=request.uid, rid=rid)
                    return hit
        cands = [r for r in self._decode_replicas() if r.admittable()]
        if not cands:
            return None
        return min(cands, key=lambda r: r.load())

    def _note_directory(self, request: Request,
                        replica: ServingReplica) -> None:
        """Register the placement in the fleet directory when the
        target engine will cache the prefix (paged + armed prefix
        cache + greedy)."""
        if (self._directory is not None
                and getattr(replica.engine, "_prefix_cache", None)
                is not None):
            self._directory.register(request.prompt, replica.rid)

    def _try_enqueue(self, request: Request,
                     replica: ServingReplica) -> bool:
        try:
            replica.enqueue(request)
        except QueueFull:
            replica.note_pressure()
            return False
        self._assigned[request.uid] = replica.rid
        self._note_directory(request, replica)
        return True

    def _transfer_backlog_full(self) -> bool:
        """Decode-side backpressure reaching the prefill side: once
        the transfer queue holds as much work as every decode
        replica's admission window combined, feeding more prompts
        into prefill only grows an unbounded host-resident KV backlog
        — hold at the router instead."""
        decode = self._decode_replicas()
        if not decode:
            return True
        return len(self._transfers) >= sum(r.window for r in decode)

    def _dispatch_request(self, request: Request) -> bool:
        """Route one request to a replica (prefill intake when the
        fleet is disaggregated, else a decode-capable engine).
        False = nobody admits right now (caller holds it)."""
        prefill = self._prefill_replicas()
        if prefill:
            if self._transfer_backlog_full():
                return False
            cands = [r for r in prefill if r.in_flight < r.window]
            if not cands:
                return False
            target = min(cands, key=lambda r: r.load())
            try:
                target.submit_prefill(request)
            except QueueFull:
                target.note_pressure()
                return False
            self._assigned[request.uid] = target.rid
            return True
        replica = self._place(request)
        while replica is not None:
            if self._try_enqueue(request, replica):
                return True
            cands = [r for r in self._decode_replicas()
                     if r.admittable() and r is not replica]
            replica = (min(cands, key=lambda r: r.load())
                       if cands else None)
        return False

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: Optional[int] = None, uid=None,
               deadline_s: Optional[float] = None) -> Request:
        """Fleet admission: place now if some replica admits, HOLD in
        the router's bounded pending queue otherwise. Raises
        :class:`FleetSaturated` past ``max_pending`` and
        ``ValueError`` for never-fits requests (validated against the
        first decode replica's static capacity — a homogeneous fleet
        is assumed, like any replicated service)."""
        if self._draining:
            self.requests_shed_fleet += 1
            raise QueueFull("fleet draining: admission closed")
        decode = self._decode_replicas()
        if not decode:
            raise FleetDead(
                "every decode-capable replica is dead; the fleet "
                "cannot accept work (supervisor restart territory)")
        default_eos = decode[0].engine.eos_id
        request = Request(prompt, max_new_tokens,
                          default_eos if eos_id is None else eos_id,
                          uid, deadline_s=deadline_s)
        request.submit_time = time.perf_counter()
        # never-fits is a submission error fleet-wide, not a hold
        s_max = min(r.engine.pool.s_max for r in decode)
        if len(request.prompt) < 1:
            raise ValueError("empty prompt")
        if len(request.prompt) + request.max_new_tokens > s_max:
            raise ValueError(
                f"prompt {len(request.prompt)} + max_new_tokens "
                f"{request.max_new_tokens} exceeds the fleet slot "
                f"capacity s_max={s_max}")
        self._records[request.uid] = request
        try:
            placed = self._dispatch_request(request)
        except ValueError:
            # engine-level validation (vocab range, paged page-count
            # never-fits) is a SUBMISSION error like the s_max check
            # above — surface it to the submitter, not a held request
            del self._records[request.uid]
            self._assigned.pop(request.uid, None)
            raise
        if not placed:
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self.requests_shed_fleet += 1
                del self._records[request.uid]
                graftscope.emit("route.shed", cat="serving",
                                req=request.uid)
                raise FleetSaturated(
                    f"every replica is at its admission window and "
                    f"the router holds {len(self._pending)} "
                    f"request(s) (max_pending={self.max_pending}); "
                    "retry after a step")
            self._pending.append(request)
            graftscope.emit("route.held", cat="serving",
                            req=request.uid,
                            pending=len(self._pending))
        return request

    # ---- drive --------------------------------------------------------
    def _drain_pending(self) -> None:
        n = len(self._pending)
        for _ in range(n):
            request = self._pending.popleft()
            try:
                placed = self._dispatch_request(request)
            except ValueError as e:
                # a HELD request failing engine-level validation
                # (vocab range, paged never-fits on the replica it
                # finally reached) has no submitter on the stack to
                # raise to: fail it named instead of crashing the
                # fleet step and silently dropping it
                request.state = FAILED
                request.finish_reason = "error"
                request.error = e
                request.finish_time = time.perf_counter()
                self._assigned.pop(request.uid, None)
                graftscope.emit("request.failed", cat="request",
                                req=request.uid, error="ValueError",
                                where="fleet_place")
                continue
            if not placed:
                self._pending.append(request)

    def _place_transfers(self,
                         events: List[Tuple[Request, int, bool]]
                         ) -> None:
        """Splice finished prefills into decode replicas; a transfer
        nobody admits stays queued (the fleet-level hold — the decode
        side's backpressure reaches the prefill side as a growing
        transfer queue)."""
        n = len(self._transfers)
        for _ in range(n):
            transfer = self._transfers.popleft()
            cands = [r for r in self._decode_replicas()
                     if r.admittable()]
            placed = False
            for replica in sorted(cands, key=lambda r: r.load()):
                try:
                    evs = replica.engine.admit_prefilled(
                        transfer.request, transfer.tok0,
                        transfer.k_block, transfer.v_block,
                        k_scale=transfer.k_scale,
                        v_scale=transfer.v_scale)
                except QueueFull:
                    replica.note_pressure()
                    continue
                except ValueError as e:
                    # never-fits on THIS pool geometry: a permanent
                    # request error, not replica damage — fail it
                    # named and drop the transfer
                    transfer.request.state = FAILED
                    transfer.request.finish_reason = "error"
                    transfer.request.error = e
                    transfer.request.finish_time = time.perf_counter()
                    graftscope.emit("request.failed", cat="request",
                                    req=transfer.request.uid,
                                    error="ValueError",
                                    where="fleet_splice")
                    transfer.release()  # dropped: loans go back
                    placed = True
                    break
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:
                    # replica-fatal mid-splice (poisoned insert,
                    # injected fatal): absorb it like a fatal step —
                    # requeue the transfer FIRST so the reap's
                    # held-uid rule skips this uid (it redelivers
                    # through the requeued transfer, exactly once),
                    # then reap the replica
                    graftscope.emit("route.replica_fatal",
                                    cat="fault", rid=replica.rid,
                                    error=type(e).__name__)
                    if not replica.engine.health.dead:
                        replica.engine.health.to_dead(
                            type(e).__name__)
                    self._transfers.append(transfer)
                    self._reap(replica, events)
                    placed = True
                    break
                self._assigned[transfer.request.uid] = replica.rid
                self._note_directory(transfer.request, replica)
                self.transfers_routed += 1
                self.transfer_bytes += transfer.nbytes
                handoff_s = time.perf_counter() - transfer.born
                if len(self.transfer_handoff_s) < 200_000:
                    self.transfer_handoff_s.append(handoff_s)
                graftscope.emit("route.splice", cat="serving",
                                req=transfer.request.uid,
                                rid=replica.rid,
                                handoff_s=handoff_s,
                                resident=transfer.resident,
                                nbytes=transfer.nbytes)
                events.extend(evs)
                transfer.consumed()  # spliced: ownership moved into
                # the decode cache (NOT release() — the pool may have
                # re-loaned these arrays already; see PageTransfer)
                placed = True
                break
            if not placed:
                self._transfers.append(transfer)

    def _reap(self, replica: ServingReplica,
              events: List[Tuple[Request, int, bool]]) -> None:
        """A replica died: redeliver its unfinished requests to READY
        peers under their ORIGINAL uids (journal-authoritative;
        reconstructed from the router's own records when no journal
        exists), re-place its un-prefilled intake, and drop its
        directory entries. Peers regenerate the journaled prefix
        token-exact (greedy determinism — the journal verifies)."""
        replica.reaped = True
        graftscope.emit("route.replica_dead", cat="fault",
                        rid=replica.rid,
                        reason=replica.engine.health.reason)
        if self._directory is not None:
            self._directory.drop_replica(replica.rid)
        # drop the store record at the reap (not a dead-state
        # re-publish): a replica that died mid-drain would otherwise
        # sit in the directory until the TTL filter aged it out — and
        # forever for readers that pass no ttl_s. replica_directory
        # never returns a reaped rid (test-pinned).
        self._unpublish(replica)
        # the OS reclaims a SIGKILLed process's memory; the in-process
        # analogue must be explicit — free the dead engine's slots,
        # pages and prep buffers (hbm gauges and the ownership ledger
        # both account them) without touching request state, which the
        # redelivery below now owns. Best-effort: a REMOTE dead engine
        # is unreachable and its real process teardown already freed
        # everything.
        reclaim = getattr(replica.engine, "hard_reclaim", None)
        if reclaim is not None:
            try:
                reclaim()
            except Exception as e:
                graftscope.emit("route.reap_reclaim_failed",
                                cat="fault", rid=replica.rid,
                                error=type(e).__name__)
        # un-prefilled intake: no tokens yet, a plain re-route is exact
        for request in replica.withdraw_prefill():
            if not self._dispatch_request(request):
                self._pending.append(request)
        entries = None
        if replica.journal is not None:
            entries = replica.journal.unfinished()
        else:
            entries = []
            for uid, rid in self._assigned.items():
                if rid != replica.rid:
                    continue
                record = self._records.get(uid)
                if record is None or record.state in (DONE, FAILED):
                    continue
                entry = heal.JournalEntry(uid, record.prompt,
                                          record.max_new_tokens,
                                          record.eos_id)
                entry.tokens = list(record.tokens)
                entries.append(entry)
        # a uid the router still HOLDS (pending after a failed
        # re-route above, or riding a PageTransfer the dead prefill
        # replica produced) will be delivered by that path — also
        # redelivering it here would run the request twice under one
        # uid and double-count its tokens
        held = {r.uid for r in self._pending}
        held.update(t.request.uid for t in self._transfers)
        entries = [e for e in entries if e.uid not in held]
        if not entries:
            return
        peers = [r for r in self._decode_replicas()
                 if r.engine.health.ready]
        if not peers:
            raise FleetDead(
                f"replica {replica.rid} died with "
                f"{len(entries)} unfinished request(s) and no READY "
                "decode-capable peer remains to redeliver to")
        for i, entry in enumerate(entries):
            peer = min(peers, key=lambda r: r.load())
            redelivered = peer.engine.redeliver([entry],
                                                events_out=events)
            for request in redelivered:
                self._records[request.uid] = request
                self._assigned[request.uid] = peer.rid
            self.requests_redelivered += 1
            self.redelivered_uids.append(entry.uid)
            replayed = len(entry.tokens)
            self.redelivery_replayed_tokens += replayed
            self.redelivery_replayed_decode_tokens += max(
                0, replayed - 1)
            if replica.journal is not None:
                # ownership moved: record the handoff on the dead
                # replica's WAL too, so a restart over it never
                # re-runs a uid the peer now owns. Best-effort — a
                # real SIGKILL never reaches this line for that
                # journal, and a failing disk just leaves today's
                # crash shape (the peer's own WAL is authoritative
                # either way: Router.recover dedups cross-WAL).
                try:
                    replica.journal.record_handoff(
                        entry, to=peer.rid)
                except Exception as e:
                    graftscope.emit("route.reap_handoff_failed",
                                    cat="fault", rid=replica.rid,
                                    req=entry.uid,
                                    error=type(e).__name__)
        graftscope.emit("route.redelivered", cat="fault",
                        rid=replica.rid, requests=len(entries),
                        replayed_tokens=self.redelivery_replayed_tokens)
        # nothing writes the dead WAL after the reap: close it
        # (compacted — handed-off uids drop, router-held uids stay
        # unfinished for their own delivery path). Releases the open
        # file handle the drain audit would otherwise name leaked.
        # Best-effort like the handoffs: a remote journal proxy has
        # no local handle to close.
        close = getattr(replica.journal, "close", None)
        if close is not None:
            try:
                close()
            except Exception as e:
                graftscope.emit("route.reap_wal_close_failed",
                                cat="fault", rid=replica.rid,
                                error=type(e).__name__)

    def _steal(self) -> None:
        """Cross-replica work stealing: a READY replica with an empty
        queue and a free slot takes the queue TAIL of the most
        backlogged peer (depth >= 2 — stealing a lone queued request
        buys nothing the next admission wouldn't)."""
        ready = [r for r in self._decode_replicas()
                 if r.engine.health.ready]
        idle = [r for r in ready
                if r.engine.scheduler.queue_depth == 0
                and r.engine.pool.free_slots > 0 and r.admittable()]
        if not idle:
            return
        busy = [r for r in ready
                if r.engine.scheduler.queue_depth >= 2]
        if not busy:
            return
        victim = max(busy,
                     key=lambda r: r.engine.scheduler.queue_depth)
        thief = min(idle, key=lambda r: r.load())
        if victim is thief:
            return
        for request in victim.engine.withdraw_queued(1):
            if self._try_enqueue(request, thief):
                # journal the handoff on the VICTIM only now that the
                # thief owns the uid (a refused theft requeues below
                # with its WAL entry still live — no redelivery gap)
                if victim.journal is not None:
                    victim.journal.record_handoff(request,
                                                  to=thief.rid)
                self.steals += 1
                graftscope.emit("route.steal", cat="serving",
                                req=request.uid, frm=victim.rid,
                                to=thief.rid)
            else:
                # thief refused after all: back on the victim (tail —
                # where it came from); never drop a request on theft
                victim.engine.scheduler.requeue_tail(request)

    def step(self) -> List[Tuple[Request, int, bool]]:
        """One fleet iteration: reap dead replicas (redelivering),
        drain held admissions, advance prefill replicas (one prompt
        each), place finished transfers, step every decode-capable
        replica inside the fatal trap, adapt admission windows, and
        steal work for drained replicas. Returns the iteration's
        token events exactly like ``ServingEngine.step`` —
        ``(request, token, finished)``."""
        events: List[Tuple[Request, int, bool]] = []
        for replica in self.replicas:
            if replica.dead and not replica.reaped:
                self._reap(replica, events)
        self._drain_pending()
        for replica in self._prefill_replicas():
            try:
                transfer = replica.prefill_step()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                # replica-fatal: absorbed by re-placement (the death
                # is on the bus; the engine already flight-dumped)
                graftscope.emit("route.replica_fatal", cat="fault",
                                rid=replica.rid,
                                error=type(e).__name__)
                self._reap(replica, events)
                continue
            if transfer is not None:
                self._transfers.append(transfer)
        self._place_transfers(events)
        # graftlink: two-phase decode fan-out. Submit every replica's
        # step first (a pipelined remote puts the frame on the wire
        # and returns a completion handle; in-process and blocking
        # replicas return None and step in the collect phase), then
        # collect in replica order. Exact because per-stream tokens
        # are invariant under admission timing and batch composition
        # (the per-slot decode-independence pin) — overlapping N
        # remote steps changes wall time, never token streams.
        handles: Dict[str, object] = {}
        decode = [r for r in self._decode_replicas()
                  if not r.engine.health.dead]
        for replica in decode:
            try:
                handles[replica.rid] = replica.step_submit()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                # submit-side fatal (wire dead on send): same absorb
                # as a fatal step — the collect phase must not run
                graftscope.emit("route.replica_fatal", cat="fault",
                                rid=replica.rid,
                                error=type(e).__name__)
                self._reap(replica, events)
                handles[replica.rid] = False  # sentinel: reaped
        for replica in decode:
            handle = handles.get(replica.rid)
            if handle is False or replica.engine.health.dead:
                continue
            try:
                events.extend(replica.step_complete(handle))
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                # the engine already flight-dumped and flipped DEAD in
                # step(); the fleet absorbs the death by redelivery
                graftscope.emit("route.replica_fatal", cat="fault",
                                rid=replica.rid,
                                error=type(e).__name__)
                self._reap(replica, events)
                continue
            replica.poll_pressure()
        if self.steal and not self._draining:
            self._steal()
        if not self._decode_replicas():
            raise FleetDead(
                "every decode-capable replica is dead; the fleet "
                "cannot make progress (supervisor restart territory)")
        return events

    @property
    def draining(self) -> bool:
        """True once :meth:`begin_drain` ran (SIGTERM or explicit):
        fleet admission is closed for good this incarnation."""
        return self._draining

    @property
    def in_flight(self) -> int:
        """Work anywhere in the fleet: router-held + transfers in
        flight + every live replica's own in-flight."""
        return (len(self._pending) + len(self._transfers)
                + sum(r.in_flight for r in self._alive()))

    # ---- graftscale: the autoscaler's input signals --------------------
    @property
    def pending_depth(self) -> int:
        """Requests the router holds because no replica admits — the
        saturation signal the autoscaler (and /snapshot.json) reads."""
        return len(self._pending)

    @property
    def transfer_depth(self) -> int:
        """Finished prefills waiting for a decode replica to admit
        them — the prefill→decode role-imbalance signal."""
        return len(self._transfers)

    @property
    def transfer_backlog_full(self) -> bool:
        """Decode-side backpressure visible to a scaler: the transfer
        queue holds at least the decode replicas' combined admission
        windows (the same predicate admission uses)."""
        return self._transfer_backlog_full()

    def run(self):
        """Drive :meth:`step` until the fleet drains, streaming token
        events."""
        while self.in_flight:
            yield from self.step()

    def serve(self, requests) -> List[Request]:
        """Batch API mirroring ``ServingEngine.serve``: submit
        ``(prompt, max_new_tokens)`` pairs (stepping through
        saturation), run to drain, and return the TERMINAL record per
        submission (a redelivered request's latest incarnation — by
        uid, last wins)."""
        submitted = []
        for prompt, max_new in requests:
            while True:
                try:
                    submitted.append(self.submit(prompt, max_new))
                    break
                except FleetSaturated:
                    self.step()
        for _ in self.run():
            pass
        return [self._records[r.uid] for r in submitted]

    # ---- graftheal: fleet drain + health ------------------------------
    def begin_drain(self, reason: str = "drain") -> None:
        """Flip every replica DRAINING (idempotent, signal-handler
        safe): fleet admission closes, in-flight work finishes through
        :meth:`drain`. ``install_drain_handler(router)`` wires
        SIGTERM here exactly as for one engine."""
        self._draining = True
        for replica in self._alive():
            if replica.decode_capable:
                replica.engine.begin_drain(reason)
            else:
                replica.engine.health.to_draining(reason)
            self._publish(replica)

    def drain(self, deadline_s: Optional[float] = None
              ) -> List[Tuple[Request, int, bool]]:
        """Finish everything in flight (admission closed), bounded by
        ``deadline_s`` per the engine drain contract; router-held
        requests that never placed are failed named at the deadline.
        Every replica lands DEAD with its journal compacted."""
        self.begin_drain("drain")
        t0 = time.perf_counter()
        events: List[Tuple[Request, int, bool]] = []
        # pre-admission work can never place once every replica is
        # DRAINING (nothing admits): pull prefill intake back to the
        # router now and fail it named below with the held queue —
        # the loop runs on REPLICA-resident work only, so an
        # unbounded (deadline_s=None) drain terminates even with
        # requests or transfers still held
        for replica in self._alive():
            if replica.role == "prefill":
                self._pending.extend(replica.withdraw_prefill())
        while any(r.in_flight for r in self._alive()):
            if (deadline_s is not None
                    and time.perf_counter() - t0 > deadline_s):
                break
            try:
                events.extend(self.step())
            except FleetDead:
                break
        for replica in self._alive():
            if replica.decode_capable:
                left = (None if deadline_s is None else
                        max(0.0, deadline_s
                            - (time.perf_counter() - t0)))
                events.extend(replica.engine.drain(left))
            else:
                replica.engine.health.to_dead("drained")
            self._publish(replica)
        for request in list(self._pending) + [
                t.request for t in self._transfers]:
            request.state = FAILED
            request.finish_reason = "drain"
            request.error = DeadlineExceeded(
                f"request {request.uid} still held by the router at "
                "the end of the fleet drain (admission closed before "
                "it placed): failed named, resubmit to another fleet")
            request.finish_time = time.perf_counter()
        for transfer in self._transfers:
            transfer.release()  # dropped at drain: loans go back
        self._pending.clear()
        self._transfers.clear()
        return events

    def healthz(self) -> Dict:
        """The fleet's aggregated /healthz payload: one fleet-level
        ``state``/``state_name`` (READY while ANY replica admits;
        DRAINING while some replica is still finishing; DEAD when
        nothing is) plus every replica's own health dict — the body a
        fleet-of-fleets router would consume, shaped exactly like one
        replica's answer."""
        reps = {r.rid: r.health() for r in self.replicas}
        states = [r.engine.health.state for r in self.replicas
                  if r.decode_capable]
        if any(s == heal.READY for s in states):
            state = heal.READY
        elif any(s in (heal.DRAINING, heal.STARTING) for s in states):
            state = heal.DRAINING
        else:
            state = heal.DEAD
        return {"state": state, "state_name": state.upper(),
                "replicas": reps,
                "pending": len(self._pending),
                "transfers": len(self._transfers)}

    # ---- fleet metrics (the dedup merge) ------------------------------
    _SUM_KEYS = (
        "requests_completed", "tokens_generated", "decode_tokens",
        "requests_failed", "requests_shed", "requests_redelivered",
        "decode_dispatches", "decode_host_syncs", "dispatch_retries",
        "watchdog_trips", "horizon_collapses", "prefix_hits",
        "prefix_partial_hits", "prefix_misses", "page_holds",
    )

    def merged_metrics(self) -> Dict:
        """Fleet-level metrics: per-replica counter sums with the
        redelivery dedup rule applied — ``tokens_generated`` /
        ``decode_tokens`` subtract the journaled replay prefixes
        (the dead replica counted them once, the redelivering peer
        counts them again; clients received them ONCE), so the fleet
        number equals unique delivered tokens. Per-replica snapshots
        (goodput_frac included) ride along under ``per_replica``."""
        merged: Dict[str, object] = {}
        per_replica: Dict[str, Dict] = {}
        # retired replicas (graftscale scale-down / rollout) folded
        # in first: fleet totals never go backwards on a removal
        totals: Dict[str, float] = dict(self._retired_totals)
        prewarm_tokens = self._retired_prewarm_tokens
        prewarm_requests = self._retired_prewarm_requests
        for replica in self.replicas:
            snap = replica.engine.metrics.snapshot()
            per_replica[replica.rid] = replica.snapshot()
            prewarm_tokens += replica.prewarm_tokens
            prewarm_requests += replica.prewarm_requests
            for key in self._SUM_KEYS:
                if key in snap:
                    totals[key] = totals.get(key, 0) + snap[key]
        merged.update(totals)
        # two dedup rules: the redelivery replay prefix (counted on
        # the dead replica AND the redelivering peer, delivered once)
        # and prewarm work (generated warming a joining replica,
        # delivered to no client at all)
        merged["tokens_generated"] = (
            int(totals.get("tokens_generated", 0))
            - self.redelivery_replayed_tokens - prewarm_tokens)
        merged["decode_tokens"] = (
            int(totals.get("decode_tokens", 0))
            - self.redelivery_replayed_decode_tokens)
        merged["requests_completed"] = (
            int(totals.get("requests_completed", 0))
            - prewarm_requests)
        merged["redelivery_replayed_tokens"] = \
            self.redelivery_replayed_tokens
        merged["fleet_requests_redelivered"] = self.requests_redelivered
        merged["fleet_prefix_routed"] = self.prefix_routed
        merged["fleet_steals"] = self.steals
        merged["fleet_transfers_routed"] = self.transfers_routed
        # JAX's key: a rollout's version-orphaned transfers (no rollout
        # here)
        merged["fleet_transfers_withdrawn"] = 0
        merged["fleet_transfer_bytes"] = self.transfer_bytes
        merged["fleet_requests_shed"] = self.requests_shed_fleet
        merged["fleet_replicas"] = len(self.replicas)
        merged["fleet_replicas_dead"] = sum(
            1 for r in self.replicas if r.dead or r.reaped)
        # graftscale inputs on the operator snapshot (satellite fix:
        # the autoscaler and an external scraper read the SAME
        # signals /snapshot.json shows): router-held depth, transfer
        # backlog, and every replica's live admission window
        merged["fleet_pending"] = len(self._pending)
        merged["fleet_transfers_pending"] = len(self._transfers)
        merged["fleet_admit_windows"] = {
            r.rid: r.window for r in self.replicas}
        merged["fleet_admit_window_total"] = sum(
            r.window for r in self._decode_replicas())
        merged["fleet_replicas_retired"] = self.replicas_retired
        merged["fleet_prewarm_tokens"] = prewarm_tokens
        merged["fleet_prewarm_requests"] = prewarm_requests
        merged["per_replica"] = per_replica
        return merged

    def recover(self, events_out: Optional[list] = None
                ) -> List[Request]:
        """Whole-fleet supervised-restart recovery: replay each
        replica's OWN journal — unfinished entries redeliver on the
        replica that owns the WAL, token-exact through the journal's
        replay-prefix verification. (Cross-replica redelivery is the
        reap path, with its live-counter dedup; here every engine is a
        fresh incarnation with fresh counters, so nothing
        double-counts.) Returns the redelivered records."""
        out: List[Request] = []
        seen: set = set()
        for replica in self._decode_replicas():
            if replica.journal is None:
                continue
            # cross-WAL dedup: a crash INSIDE the steal's handoff
            # window (thief's admit fsync'd, victim's handoff record
            # not yet) leaves one uid live in BOTH WALs — redeliver
            # it once (greedy determinism: either copy regenerates
            # the identical stream)
            entries = [e for e in replica.journal.unfinished()
                       if e.uid not in seen]
            if not entries:
                continue
            seen.update(e.uid for e in entries)
            redelivered = replica.engine.redeliver(
                entries, events_out=events_out)
            for request in redelivered:
                self._records[request.uid] = request
                self._assigned[request.uid] = replica.rid
            out.extend(redelivered)
        return out

    def known(self, uid) -> bool:
        """Is ``uid`` journaled ANYWHERE in the fleet (finished or
        not)? The CLI's re-submission dedup across whole-process
        restarts, fleet-wide."""
        return any(r.journal is not None and r.journal.known(uid)
                   for r in self.replicas)

    def records(self) -> Dict[object, Request]:
        """Latest client-visible record per uid (a redelivered
        request's newest incarnation wins, like serve_lm's by-uid
        timeline dedup)."""
        return dict(self._records)
