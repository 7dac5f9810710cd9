"""Elastic supervision: liveness, coordinated abort, supervised restart
and graceful drain (the port of the JAX package's ``runtime/heal.py``).

1. **Heartbeat liveness** over a control-plane store
   (:class:`~.store.TCPStore` or :class:`~.store.MemStore`): every rank
   publishes a monotonically increasing beat (:class:`Heartbeat`,
   bounded-retry writes at the ``heartbeat.write`` site); a pure,
   injectable-clock :class:`LivenessTracker` marks peers ``SUSPECT``
   after ``soft_timeout_s`` without a beat advance and ``DEAD`` after
   ``hard_timeout_s``. :class:`HeartbeatMonitor` combines both into the
   pre-collective gate (:meth:`HeartbeatMonitor.gate`) that
   :func:`..parallel.dist.gate_collectives` runs at every window
   boundary, so a dead peer is a named :class:`~.faults.PeerLostError`
   on every survivor instead of a hang inside NCCL.
2. **Coordinated abort**: on a DEAD peer (or a local fatal reported
   through :func:`post_poison`) a poison key is written to the store,
   and every rank's next gate raises the same ``PeerLostError(who,
   why)``.
3. **Supervised restart**: :class:`Supervisor` is the drive loop the
   CLIs wrap their run in (``--max_restarts N --restart_backoff S``):
   a named fatal (the :class:`~.faults.GraftFaultError` family) is
   caught, rendezvous re-run and the run re-invoked with ``--resume
   auto``, at most N times with doubling backoff; exhaustion raises
   :class:`RestartBudgetExhausted`. Every restart passes the
   ``heal.restart`` fault site.

Arming: one module global (:func:`arm`/:func:`disarm`/
:func:`active_monitor`); disarmed, the gate is one global read.

Env hook: ``PMDT_HEARTBEAT="soft:hard[:interval]"`` (seconds) arms a
monitor over the rendezvous store during ``PMDT_MASTER_ADDR`` bring-up
(:mod:`..parallel.dist`).

4. **Graceful drain** for serving: :class:`HealthState` is the
   forward-only machine ``STARTING -> READY -> DRAINING -> DEAD`` the
   serving engine carries, and :func:`healthz` its payload, which the
   HTTP server behind ``--stats_port`` serves (:mod:`.scope`,
   :mod:`.telemetry`).
   SIGTERM, through :func:`install_drain_handler` (which chains the
   previous handler), flips it to DRAINING: admission closes, in-flight
   requests finish up to the drain deadline, overdue ones fail named.
   The :class:`RequestJournal` (a JSON Lines WAL, one fsync'd batch a
   step, compacted through
   :func:`..train.checkpoint.write_atomic_durable`) records every
   admitted request and its emitted tokens, so a restarted engine
   redelivers the unfinished ones token-exact: the journaled prefix is
   verified as the greedy decode regenerates it, and a divergence is a
   named error, never a silent double delivery. Its files are
   byte-identical to the JAX journal's for the same operations.

As in the JAX module, a lost peer is a ``heal.peer_lost`` event and a
flight-recorder dump (:mod:`.scope`), every health transition a
``heal.health`` event, a supervised restart a ``heal.restart`` event
carrying its backoff, and the journal's file and admitted requests are
holds on the ownership ledger (:mod:`.life`).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import life
from . import scope as graftscope
from .faults import (GraftFaultError, PeerLostError, maybe_fault,
                     register_site, retry_with_backoff)

__all__ = [
    "ALIVE", "SUSPECT", "DEAD_PEER", "LivenessTracker", "Heartbeat",
    "HeartbeatMonitor", "post_poison", "check_poison", "clear_poison",
    "STARTING", "READY", "DRAINING", "DEAD", "HealthState", "healthz",
    "healthz_code",
    "Supervisor", "RestartBudgetExhausted", "JournalEntry",
    "RequestJournal", "load_journal_entries", "install_drain_handler",
    "restore_drain_handler", "arm", "disarm", "active_monitor",
    "monitor_from_env",
]

_SITE_HB_WRITE = register_site(
    "heartbeat.write",
    "one host's liveness beat published to the control-plane store "
    "(bounded-retry write)")
_SITE_HB_READ = register_site(
    "heartbeat.read",
    "peer-beat + poison-key fetch from the control-plane store (one "
    "poll of the liveness gate)")
_SITE_JOURNAL = register_site(
    "heal.journal_write",
    "request-journal WAL append (admit/token/done records the "
    "redelivery guarantee rests on)")
_SITE_RESTART = register_site(
    "heal.restart",
    "one supervised restart attempt (rendezvous re-run + target "
    "re-invocation after a named fatal)")


# ------------------------------------------------------------- liveness

ALIVE = "alive"
SUSPECT = "suspect"
DEAD_PEER = "dead"


class LivenessTracker:
    """Pure peer-liveness bookkeeping (no threads, no I/O, injectable
    clock). A peer is ALIVE while its beat keeps advancing, SUSPECT once
    ``soft_timeout_s`` passes without an advance, DEAD after
    ``hard_timeout_s``; a peer that never beat ages from construction."""

    def __init__(self, peers: Sequence[str], *, soft_timeout_s: float,
                 hard_timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if soft_timeout_s <= 0 or hard_timeout_s <= 0:
            raise ValueError("soft/hard timeouts must be > 0")
        if hard_timeout_s < soft_timeout_s:
            raise ValueError(
                f"hard_timeout_s {hard_timeout_s} < soft_timeout_s "
                f"{soft_timeout_s}")
        self.soft_timeout_s = float(soft_timeout_s)
        self.hard_timeout_s = float(hard_timeout_s)
        self._clock = clock
        now = clock()
        self._beats: Dict[str, Optional[int]] = {p: None for p in peers}
        self._advanced: Dict[str, float] = {p: now for p in peers}

    @property
    def peers(self) -> Tuple[str, ...]:
        return tuple(self._beats)

    def observe(self, peer: str, beat: Optional[int]) -> None:
        """Record one read of ``peer``'s beat (None = key absent); the
        clock resets only when the beat advances."""
        if peer not in self._beats:
            self._beats[peer] = None
            self._advanced[peer] = self._clock()
        if beat is not None and beat != self._beats[peer]:
            self._beats[peer] = beat
            self._advanced[peer] = self._clock()

    def age(self, peer: str) -> float:
        """Seconds since ``peer``'s beat last advanced."""
        return self._clock() - self._advanced[peer]

    def state(self, peer: str) -> str:
        age = self.age(peer)
        if age > self.hard_timeout_s:
            return DEAD_PEER
        if age > self.soft_timeout_s:
            return SUSPECT
        return ALIVE

    def states(self) -> Dict[str, str]:
        return {p: self.state(p) for p in self._beats}

    def ages(self) -> Dict[str, float]:
        return {p: self.age(p) for p in self._beats}

    def dead(self) -> List[str]:
        return [p for p in self._beats if self.state(p) == DEAD_PEER]

    def suspect(self) -> List[str]:
        return [p for p in self._beats if self.state(p) == SUSPECT]


def _beat_key(prefix: str, host: str) -> str:
    return f"{prefix}/beat/{host}"


def _poison_key(prefix: str) -> str:
    return f"{prefix}/poison"


class Heartbeat:
    """One rank's beat publisher: a monotone counter written to the
    store under bounded retry (the ``heartbeat.write`` site fires before
    the store op)."""

    def __init__(self, store, host: str, *, prefix: str = "heal",
                 retries: int = 3, backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.store = store
        self.host = str(host)
        self.prefix = prefix
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._sleep = sleep
        self.count = 0

    def beat(self) -> int:
        """Publish the next beat; returns its value. A persistent store
        failure propagates: a rank that cannot reach the store must
        look dead to its peers."""
        value = self.count + 1

        def once():
            maybe_fault(_SITE_HB_WRITE)
            self.store.set(_beat_key(self.prefix, self.host),
                           str(value).encode("ascii"))

        retry_with_backoff(once, attempts=self._retries,
                           base_delay_s=self._backoff_s,
                           sleep=self._sleep)
        self.count = value
        return value


def post_poison(store, who: str, why: str, *, by: str = "",
                prefix: str = "heal") -> None:
    """Write the coordinated-abort key; the first writer wins
    atomically (the claim is a store-side ``add``)."""
    if store.add(_poison_key(prefix) + "/claim", 1) != 1:
        return  # another rank already owns the verdict
    payload = json.dumps({"who": who, "why": why, "by": by},
                         sort_keys=True).encode("utf-8")
    store.set(_poison_key(prefix), payload)


def check_poison(store, prefix: str = "heal"
                 ) -> Optional[Dict[str, str]]:
    """Read the poison key: ``{"who", "why", "by"}`` or None."""
    raw = store.get(_poison_key(prefix))
    if not raw:
        return None
    try:
        return json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        # a torn poison key still means someone died
        return {"who": "<unknown>", "why": "corrupt poison key",
                "by": "<unknown>"}


def clear_poison(store, prefix: str = "heal") -> None:
    """Remove the poison key and its claim, so the next abort can be
    claimed again."""
    store.delete(_poison_key(prefix))
    store.delete(_poison_key(prefix) + "/claim")


class HeartbeatMonitor:
    """Heartbeat publisher, peer tracker and the pre-collective gate.

    Args:
      store: any ``set/get/add/delete`` store.
      host: this rank's name (its beat key).
      peers: every participant, this rank included (skipped when
        judging liveness).
      soft_timeout_s / hard_timeout_s: the tracker's thresholds.
      interval_s: least seconds between full gate polls; a call inside
        the window is one clock read.
      clock: injectable monotonic clock (tests).
    """

    def __init__(self, store, host: str, peers: Sequence[str], *,
                 soft_timeout_s: float, hard_timeout_s: float,
                 interval_s: float = 0.0, prefix: str = "heal",
                 clock: Callable[[], float] = time.monotonic,
                 retries: int = 3, backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.host = str(host)
        self.store = store
        self.prefix = prefix
        self.heartbeat = Heartbeat(store, host, prefix=prefix,
                                   retries=retries, backoff_s=backoff_s,
                                   sleep=sleep)
        self.tracker = LivenessTracker(
            [str(p) for p in peers if str(p) != str(host)],
            soft_timeout_s=soft_timeout_s,
            hard_timeout_s=hard_timeout_s, clock=clock)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last_poll = -float("inf")
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._sleep = sleep

    last_poison: Optional[Dict[str, str]] = None

    def poll(self) -> Dict[str, str]:
        """One liveness read (the ``heartbeat.read`` site, bounded
        retry): every peer's beat and the poison key into the tracker
        and :attr:`last_poison`; returns the peers' states."""
        def once():
            maybe_fault(_SITE_HB_READ)
            beats = {}
            for peer in self.tracker.peers:
                raw = self.store.get(_beat_key(self.prefix, peer))
                beats[peer] = int(raw) if raw else None
            return beats, check_poison(self.store, self.prefix)

        beats, poison = retry_with_backoff(
            once, attempts=self._retries, base_delay_s=self._backoff_s,
            sleep=self._sleep)
        for peer, beat in beats.items():
            self.tracker.observe(peer, beat)
        self.last_poison = poison
        return self.tracker.states()

    def _abort(self, who: str, why: str) -> None:
        """Poison the store (first writer wins), then raise named."""
        try:
            post_poison(self.store, who, why, by=self.host,
                        prefix=self.prefix)
        except OSError as e:
            # the store may be gone with the peer: still fail fast here
            print(f"graftheal: could not post poison for {who!r} "
                  f"({type(e).__name__}: {e}); aborting locally",
                  file=sys.stderr)
        graftscope.emit("heal.peer_lost", cat="fault", who=who, why=why)
        graftscope.flight_dump(f"PeerLostError: {who}: {why}")
        raise PeerLostError(who, why)

    def gate(self) -> None:
        """Publish this rank's beat, poll the peers and the poison key,
        and raise :class:`~.faults.PeerLostError` on a DEAD peer or a
        posted poison, before the caller enters a collective a dead
        peer would hang. Rate-limited by ``interval_s``."""
        now = self._clock()
        if now - self._last_poll < self.interval_s:
            return
        self._last_poll = now
        self.heartbeat.beat()
        self.poll()
        poison = self.last_poison
        if poison is not None:
            graftscope.emit("heal.peer_lost", cat="fault",
                            who=poison["who"], why=poison["why"],
                            via="poison")
            graftscope.flight_dump(
                f"PeerLostError (poisoned): {poison['who']}: "
                f"{poison['why']}")
            raise PeerLostError(poison["who"], poison["why"])
        dead = self.tracker.dead()
        if dead:
            who = dead[0]
            self._abort(
                who,
                f"no heartbeat for {self.tracker.age(who):.3g}s "
                f"(hard timeout {self.tracker.hard_timeout_s:.3g}s)")

    def snapshot(self) -> Dict:
        """Beat ages and states."""
        return {
            "host": self.host,
            "beat": self.heartbeat.count,
            "peer_states": self.tracker.states(),
            "last_beat_age_s": {p: round(a, 3)
                                for p, a in self.tracker.ages().items()},
        }


# ----------------------------------------------------- module-level arm

_MONITOR: Optional[HeartbeatMonitor] = None


def arm(monitor: HeartbeatMonitor,
        gate_collectives: bool = True) -> HeartbeatMonitor:
    """Arm a process-wide monitor; with ``gate_collectives`` its gate
    becomes :mod:`..parallel.dist`'s pre-collective gate."""
    global _MONITOR
    _MONITOR = monitor
    if gate_collectives:
        from ..parallel import dist

        dist.install_collective_gate(monitor.gate)
    return monitor


def disarm() -> None:
    global _MONITOR
    _MONITOR = None
    from ..parallel import dist

    dist.clear_collective_gate()


def active_monitor() -> Optional[HeartbeatMonitor]:
    return _MONITOR


def monitor_from_env(store, host: str, peers: Sequence[str]
                     ) -> Optional[HeartbeatMonitor]:
    """``PMDT_HEARTBEAT="soft:hard[:interval]"`` (seconds): an armed
    monitor over ``store``, or None when the variable is unset. ``hard``
    defaults to 3 x ``soft``, ``interval`` to ``soft / 4``."""
    spec = os.environ.get("PMDT_HEARTBEAT")
    if not spec:
        return None
    parts = [float(x) for x in spec.replace(",", ":").split(":")]
    soft = parts[0]
    hard = parts[1] if len(parts) > 1 else 3 * soft
    interval = parts[2] if len(parts) > 2 else soft / 4
    return arm(HeartbeatMonitor(
        store, host, peers, soft_timeout_s=soft, hard_timeout_s=hard,
        interval_s=interval))


# -------------------------------------------------------- health states

STARTING = "starting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"

_ORDER = {STARTING: 0, READY: 1, DRAINING: 2, DEAD: 3}


class HealthState:
    """The serving engine's health machine: ``STARTING -> READY ->
    DRAINING -> DEAD``, forward only (re-entering a state is a no-op and
    keeps its first reason; moving backward raises: a DEAD engine never
    advertises READY again). ``/healthz`` serves 200 only in READY."""

    def __init__(self):
        self.state = STARTING
        self.reason = "init"
        self.since = time.perf_counter()

    def _to(self, state: str, reason: str) -> None:
        if _ORDER[state] < _ORDER[self.state]:
            raise ValueError(
                f"health cannot move backward: {self.state} -> {state}")
        if state == self.state:
            return
        self.state = state
        self.reason = reason
        self.since = time.perf_counter()
        graftscope.emit("heal.health", cat="serving", state=state,
                        reason=reason)

    def to_ready(self, reason: str = "up") -> None:
        self._to(READY, reason)

    def to_draining(self, reason: str = "drain") -> None:
        self._to(DRAINING, reason)

    def to_dead(self, reason: str = "down") -> None:
        self._to(DEAD, reason)

    @property
    def ready(self) -> bool:
        return self.state == READY

    @property
    def draining(self) -> bool:
        return self.state == DRAINING

    @property
    def dead(self) -> bool:
        return self.state == DEAD

    def snapshot(self) -> Dict:
        """``state`` (lowercase, drives the HTTP code), ``state_name``
        (the UPPERCASE machine state a router keys on), the reason and
        the dwell time."""
        return {"state": self.state, "state_name": self.state.upper(),
                "reason": self.reason,
                "since_s": round(time.perf_counter() - self.since, 3)}


def healthz(health: Optional[HealthState],
            monitor: Optional[HeartbeatMonitor] = None) -> Dict:
    """The ``/healthz`` payload: the health machine's snapshot (a static
    READY without one) and, with a monitor armed, every peer's last-beat
    age. The HTTP code is 200 for ``state == "ready"``, else 503
    (:func:`healthz_code`)."""
    out = (health.snapshot() if health is not None
           else {"state": READY, "state_name": READY.upper(),
                 "reason": "static", "since_s": 0.0})
    if monitor is not None:
        out.update(monitor.snapshot())
    return out


def healthz_code(payload: Dict) -> int:
    """The HTTP status ``/healthz`` answers ``payload`` with: 200 while
    READY, 503 otherwise (the replica router's probe contract)."""
    return 200 if payload.get("state") == READY else 503


# --------------------------------------------------- supervised restart

class RestartBudgetExhausted(GraftFaultError):
    """The supervisor's restart budget ran out: the last named fatal is
    chained as ``__cause__`` and the message counts the restarts."""


class Supervisor:
    """Bounded restart-with-backoff drive loop for named fatals.

    Args:
      target: ``target(attempt)``, the run body; ``attempt`` is 0 on the
        first call and counts restarts after (the CLIs then resume with
        ``--resume auto``).
      max_restarts: restarts (not attempts) allowed; 0 = run once.
      backoff_s: first-restart delay, doubling per restart, capped at
        ``max_backoff_s``.
      rendezvous: hook run before each restart (tear down the process
        group so the run re-joins it).
      restartable: the exception classes that consume budget; anything
        else (a logic bug, ``SystemExit``, ``KeyboardInterrupt``)
        propagates at once. Default: the named-fatal family.
      sleep: injectable (tests never wait).
      name: the supervised body's label, in the exhaustion message.
    """

    def __init__(self, target: Callable[[int], object], *,
                 max_restarts: int = 2, backoff_s: float = 1.0,
                 max_backoff_s: float = 30.0,
                 rendezvous: Optional[Callable[[], None]] = None,
                 restartable: Tuple[type, ...] = (GraftFaultError,),
                 sleep: Callable[[float], None] = time.sleep,
                 name: str = ""):
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}")
        self.target = target
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.rendezvous = rendezvous
        self.restartable = restartable
        self.sleep = sleep
        self.name = str(name)
        self.restarts = 0  # restarts made

    def run(self):
        attempt = 0
        while True:
            try:
                if attempt:
                    # a fault here is a failed restart: named and
                    # budget-consuming
                    maybe_fault(_SITE_RESTART)
                    if self.rendezvous is not None:
                        self.rendezvous()
                return self.target(attempt)
            except (KeyboardInterrupt, SystemExit):
                raise  # a clean exit or an interrupt is not a fault
            except self.restartable as e:
                if isinstance(e, RestartBudgetExhausted):
                    raise
                if attempt >= self.max_restarts:
                    what = f" ({self.name})" if self.name else ""
                    raise RestartBudgetExhausted(
                        f"restart budget exhausted{what}: {attempt} "
                        f"restart(s) allowed and the run still died "
                        f"with {type(e).__name__}: {e}") from e
                attempt += 1
                self.restarts = attempt
                delay = min(self.backoff_s * (2 ** (attempt - 1)),
                            self.max_backoff_s)
                graftscope.emit("heal.restart", cat="fault",
                                attempt=attempt, of=self.max_restarts,
                                backoff_s=delay, who=self.name,
                                error=type(e).__name__)
                print(f"graftheal: restart {attempt}/{self.max_restarts} "
                      f"after {type(e).__name__}: {e} (backoff "
                      f"{delay:g}s)", file=sys.stderr, flush=True)
                if delay > 0:
                    self.sleep(delay)


# ----------------------------------------------------- request journal

class JournalEntry:
    """One journaled request: its identity and the tokens already
    emitted (the prefix a redelivery is verified against)."""

    __slots__ = ("uid", "prompt", "max_new_tokens", "eos_id", "tokens",
                 "done", "state", "reason", "emitted")

    def __init__(self, uid, prompt, max_new_tokens, eos_id):
        self.uid = uid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.tokens: List[int] = []
        self.done = False
        self.state = None
        self.reason = None
        # tokens seen from the current engine: positions below
        # len(tokens) are replay, beyond are new
        self.emitted = 0


def _apply_journal_record(entries: Dict, order: List, obj: Dict) -> None:
    """Fold one WAL record into ``(entries, order)``: the one copy of
    the replay rules, shared by the live journal and the loader."""
    op = obj.get("op")
    uid = obj.get("uid")
    if op == "admit":
        if uid not in entries:
            entries[uid] = JournalEntry(uid, obj["prompt"],
                                        obj["max_new_tokens"],
                                        obj.get("eos_id"))
            order.append(uid)
    elif op == "tok":
        entry = entries.get(uid)
        if entry is not None:
            entry.tokens.extend(int(t) for t in obj["tokens"])
    elif op == "done":
        entry = entries.get(uid)
        if entry is not None:
            entry.done = True
            entry.state = obj.get("state")
            entry.reason = obj.get("reason")


def _read_records(path: str, what: str):
    """The parsed records of a WAL, a torn line (the crash window of an
    append) reported on stderr and skipped, never fatal."""
    with open(path, "r", encoding="utf-8") as fh:
        lines = fh.read().split("\n")
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except ValueError:
            print(f"graftheal: journal {path!r} line {lineno} is torn "
                  f"(crashed mid-append); skipping it and {what} the "
                  "rest", file=sys.stderr)


def load_journal_entries(path: str) -> List[JournalEntry]:
    """A WAL's entries, read without opening it for append (the file is
    never changed); torn lines are skipped as on replay, and a missing
    or unreadable file is an empty journal."""
    entries: Dict[object, JournalEntry] = {}
    order: List[object] = []
    try:
        for obj in _read_records(path, "reading"):
            _apply_journal_record(entries, order, obj)
    except OSError:
        return []
    return [entries[u] for u in order]


class RequestJournal:
    """JSON Lines write-ahead log of admitted requests and their emitted
    tokens: the redelivery guarantee behind supervised restart.

    Records, one ``json.dumps(sort_keys=True)`` object a line:
      ``{"op": "admit", "uid", "prompt", "max_new_tokens", "eos_id"}``
      ``{"op": "tok", "uid", "tokens": [...]}``   (one batch a step)
      ``{"op": "done", "uid", "state", "reason"}``

    Each batch is written and flushed under bounded retry at the
    ``heal.journal_write`` site, then fsync'd after the lock is released
    (fsync covers the whole file, so a later batch's sync covers an
    earlier one); exhaustion raises a named ``GraftFaultError`` (a WAL
    that silently stopped recording would void the guarantee).
    :meth:`close` compacts through ``write_atomic_durable``: finished
    entries drop, so a cleanly drained engine leaves an empty file.
    Opening an existing path replays it first; a torn tail is reported
    and skipped, and newline-terminated before the first append.

    Greedy decode is deterministic, so a redelivered request regenerates
    the same stream: tokens inside the journaled prefix are verified and
    not written again, and a mismatch raises named (the engine rejects a
    journal with ``temperature > 0``)."""

    def __init__(self, path: str, *, retries: int = 3,
                 backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.path = path
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._sleep = sleep
        self._entries: Dict[object, JournalEntry] = {}
        self._order: List[object] = []
        self._mu = threading.Lock()
        if os.path.exists(path):
            for obj in _read_records(path, "replaying"):
                _apply_journal_record(self._entries, self._order, obj)
        self._fh = open(path, "a", encoding="utf-8")
        led = life.active_ledger()
        if led is not None:
            led.acquire("file", id(self._fh), obj=self._fh, holder=path,
                        depth=1)
        # a crash mid-append leaves the last line without its newline:
        # end it, or the next record would merge into the torn line
        if os.path.getsize(path) and not self._ends_with_newline():
            self._fh.write("\n")
            self._fh.flush()

    def _ends_with_newline(self) -> bool:
        with open(self.path, "rb") as fh:
            fh.seek(-1, os.SEEK_END)
            return fh.read(1) == b"\n"

    def known(self, uid) -> bool:
        """True when ``uid`` is journaled, finished or not (the drive
        loop's re-submission dedup across restarts)."""
        return uid in self._entries

    def unfinished(self) -> List[JournalEntry]:
        """Admitted but unfinished entries in admission order: what a
        restarted engine redelivers."""
        return [self._entries[u] for u in self._order
                if not self._entries[u].done]

    @property
    def entries(self) -> List[JournalEntry]:
        return [self._entries[u] for u in self._order]

    # ---- append path --------------------------------------------------
    def _append(self, ops: List[Dict]) -> None:
        if not ops:
            return
        payload = "".join(json.dumps(op, sort_keys=True) + "\n"
                          for op in ops)

        def once():
            maybe_fault(_SITE_JOURNAL)
            self._fh.write(payload)
            self._fh.flush()

        try:
            retry_with_backoff(once, attempts=self._retries,
                               base_delay_s=self._backoff_s,
                               sleep=self._sleep)
        except OSError as e:
            raise GraftFaultError(
                f"heal: journal append to {self.path!r} still failing "
                f"after {self._retries} attempt(s) "
                f"({type(e).__name__}: {e}) — a WAL that stops "
                "recording voids the redelivery guarantee, so this "
                "fails loudly") from e

    def _sync_durable(self) -> None:
        """fsync the file, outside the lock (a record_* call returns
        only after its batch is on disk)."""
        fh = self._fh
        if fh is None:
            return  # closed: the compaction is durable by itself

        def once():
            try:
                os.fsync(fh.fileno())
            except ValueError:
                return  # closed meanwhile, as above

        try:
            retry_with_backoff(once, attempts=self._retries,
                               base_delay_s=self._backoff_s,
                               sleep=self._sleep)
        except OSError as e:
            raise GraftFaultError(
                f"heal: journal sync of {self.path!r} still failing "
                f"after {self._retries} attempt(s) "
                f"({type(e).__name__}: {e}) — an unsynced WAL voids "
                "the redelivery guarantee, so this fails loudly") from e

    def record_admit(self, request) -> None:
        """Journal one admitted request; a uid already journaled (a
        redelivery) appends nothing."""
        with self._mu:
            if request.uid in self._entries:
                return
            entry = JournalEntry(request.uid, request.prompt,
                                 request.max_new_tokens, request.eos_id)
            self._entries[request.uid] = entry
            self._order.append(request.uid)
            self._append([{"op": "admit", "uid": request.uid,
                           "prompt": entry.prompt,
                           "max_new_tokens": entry.max_new_tokens,
                           "eos_id": entry.eos_id}])
        led = life.active_ledger()
        if led is not None:
            led.acquire("journal", (id(self), request.uid),
                        holder=request.uid)
        self._sync_durable()

    def note_events(self, events) -> None:
        """Journal one engine step's ``(request, token, finished)``
        events as one fsync'd batch. Tokens inside a redelivered
        request's journaled prefix are verified and not appended; a
        divergence raises named."""
        ops: List[Dict] = []
        fresh: Dict[object, List[int]] = {}
        settled: List[object] = []
        with self._mu:
            for request, token, finished in events:
                entry = self._entries.get(request.uid)
                if entry is None:
                    continue  # submitted before the journal attached
                idx = entry.emitted
                entry.emitted = idx + 1
                if idx < len(entry.tokens):
                    if entry.tokens[idx] != int(token):
                        raise GraftFaultError(
                            f"heal: journal replay diverged for "
                            f"request {request.uid} at token {idx}: "
                            f"journaled {entry.tokens[idx]} vs "
                            f"regenerated {int(token)} — redelivery "
                            "cannot be token-exact (params changed, "
                            "or a sampled engine was journaled)")
                else:
                    entry.tokens.append(int(token))
                    fresh.setdefault(request.uid, []).append(int(token))
                if finished:
                    if not entry.done:
                        settled.append(request.uid)
                    entry.done = True
                    entry.state = request.state
                    entry.reason = request.finish_reason
            for uid, toks in fresh.items():
                ops.append({"op": "tok", "uid": uid, "tokens": toks})
            for request, token, finished in events:
                if finished and request.uid in self._entries:
                    ops.append({"op": "done", "uid": request.uid,
                                "state": request.state,
                                "reason": request.finish_reason})
            self._append(ops)
        led = life.active_ledger()
        if led is not None:
            for uid in settled:
                led.release("journal", (id(self), uid))
        if ops:
            self._sync_durable()

    def record_handoff(self, request, to: str = "") -> None:
        """Journal a request leaving this engine for a peer (the fleet's
        work stealing, or its redelivery after a replica death):
        terminal here, with state ``"handoff"``, so a later restart of
        this engine never redelivers a request a peer now owns (the
        peer's own journal records the admission)."""
        with self._mu:
            entry = self._entries.get(request.uid)
            if entry is None or entry.done:
                return
            entry.done = True
            entry.state = "handoff"
            entry.reason = f"to:{to}" if to else "stolen"
            self._append([{"op": "done", "uid": request.uid,
                           "state": entry.state,
                           "reason": entry.reason}])
        led = life.active_ledger()
        if led is not None:
            led.release("journal", (id(self), request.uid))
        self._sync_durable()

    def record_failed(self, request) -> None:
        """Journal a quarantined request as terminal: a FAILED request
        is accounted for, never redelivered as if it were lost."""
        with self._mu:
            entry = self._entries.get(request.uid)
            if entry is None or entry.done:
                return
            entry.done = True
            entry.state = request.state
            entry.reason = request.finish_reason
            self._append([{"op": "done", "uid": request.uid,
                           "state": request.state,
                           "reason": request.finish_reason}])
        led = life.active_ledger()
        if led is not None:
            led.release("journal", (id(self), request.uid))
        self._sync_durable()

    def close(self, compact: bool = True) -> None:
        """Close the WAL; with ``compact`` rewrite it atomically holding
        only the unfinished entries (a clean drain leaves it empty, a
        crash leaves the whole WAL for replay)."""
        with self._mu:
            if self._fh is None:
                return
            self._fh.close()
            self._fh = None
            if not compact:
                return
            from ..train.checkpoint import write_atomic_durable

            lines = []
            for entry in (self._entries[u] for u in self._order):
                if entry.done:
                    continue
                lines.append(json.dumps(
                    {"op": "admit", "uid": entry.uid,
                     "prompt": entry.prompt,
                     "max_new_tokens": entry.max_new_tokens,
                     "eos_id": entry.eos_id}, sort_keys=True))
                if entry.tokens:
                    lines.append(json.dumps(
                        {"op": "tok", "uid": entry.uid,
                         "tokens": entry.tokens}, sort_keys=True))
            payload = ("\n".join(lines) + "\n") if lines else ""
            # under the lock: a record landing between the rewrite and
            # the rename would be lost
            write_atomic_durable(self.path, payload.encode("utf-8"))


# ------------------------------------------------- SIGTERM drain handler

_HANDLER_NOT_INSTALLED = object()


def install_drain_handler(engine, signum: int = signal.SIGTERM):
    """``signum`` -> ``engine.begin_drain`` (host state only: admission
    closes, and the drive loop finishes in-flight work up to its drain
    deadline). The previous handler is chained, and returned for
    :func:`restore_drain_handler`. Only the main thread can install
    one; elsewhere a sentinel is returned and restore is a no-op."""
    if threading.current_thread() is not threading.main_thread():
        return _HANDLER_NOT_INSTALLED
    prev = signal.getsignal(signum)

    def handler(s, frame):
        engine.begin_drain(f"signal {signal.Signals(s).name}")
        if callable(prev) and prev not in (signal.SIG_IGN,
                                           signal.SIG_DFL, handler):
            prev(s, frame)

    signal.signal(signum, handler)
    return prev


def restore_drain_handler(prev, signum: int = signal.SIGTERM) -> None:
    """Put back the handler :func:`install_drain_handler` displaced."""
    if prev is _HANDLER_NOT_INSTALLED:
        return
    signal.signal(signum, signal.SIG_DFL if prev is None else prev)
