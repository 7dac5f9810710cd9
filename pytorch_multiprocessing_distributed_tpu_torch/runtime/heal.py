"""Elastic supervision for training: liveness, coordinated abort and
supervised restart (the training half of the JAX package's
``runtime/heal.py``).

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

Not ported yet, as they belong to serving and ``--stats_port``
(ROADMAP.md §1 items 7 and 8): the request journal, the drain handler,
``HealthState`` and ``healthz``. The JAX module's observability events
and flight-recorder dumps (``scope.emit``, ``flight_dump``) wait for
the observability twin and are left out.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .faults import (GraftFaultError, PeerLostError, maybe_fault,
                     register_site, retry_with_backoff)

__all__ = [
    "ALIVE", "SUSPECT", "DEAD_PEER", "LivenessTracker", "Heartbeat",
    "HeartbeatMonitor", "post_poison", "check_poison", "clear_poison",
    "Supervisor", "RestartBudgetExhausted", "arm", "disarm",
    "active_monitor", "monitor_from_env",
]

_SITE_HB_WRITE = register_site(
    "heartbeat.write",
    "one host's liveness beat published to the control-plane store "
    "(bounded-retry write)")
_SITE_HB_READ = register_site(
    "heartbeat.read",
    "peer-beat + poison-key fetch from the control-plane store (one "
    "poll of the liveness gate)")
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
                print(f"graftheal: restart {attempt}/{self.max_restarts} "
                      f"after {type(e).__name__}: {e} (backoff "
                      f"{delay:g}s)", file=sys.stderr, flush=True)
                if delay > 0:
                    self.sleep(delay)
