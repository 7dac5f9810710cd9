"""Deterministic fault injection and the recovery primitives (the port's
copy of the JAX package's ``runtime/faults.py``).

Every hazard point registers a named **injection site** and routes
through :func:`maybe_fault`; tests and the ``PMDT_FAULT_PLAN`` env hook
arm a seeded :class:`FaultPlan` that decides, by per-site call count,
which calls fail, hang, or corrupt their payload. A fault is either
recovered or surfaces as a named :class:`GraftFaultError`: never a hang,
never a silent swallow. Disarmed, :func:`maybe_fault` is one module
global read and an ``is None`` check.

The recovery half:

- :func:`retry_with_backoff`: bounded retries with exponential backoff
  for transient (``OSError``-shaped) failures (the runtime store, the
  heartbeat);
- :func:`run_with_timeout`: run a callable under a watchdog thread and
  fail fast with a :class:`FaultTimeout` naming what hung (the bring-up
  in :mod:`..parallel.dist`).

Fault kinds (``FaultRule.kind``): ``"error"`` raises
:class:`FaultInjected` (a ``ConnectionError``: the transient class every
retry path catches); ``"fatal"`` raises :class:`GraftFaultError` (not
retryable); ``"hang"`` sleeps ``hang_s`` seconds, then returns;
``"corrupt"`` flips one payload byte at a seed-chosen offset (sites that
move bytes pass them through ``maybe_fault(site, payload)``).

Env hook: ``PMDT_FAULT_PLAN="seed=7;store.get=error:2;train.checkpoint_write=corrupt:1"``
arms a plan at import: ``site=kind[:times[:arg]]``, ``arg`` seconds for
``hang`` and the skip-first-N offset otherwise, ``times=0`` unlimited,
and an optional plan-wide ``every=K`` that makes rules fire on every
K-th eligible hit.

The JAX module also emits an observability event at each injected
fault, retry and timeout (``scope.emit``). The port has no observability
layer yet (ROADMAP.md §1 item 8), so those calls are left out; nothing
else of the module's behaviour depends on them.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "GraftFaultError", "FaultInjected", "FaultTimeout",
    "DeadlineExceeded", "PoolPoisonedError", "PeerLostError",
    "FaultRule", "FaultPlan", "register_site", "registered_sites",
    "maybe_fault", "arm", "disarm", "armed", "active_plan",
    "retry_with_backoff", "run_with_timeout", "plan_from_spec",
]


class GraftFaultError(RuntimeError):
    """Base class for every named fault this layer raises or injects:
    a fault that cannot be recovered surfaces as (a subclass of) this,
    naming its site."""


class FaultInjected(GraftFaultError, ConnectionError):
    """An injected transient fault (``kind="error"``). A
    ``ConnectionError`` (hence ``OSError``), so the bounded-retry paths
    that recover real socket flakes recover it too."""


class FaultTimeout(GraftFaultError):
    """A watchdog-bounded operation did not complete in time."""


class DeadlineExceeded(GraftFaultError):
    """A request outlived its per-request deadline and was evicted."""


class PoolPoisonedError(GraftFaultError):
    """A step that consumed live shared state failed midway: the
    state's owner cannot keep running on it and must be rebuilt."""


class PeerLostError(GraftFaultError):
    """A peer went silent (heartbeat hard timeout) or poisoned the run
    (coordinated abort): every surviving rank raises this, naming
    ``who`` was lost and ``why``, before its next collective instead of
    hanging in it (:mod:`.heal`)."""

    def __init__(self, who: str, why: str):
        super().__init__(f"peer {who!r} lost: {why}")
        self.who = who
        self.why = why


# --------------------------------------------------------------- registry

_SITES: Dict[str, str] = {}
_PLAN: Optional["FaultPlan"] = None


def register_site(name: str, description: str) -> str:
    """Declare a named injection site (idempotent, at import)."""
    _SITES.setdefault(name, description)
    return name


def registered_sites() -> Dict[str, str]:
    """``{site name: description}`` for every registered site."""
    return dict(_SITES)


def maybe_fault(site: str, payload=None):
    """The per-hazard-point hook: ``payload`` untouched when no plan is
    armed, else the armed plan decides (raise, hang or corrupt)."""
    plan = _PLAN
    if plan is None:
        return payload
    return plan.apply(site, payload)


def arm(plan: "FaultPlan") -> "FaultPlan":
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional["FaultPlan"]:
    return _PLAN


class armed:
    """``with armed(plan): ...``: arm for the block, always disarm."""

    def __init__(self, plan: "FaultPlan"):
        self.plan = plan

    def __enter__(self) -> "FaultPlan":
        return arm(self.plan)

    def __exit__(self, *exc) -> None:
        disarm()


# ------------------------------------------------------------------ plan

class FaultRule:
    """One scheduled fault at one site.

    Args:
      site: the registered site the rule triggers at.
      kind: ``"error"`` | ``"fatal"`` | ``"hang"`` | ``"corrupt"``.
      times: how many hits trigger (0 = unlimited).
      after: skip the first ``after`` hits of the site.
      every: with ``every=K > 0``, trigger only on every K-th eligible
        hit (a background fault rate instead of a burst).
      hang_s: sleep length for ``kind="hang"``.
    """

    def __init__(self, site: str, kind: str = "error", *,
                 times: int = 1, after: int = 0, every: int = 0,
                 hang_s: float = 0.25):
        if kind not in ("error", "fatal", "hang", "corrupt"):
            raise ValueError(
                f"unknown fault kind {kind!r} (want error|fatal|hang|"
                f"corrupt)")
        if times < 0 or after < 0 or every < 0:
            raise ValueError("times/after/every must be >= 0")
        self.site = site
        self.kind = kind
        self.times = int(times)
        self.after = int(after)
        self.every = int(every)
        self.hang_s = float(hang_s)
        self.triggered = 0  # faults this rule injected

    def should_fire(self, hit: int) -> bool:
        """``hit`` is the site's 0-based call index."""
        if hit < self.after:
            return False
        if self.times and self.triggered >= self.times:
            return False
        if self.every and (hit - self.after) % self.every != 0:
            return False
        return True

    def __repr__(self) -> str:
        return (f"FaultRule({self.site!r}, {self.kind!r}, "
                f"times={self.times}, after={self.after}, "
                f"every={self.every})")


class FaultPlan:
    """A deterministic, seedable fault schedule over named sites.

    Count-driven: the n-th call to a site faults or not by the rules
    alone, so the same workload under the same plan takes the same
    faults at the same operations. ``seed`` feeds only the corrupted
    byte's offset. The counts are kept under a lock: an armed plan is
    reached from several threads (store clients, the heartbeat)."""

    def __init__(self, rules: Iterable[FaultRule], seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = int(seed)
        self.hits: Dict[str, int] = {}
        self._mu = threading.Lock()

    def triggered(self, site: Optional[str] = None) -> int:
        """Faults injected (optionally at one site)."""
        return sum(r.triggered for r in self.rules
                   if site is None or r.site == site)

    def site_hits(self, site: str) -> int:
        """How many times a site was reached while armed."""
        return self.hits.get(site, 0)

    def _corrupt(self, site: str, payload):
        if payload is None:
            return payload
        data = bytearray(payload)
        if not data:
            return bytes(data)
        # seed + length + hit count -> the flipped offset
        idx = (self.seed * 1000003 + len(data)
               + self.hits.get(site, 1) * 7919) % len(data)
        data[idx] ^= 0xFF
        return bytes(data)

    def apply(self, site: str, payload):
        with self._mu:
            hit = self.hits.get(site, 0)
            self.hits[site] = hit + 1
            fired: Optional[FaultRule] = None
            for rule in self.rules:
                if rule.site != site or not rule.should_fire(hit):
                    continue
                rule.triggered += 1
                fired = rule
                break
        # the slow parts (sleep, byte flip) run outside the lock
        if fired is None:
            return payload
        if fired.kind == "error":
            raise FaultInjected(
                f"graftfault: injected transient fault at "
                f"{site!r} (hit {hit})")
        if fired.kind == "fatal":
            raise GraftFaultError(
                f"graftfault: injected fatal fault at {site!r} "
                f"(hit {hit})")
        if fired.kind == "hang":
            time.sleep(fired.hang_s)
            return payload
        if payload is None:
            # a corrupt rule where no bytes pass would count an
            # injection that never happened
            raise GraftFaultError(
                f"graftfault: corrupt rule armed at {site!r}, but that "
                "site passes no payload to corrupt — use kind='error' "
                "(or 'hang'/'fatal') for this site")
        return self._corrupt(site, payload)


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse the ``PMDT_FAULT_PLAN`` grammar into a plan:
    ``"seed=7;every=0;site=kind[:times[:arg]];..."``, ``arg`` being
    ``hang_s`` for ``hang`` rules and ``after`` otherwise. ``seed=`` and
    ``every=`` apply to every rule wherever they stand."""
    seed = 0
    every = 0
    sites: List[Tuple[str, str]] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key, value = key.strip(), value.strip()
        if key == "seed":
            seed = int(value)
        elif key == "every":
            every = int(value)
        else:
            sites.append((key, value))
    rules: List[FaultRule] = []
    for key, value in sites:
        fields = value.split(":")
        kind = fields[0]
        times = int(fields[1]) if len(fields) > 1 else 1
        kw = {}
        if len(fields) > 2:
            if kind == "hang":
                kw["hang_s"] = float(fields[2])
            else:
                kw["after"] = int(fields[2])
        rules.append(FaultRule(key, kind, times=times, every=every,
                               **kw))
    return FaultPlan(rules, seed=seed)


# --------------------------------------------------------------- recovery

def retry_with_backoff(fn: Callable, *, attempts: int = 3,
                       base_delay_s: float = 0.05,
                       max_delay_s: float = 2.0,
                       retry_on: Tuple[type, ...] = (OSError,),
                       on_retry: Optional[Callable] = None,
                       sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` with bounded exponential-backoff retries.

    Retries only on ``retry_on`` (default the ``OSError`` family,
    :class:`FaultInjected` included); anything else propagates at once.
    The last transient error is re-raised when the attempts run out.
    ``on_retry(attempt_index, exc)`` observes each retry; ``sleep`` is
    injectable so tests never wait."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = base_delay_s
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                sleep(delay)
            delay = min(delay * 2, max_delay_s)


def run_with_timeout(fn: Callable, timeout_s: float, what: str,
                     hint: str = ""):
    """Run ``fn()`` in a daemon thread, bounded by ``timeout_s``:
    return its result, raise its own error, or fail fast with a
    :class:`FaultTimeout` naming what hung. The abandoned thread is a
    daemon and cannot keep the process alive."""
    box: Dict[str, object] = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # re-raised on the caller below
            box["err"] = e

    t = threading.Thread(target=target, daemon=True,
                         name=f"pmdt-watchdog-{what}")
    t.start()
    t.join(timeout_s)
    if "err" in box:
        raise box["err"]  # type: ignore[misc]
    if "result" not in box:
        raise FaultTimeout(
            f"{what} did not complete within {timeout_s:.3g}s."
            + (f" {hint}" if hint else ""))
    return box["result"]


# env hook: arm a plan for the whole process (chaos drills on a live CLI)
_ENV_SPEC = os.environ.get("PMDT_FAULT_PLAN")
if _ENV_SPEC:
    arm(plan_from_spec(_ENV_SPEC))
