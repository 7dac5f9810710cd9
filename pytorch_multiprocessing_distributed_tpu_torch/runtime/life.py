"""The ownership ledger: realized acquire/release events for every
pooled resource the serving engine holds (the port of the JAX
package's ``runtime/life.py``), with holder attribution, so "drained
means EMPTY" is an audited property instead of a reviewed one.

Arming discipline (:mod:`.faults`'s and :mod:`.scope`'s exactly): a
module-global sentinel, ``active_ledger()`` is ONE global read when
disarmed, and every instrumentation point in the pools and the journal
is

    led = life.active_ledger()
    if led is not None:
        led.acquire("slot", key, ...)

so the disarmed hot path costs a single load-and-compare. Armed, the
ledger is host-side bookkeeping only (a dict insert or pop under a
lock): no device interaction, no host sync.

Resource kinds and their release evidence:

- ``slot`` / ``page`` / ``buffer`` / ``journal`` / ``transfer``:
  event-paired. The pool records the acquire, the release verb
  (``release``, a page's refcount reaching zero, a terminal journal
  record) records the release. A ``buffer`` hold also carries a
  weakref: a loan the GC collected is not a leak.
- ``socket`` / ``thread`` / ``file``: liveness-audited. The acquire
  records the object, and :meth:`OwnershipLedger.audit_drained` prunes
  entries whose object is provably dead (socket ``fileno() < 0``,
  thread not ``is_alive()``, file ``closed``).

:meth:`OwnershipLedger.audit_drained`: after ``drain()`` every ledger
must be EMPTY; each survivor is named (kind, key, holder uid when
tagged, acquire site, age), and double-acquire anomalies too.
Unmatched releases are counted, not findings: a ledger armed mid-life
sees releases of grants it never saw acquired.

The JAX ledger's ``audit_sites`` holds every realized acquire site
against the static lifecycle model of its ``analysis/lifecycle.py``,
which checks the JAX package's own source and has no twin in the port
(ROADMAP.md §1 item 8). It is left out; the realized sites are still
recorded (``_sites``).

Stdlib-only."""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["OwnershipLedger", "active_ledger", "armed", "arm",
           "disarm", "EVENT_KINDS", "LIVENESS_KINDS"]

# event-paired kinds: acquire and release are both instrumented
EVENT_KINDS = ("slot", "page", "buffer", "journal", "transfer")
# liveness-audited kinds: acquire is instrumented, the audit prunes
# provably-dead objects instead of demanding a release event
LIVENESS_KINDS = ("socket", "thread", "file")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_PARENT = os.path.dirname(_PKG_DIR)

_LEDGER: Optional["OwnershipLedger"] = None


def active_ledger() -> Optional["OwnershipLedger"]:
    """The armed ledger, or None — the ONE global read every
    disarmed instrumentation point pays."""
    return _LEDGER


@contextmanager
def armed(ledger: Optional["OwnershipLedger"] = None):
    """Arm ``ledger`` (a fresh one by default) for the scope, restore
    the previous arming state on exit — graftfault's discipline, so
    nested arming and test isolation both work."""
    global _LEDGER
    prev = _LEDGER
    led = ledger if ledger is not None else OwnershipLedger()
    _LEDGER = led
    try:
        yield led
    finally:
        _LEDGER = prev


def arm(ledger: Optional["OwnershipLedger"] = None
        ) -> "OwnershipLedger":
    """Imperative arming (the hbm/scope ledger idiom — benches that
    bracket a point with try/finally rather than a with-block)."""
    global _LEDGER
    led = ledger if ledger is not None else OwnershipLedger()
    _LEDGER = led
    return led


def disarm() -> None:
    global _LEDGER
    _LEDGER = None


def _caller_site(depth: int = 2) -> Tuple[str, int]:
    """(abspath, line) of the frame ``depth`` hops above the ledger
    call — depth 2 is the caller OF the instrumented resource method,
    i.e. the acquire site the static model harvested."""
    try:
        f = sys._getframe(depth + 1)
    except ValueError:
        return ("<unknown>", 0)
    return (f.f_code.co_filename, f.f_lineno)


def _rel_site(site: Tuple[str, int]) -> str:
    path, line = site
    try:
        rel = os.path.relpath(path, _PKG_PARENT)
    except ValueError:
        rel = path
    return f"{rel}:{line}"


class _Hold:
    __slots__ = ("key", "site", "holder", "t0", "ref")

    def __init__(self, key, site, holder, ref):
        self.key = key
        self.site = site
        self.holder = holder
        self.t0 = time.perf_counter()
        self.ref = ref  # weakref to the object, or None


def _alive(obj, kind: str) -> bool:
    """Is a liveness-audited hold still actually held?"""
    if obj is None:
        return False  # collected: nothing open
    if kind == "thread":
        return bool(obj.is_alive())
    if kind == "socket":
        try:
            return obj.fileno() >= 0
        except OSError:
            return False
    if kind == "file":
        return not obj.closed
    return True


class OwnershipLedger:
    """Armed acquire/release events per resource kind with holder
    attribution — the runtime side of graftlife. All methods are
    thread-safe (wire handler threads acquire concurrently)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._held: Dict[str, Dict[object, _Hold]] = {
            k: {} for k in EVENT_KINDS + LIVENESS_KINDS}
        self.acquired: Dict[str, int] = {
            k: 0 for k in EVENT_KINDS + LIVENESS_KINDS}
        self.released: Dict[str, int] = {
            k: 0 for k in EVENT_KINDS + LIVENESS_KINDS}
        self.unmatched_releases: Dict[str, int] = {
            k: 0 for k in EVENT_KINDS + LIVENESS_KINDS}
        self.anomalies: List[str] = []
        # realized package acquire sites, kind -> {(relpath, line)}
        self._sites: Dict[str, set] = {}

    # ---- events --------------------------------------------------------
    def acquire(self, kind: str, key, holder=None, obj=None,
                depth: int = 2) -> None:
        site = _caller_site(depth)
        ref = None
        if obj is not None:
            try:
                ref = weakref.ref(obj)
            except TypeError:
                ref = None
        with self._mu:
            table = self._held[kind]
            if key in table and (kind in EVENT_KINDS):
                prev = table[key]
                self.anomalies.append(
                    f"double-acquire of {kind} {key!r}: granted at "
                    f"{_rel_site(prev.site)} (holder={prev.holder!r})"
                    f" and again at {_rel_site(site)} with no release"
                    " between")
            table[key] = _Hold(key, site, holder, ref)
            self.acquired[kind] += 1
            path, line = site
            if path.startswith(_PKG_DIR + os.sep):
                rel = os.path.relpath(path, _PKG_PARENT)
                self._sites.setdefault(kind, set()).add((rel, line))

    def release(self, kind: str, key) -> None:
        with self._mu:
            if self._held[kind].pop(key, None) is None:
                self.unmatched_releases[kind] += 1
            else:
                self.released[kind] += 1

    def tag(self, kind: str, key, holder) -> None:
        """Attach holder attribution (a request uid, a rid) to a
        grant recorded by a pool that could not know its tenant."""
        with self._mu:
            hold = self._held[kind].get(key)
            if hold is not None:
                hold.holder = holder

    # ---- state ---------------------------------------------------------
    def live(self, kind: str) -> int:
        """Currently-held count, liveness- and GC-pruned."""
        with self._mu:
            self._prune(kind)
            return len(self._held[kind])

    def counts(self) -> Dict[str, int]:
        """``{kind: live count}`` — the ``leaked_*`` numbers the
        bench points carry (all must be 0 after a drain)."""
        return {k: self.live(k)
                for k in EVENT_KINDS + LIVENESS_KINDS}

    def _prune(self, kind: str) -> None:
        # caller holds self._mu
        table = self._held[kind]
        if kind in LIVENESS_KINDS:
            dead = [k for k, h in table.items()
                    if not _alive(h.ref and h.ref(), kind)]
        elif kind == "buffer":
            # a loan the GC collected is the pool's no-longer-loaned
            # no-op (BufferPool tracks loans by weakref identity):
            # not held, not a leak
            dead = [k for k, h in table.items()
                    if h.ref is not None and h.ref() is None]
        else:
            dead = []
        for k in dead:
            del table[k]
            self.released[kind] += 1

    # ---- audits --------------------------------------------------------
    def audit_drained(self, scope: str = "") -> List[str]:
        """Every ledger must be EMPTY after drain()/stop()/close():
        one named finding per surviving holder (kind, key, holder,
        acquire site, age) plus any double-acquire anomalies. Empty
        list = pass."""
        import gc
        if any(self._held["buffer"] for _ in (0,)):
            gc.collect()  # settle weakref loans before judging them
        out: List[str] = []
        where = f" after {scope}" if scope else ""
        now = time.perf_counter()
        with self._mu:
            for kind in EVENT_KINDS + LIVENESS_KINDS:
                self._prune(kind)
                for key, hold in sorted(self._held[kind].items(),
                                        key=lambda kv: kv[1].t0):
                    who = (f" holder={hold.holder!r}"
                           if hold.holder is not None else "")
                    out.append(
                        f"GRAFTLIFE-AUDIT: leaked {kind} {key!r}"
                        f"{where}:{who} acquired at "
                        f"{_rel_site(hold.site)} "
                        f"{now - hold.t0:.3f}s ago — a drained "
                        "component must hold NOTHING; release it on "
                        "every path or move its ownership explicitly")
            out.extend(f"GRAFTLIFE-AUDIT: {a}" for a in self.anomalies)
        return out
