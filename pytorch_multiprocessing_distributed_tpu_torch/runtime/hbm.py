"""Live device-memory ledger: who owns how many device bytes, now.

The port of the JAX package's ``runtime/hbm.py``. :mod:`.scope` makes
the port observable in *time*; this module is its sibling in *space*: a
host-side ledger of every long-lived device allocation the port makes
(parameters, optimizer state, the serving KV pool and its slot state, a
``generate`` call's caches), registered AT the allocation site and
exposed as ``hbm_*`` gauges beside the serving and training metrics on
``/metrics`` and ``/snapshot.json``.

The ledger never touches the device: every entry is computed from
tensor metadata the host already holds (``numel() * element_size()``,
no read, no sync). On a sharded state a rank charges the slice it holds
(the port's placed states keep a rank's slice as its own flat tensor).

The JAX ledger also carries one entry per decode program,
``serving.decode_temp_w{W}_h{H}``, from XLA's ahead-of-time memory
analysis (``analysis/meter.py``). The port has no twin of that model
yet (ROADMAP.md §1 item 8), so those entries are left out; every other
entry carries JAX's name, category and bytes.

Arming discipline is :mod:`.faults`'s / :mod:`.scope`'s: one module
global. Disarmed (the default), every registration helper is a single
global read + ``is None`` check. The CLIs arm a ledger when
``--stats_port`` asks for live gauges; tests arm one with
:class:`scoped_ledger`.

Stdlib-only: no torch import (a tensor is read through its own
methods), so the schedulers and the fault layer import it freely.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

__all__ = [
    "HbmLedger", "arm", "disarm", "active_ledger", "scoped_ledger",
    "register", "update", "release", "set_gauge", "nbytes_of",
    "tree_nbytes", "shard_nbytes", "tree_shard_nbytes",
]


def nbytes_of(x) -> int:
    """Device bytes of one array-like, from host-side metadata only: a
    quantized KV pair's data plus scale, else ``.nbytes`` (a tensor's
    ``numel() * element_size()``, numpy's), else ``prod(shape) *
    dtype.itemsize``. Raises TypeError on something that is not
    array-shaped: a ledger entry of unknowable size is a bug, not a
    zero."""
    data = getattr(x, "data", None)
    scale = getattr(x, "scale", None)
    if data is not None and scale is not None and hasattr(scale, "dtype"):
        return nbytes_of(data) + nbytes_of(scale)
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        raise TypeError(
            f"nbytes_of wants an array-like (shape+dtype), got "
            f"{type(x).__name__}")
    return int(math.prod(shape)) * int(dtype.itemsize)


def _leaves(tree):
    """The array leaves of a nest of dicts, lists and tuples (None holds
    none)."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif tree is not None:
        yield tree


def tree_nbytes(tree) -> int:
    """Total device bytes of a nest of tensors (params, optimizer
    state): host metadata only, no device touch."""
    return sum(nbytes_of(leaf) for leaf in _leaves(tree))


def shard_nbytes(x) -> int:
    """Bytes of one tensor a rank holds: the port's sharded states keep
    a rank's slice as a tensor of its own, so this is its size (JAX reads
    a sharded array's per-device shape here)."""
    return nbytes_of(x)


def tree_shard_nbytes(tree) -> int:
    """A rank's total of a nest (:func:`shard_nbytes` per leaf)."""
    return sum(shard_nbytes(leaf) for leaf in _leaves(tree))


class HbmLedger:
    """Named device-byte entries grouped by category.

    Entries are ``name -> (category, bytes, attrs)``; re-registering a
    name replaces it (an allocation site that re-allocates — a resized
    pool, a re-sharded state — keeps ONE truthful row). ``snapshot()``
    flattens to the gauge dict the stats endpoints merge in: a total,
    one gauge per category, one per entry — all prefixed ``hbm_`` so
    a Prometheus exposition under the ``pmdt`` prefix reads
    ``pmdt_hbm_total_bytes`` etc.
    """

    def __init__(self):
        self._entries: Dict[str, tuple] = {}
        self._gauges: Dict[str, int] = {}
        self._mu = threading.Lock()

    def register(self, name: str, nbytes: int, category: str = "other",
                 **attrs) -> None:
        if nbytes < 0:
            raise ValueError(
                f"hbm entry {name!r}: bytes must be >= 0, got {nbytes}")
        with self._mu:
            self._entries[name] = (str(category), int(nbytes),
                                   dict(attrs))

    def update(self, name: str, nbytes: int) -> None:
        """Resize an existing entry (unknown names raise — a typo'd
        update must not silently create a second row)."""
        with self._mu:
            if name not in self._entries:
                raise KeyError(f"no hbm entry {name!r} to update")
            cat, _, attrs = self._entries[name]
            self._entries[name] = (cat, int(nbytes), attrs)

    def release(self, name: str) -> None:
        """Drop an entry (idempotent: releasing twice — or an entry a
        disarmed phase never registered — is not an error)."""
        with self._mu:
            self._entries.pop(name, None)

    def set_gauge(self, name: str, value: int) -> None:
        """A UTILIZATION gauge riding beside the byte entries
        (graftpage's ``pages_in_use`` etc.): exported verbatim by
        ``snapshot()`` but NEVER summed into ``hbm_total_bytes`` — a
        page in use is already counted by the pool's capacity entry,
        and a ledger that double-counts is worse than none."""
        with self._mu:
            self._gauges[name] = int(value)

    def entries(self) -> Dict[str, tuple]:
        with self._mu:
            return dict(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._mu:
            return sum(b for _, b, _ in self._entries.values())

    def breakdown(self) -> Dict[str, Dict[str, int]]:
        """``{category: {entry name: bytes}}`` — the stacked-bar input
        chart input)."""
        out: Dict[str, Dict[str, int]] = {}
        for name, (cat, nbytes, _attrs) in sorted(self.entries().items()):
            out.setdefault(cat, {})[name] = nbytes
        return out

    def snapshot(self) -> Dict[str, int]:
        """Flat gauges: ``hbm_total_bytes``, ``hbm_<category>_bytes``,
        ``hbm_<category>_<entry>_bytes`` (entry names sanitized to
        metric-safe characters)."""
        def safe(s: str) -> str:
            return "".join(c if (c.isalnum() or c == "_") else "_"
                           for c in s)

        snap: Dict[str, int] = {}
        total = 0
        for cat, rows in self.breakdown().items():
            cat_total = sum(rows.values())
            total += cat_total
            snap[f"hbm_{safe(cat)}_bytes"] = cat_total
            for name, nbytes in rows.items():
                snap[f"hbm_{safe(cat)}_{safe(name)}_bytes"] = nbytes
        snap["hbm_total_bytes"] = total
        snap["hbm_entries"] = len(self.entries())
        with self._mu:
            for name, value in self._gauges.items():
                snap[f"hbm_{safe(name)}"] = value
        return snap


_LEDGER: Optional[HbmLedger] = None


def arm(ledger: Optional[HbmLedger] = None) -> HbmLedger:
    global _LEDGER
    _LEDGER = ledger if ledger is not None else HbmLedger()
    return _LEDGER


def disarm() -> None:
    global _LEDGER
    _LEDGER = None


def active_ledger() -> Optional[HbmLedger]:
    return _LEDGER


class scoped_ledger:
    """``with scoped_ledger() as l: ...`` — arm for the block, always
    disarm (test/bench hygiene, mirrors ``scope.scoped``)."""

    def __init__(self, ledger: Optional[HbmLedger] = None):
        self.ledger = ledger if ledger is not None else HbmLedger()

    def __enter__(self) -> HbmLedger:
        return arm(self.ledger)

    def __exit__(self, *exc) -> None:
        disarm()


# ---- module-level registration against the armed ledger ------------
# Disarmed cost: one global read + `is None` — the faults/scope
# discipline. Allocation sites call these unconditionally.

def register(name: str, nbytes: int, category: str = "other",
             **attrs) -> None:
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.register(name, nbytes, category, **attrs)


def update(name: str, nbytes: int) -> None:
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.update(name, nbytes)


def release(name: str) -> None:
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.release(name)


def set_gauge(name: str, value: int) -> None:
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.set_gauge(name, value)
