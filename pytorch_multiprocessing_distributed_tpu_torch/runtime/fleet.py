"""Cross-rank observability: per-rank trace correlation, collective
and straggler attribution, and a goodput ledger (the port of the JAX
package's ``runtime/fleet.py``).

:mod:`.scope` and :mod:`.hbm` make one process observable in time and
space; this module answers what only a group of ranks can pose: which
rank made this step slow, how skewed were the arrivals at the last
collective boundary, and what fraction of the run's wall clock was
productive. Three legs:

1. **Rank-tagged events + collection.** An armed :class:`FleetMonitor`
   stamps every scope event with this rank's ``(host, rank, run_uid)``
   (``scope.set_identity``), publishes this rank's stats-server address
   to the control-plane store (the rendezvous ``TCPStore`` the
   heartbeats use), and publishes a one-shot **clock pair**
   ``(perf_counter, wall)`` so a collector can place every rank's
   monotonic timestamps on ONE axis. The :class:`FleetCollector`
   scrapes every rank's ``/metrics``, ``/snapshot.json`` and
   ``/events.json`` into merged gauges with rank labels, cross-rank
   percentiles per gauge, and one merged Chrome trace with a lane (pid)
   per rank.
2. **Collective latency + straggler attribution.** Every gated
   collective boundary (``parallel.dist.gate_collectives`` and
   ``barrier``, ``parallel.collectives.all_reduce``) posts a per-rank
   **arrival stamp** to the store: boundary name, per-name sequence
   number, monotonic stamp, and the static byte volume where the caller
   knows it. The straggler report groups stamps by ``(name, seq)`` and
   NAMES the slowest rank with its lag percentiles.
3. **Goodput ledger.** :class:`GoodputLedger` classifies wall time from
   the spans the bus already emits (``train.window`` minus its nested
   waits, the serving prefill and drain spans, ``train.checkpoint``,
   ``fault.retry`` and ``heal.restart`` backoffs, ``engine.drain``)
   into productive and lost seconds; ``goodput_frac`` rides
   ``/snapshot.json`` beside the serving and ``hbm_*`` gauges.

Arming discipline (the faults/scope/hbm convention): one module global.
Disarmed, :func:`note_arrival`, :func:`publish_endpoint` and
:func:`goodput_gauges` are a single global read + ``is None`` check.
Everything here is host-side bookkeeping at boundaries the host already
owns. Arrival stamps are BEST-EFFORT by contract: a store outage
increments :attr:`FleetMonitor.dropped_stamps` and the run keeps
training; liveness enforcement is :mod:`.heal`'s.

Env hook: ``PMDT_FLEET=<run_uid>`` arms a monitor over the rendezvous
store during ``PMDT_MASTER_ADDR`` bring-up (``parallel.dist``), the
``PMDT_FAULT_PLAN``/``PMDT_HEARTBEAT`` shape.

The JAX module's ``static_collective_bytes`` reads its graftcheck
budgets (``analysis/fingerprints.json``), which have no twin here; the
port's callers pass the bytes they hold.

4. **The serving fleet's replica directory.** :func:`publish_replica`
   and :func:`unpublish_replica` keep each replica's ``{role, state,
   address, published_at}`` under ``fleet/<run_uid>/replica/<rid>`` in
   the control-plane store (:class:`..serving.router.Router` publishes
   through them); :func:`replica_directory` reads them back, aged out
   past a TTL; :func:`fleet_serving_report` names the straggler replica
   from the per-replica snapshots.

Stdlib-only (no torch, no numpy).
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import scope as graftscope

__all__ = [
    "FleetMonitor", "FleetCollector", "GoodputLedger",
    "arm", "disarm", "active_fleet", "scoped_fleet",
    "note_arrival", "publish_endpoint", "monitor_from_env",
    "arm_goodput", "disarm_goodput", "active_goodput",
    "goodput_gauges", "publish_replica", "unpublish_replica",
    "replica_directory", "fleet_serving_report",
]


def _percentile(values: Sequence[float], q: float) -> float:
    """Exact linear-interpolation percentile (numpy's default), kept
    here so that this module stays stdlib-only."""
    n = len(values)
    if n == 0:
        return 0.0
    values = sorted(values)
    if n == 1:
        return float(values[0])
    rank = (q / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    if lo >= n - 1:
        return float(values[-1])
    frac = rank - lo
    return float(values[lo] + (values[lo + 1] - values[lo]) * frac)


# ------------------------------------------------------------ store keys

def _k(prefix: str, run_uid: str, *parts) -> str:
    return "/".join((prefix, run_uid) + tuple(str(p) for p in parts))


# ------------------------------------------------------------- monitor

class FleetMonitor:
    """One rank's fleet-observability publisher.

    Args:
      store: any ``set/get`` store (:class:`~.store.TCPStore`,
        :class:`~.store.MemStore`).
      host: this rank's host name (lane labels, straggler report).
      rank: this rank's integer rank.
      world: total ranks (the collector's discovery bound).
      run_uid: namespace for this run's keys — a restarted generation
        publishes under a fresh uid and never reads stale stamps.
      perf / wall: injectable clocks (tests drive skew synthetically).
        ``perf`` must be the SAME clock graftscope stamps events with
        (``time.perf_counter``) or the timeline alignment lies.
    """

    def __init__(self, store, host: str, rank: int, world: int, *,
                 run_uid: str = "run", prefix: str = "fleet",
                 perf: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.store = store
        self.host = str(host)
        self.rank = int(rank)
        self.world = int(world)
        self.run_uid = str(run_uid)
        self.prefix = str(prefix)
        self._perf = perf
        self._wall = wall
        self._arrivals = 0          # per-rank global stamp index
        self._seq: Dict[str, int] = {}  # boundary name -> next seq
        self.dropped_stamps = 0     # best-effort writes that failed
        self._set(_k(prefix, run_uid, "world"), str(world).encode())
        self.publish_clock()

    # ---- best-effort store writes ---------------------------------
    def _set(self, key: str, value: bytes) -> bool:
        """Observability writes must never kill the run: a store
        outage drops the stamp (counted, stderr once) — graftheal's
        heartbeat owns the loud he's-unreachable policy."""
        try:
            self.store.set(key, value)
            return True
        except (OSError, ValueError) as e:
            self.dropped_stamps += 1
            if self.dropped_stamps == 1:
                print(f"graftfleet: store write {key!r} failed "
                      f"({type(e).__name__}: {e}); dropping stamps "
                      "(counted) — observability never fails the run",
                      file=sys.stderr)
            return False

    # ---- publications ---------------------------------------------
    def publish_clock(self) -> None:
        """The monotonic-offset handshake: one (perf, wall) pair read
        back-to-back, so a collector can map this rank's
        ``perf_counter`` timestamps onto the shared wall axis as
        ``t_wall = t_perf + (wall - perf)``."""
        payload = {"perf": self._perf(), "wall": self._wall(),
                   "host": self.host}
        self._set(_k(self.prefix, self.run_uid, "clock", self.rank),
                  json.dumps(payload, sort_keys=True).encode())

    def publish_endpoint(self, address: str) -> None:
        """Publish this rank's live stats-server address
        (``host:port`` of ``scope.start_stats_server``) for the
        collector's scrape."""
        payload = {"host": self.host, "rank": self.rank,
                   "address": str(address)}
        self._set(_k(self.prefix, self.run_uid, "endpoint", self.rank),
                  json.dumps(payload, sort_keys=True).encode())
        graftscope.emit("fleet.endpoint", cat="fleet",
                        address=str(address))

    def note_arrival(self, name: str, axis: Optional[str] = None,
                     nbytes: Optional[int] = None) -> None:
        """Stamp this rank's arrival at collective boundary ``name``.
        The per-name ``seq`` counts this rank's own arrivals, so the
        collector matches the k-th ``dist.gate`` on every rank without
        any cross-rank coordination (SPMD loops hit boundaries in the
        same order — the property the collectives themselves rely on).
        """
        seq = self._seq.get(name, 0)
        self._seq[name] = seq + 1
        stamp: Dict[str, object] = {"name": name, "seq": seq,
                                    "rank": self.rank,
                                    "perf": self._perf()}
        if axis is not None:
            stamp["axis"] = axis
        if nbytes is not None:
            stamp["nbytes"] = int(nbytes)
        i = self._arrivals
        if self._set(_k(self.prefix, self.run_uid, "arrive",
                        self.rank, i),
                     json.dumps(stamp, sort_keys=True).encode()):
            self._arrivals = i + 1
            self._set(_k(self.prefix, self.run_uid, "arrive_count",
                         self.rank),
                      str(self._arrivals).encode())
        graftscope.emit("fleet.arrive", cat="fleet", boundary=name,
                        seq=seq)

    def snapshot(self) -> Dict:
        return {"fleet_rank": self.rank, "fleet_world": self.world,
                "fleet_arrivals": self._arrivals,
                "fleet_dropped_stamps": self.dropped_stamps}


# ----------------------------------------------------- module-level arm

_FLEET: Optional[FleetMonitor] = None


def arm(monitor: FleetMonitor) -> FleetMonitor:
    """Arm the process-wide monitor (one module global; disarmed cost
    is one read) and tag every graftscope event from here on with this
    rank's identity — the merged timeline's lane key."""
    global _FLEET
    _FLEET = monitor
    graftscope.set_identity({"host": monitor.host,
                             "rank": monitor.rank,
                             "run_uid": monitor.run_uid})
    return monitor


def disarm() -> None:
    global _FLEET
    _FLEET = None
    graftscope.set_identity(None)


def active_fleet() -> Optional[FleetMonitor]:
    return _FLEET


class scoped_fleet:
    """``with scoped_fleet(monitor): ...`` — arm for the block, always
    disarm (test/bench hygiene, mirrors ``scope.scoped``)."""

    def __init__(self, monitor: FleetMonitor):
        self.monitor = monitor

    def __enter__(self) -> FleetMonitor:
        return arm(self.monitor)

    def __exit__(self, *exc) -> None:
        disarm()


def note_arrival(name: str, axis: Optional[str] = None,
                 nbytes: Optional[int] = None) -> None:
    """Module-level arrival stamp against the armed monitor (no-op —
    one global read — when disarmed). The instrumented boundaries in
    ``parallel.dist``/``parallel.collectives`` call this
    unconditionally."""
    m = _FLEET
    if m is None:
        return
    m.note_arrival(name, axis=axis, nbytes=nbytes)


def publish_endpoint(address: str) -> None:
    """Module-level endpoint publication (no-op when disarmed) — the
    CLIs call this right after ``start_stats_server`` binds."""
    m = _FLEET
    if m is None:
        return
    m.publish_endpoint(address)


def monitor_from_env(store, host: str, rank: int, world: int
                     ) -> Optional[FleetMonitor]:
    """``PMDT_FLEET=<run_uid>`` -> an armed monitor over ``store``, or
    None when the env hook is unset — the ``PMDT_HEARTBEAT`` shape,
    called during store rendezvous (``parallel.dist``)."""
    spec = os.environ.get("PMDT_FLEET")
    if not spec:
        return None
    run_uid = "run" if spec.lower() in ("1", "on", "true") else spec
    return arm(FleetMonitor(store, host, rank, world, run_uid=run_uid))


# ------------------------------------------------------------ collector

class FleetCollector:
    """Read side of the fleet: store discovery + endpoint scraping +
    merged views. Runs anywhere that can reach the store and the
    ranks' stats ports (rank 0, a sidecar, a notebook)."""

    def __init__(self, store, *, run_uid: str = "run",
                 prefix: str = "fleet", world: Optional[int] = None,
                 timeout_s: float = 5.0):
        self.store = store
        self.run_uid = str(run_uid)
        self.prefix = str(prefix)
        self._world = world
        self.timeout_s = float(timeout_s)

    def _get(self, *parts) -> Optional[bytes]:
        return self.store.get(_k(self.prefix, self.run_uid, *parts))

    @property
    def world(self) -> int:
        if self._world is None:
            raw = self._get("world")
            if raw is None:
                raise KeyError(
                    f"no fleet world published under "
                    f"{self.prefix}/{self.run_uid} — is a FleetMonitor "
                    "armed with this run_uid?")
            self._world = int(raw)
        return self._world

    # ---- discovery -------------------------------------------------
    def clock_offsets(self) -> Dict[int, float]:
        """Per-rank ``wall - perf`` offsets from the published clock
        pairs: ``aligned_wall = perf_stamp + offset[rank]``. A rank
        that never published simply has no entry (its events/stamps
        are reported unaligned-at-zero-offset and flagged)."""
        out: Dict[int, float] = {}
        for rank in range(self.world):
            raw = self._get("clock", rank)
            if raw is None:
                continue
            pair = json.loads(raw)
            out[rank] = float(pair["wall"]) - float(pair["perf"])
        return out

    def endpoints(self) -> Dict[int, Dict]:
        """``{rank: {"host", "rank", "address"}}`` for every rank that
        published a stats endpoint."""
        out: Dict[int, Dict] = {}
        for rank in range(self.world):
            raw = self._get("endpoint", rank)
            if raw is not None:
                out[rank] = json.loads(raw)
        return out

    # ---- scraping --------------------------------------------------
    def _http(self, address: str, path: str) -> Optional[bytes]:
        url = f"http://{address}{path}"
        try:
            with urllib.request.urlopen(url,
                                        timeout=self.timeout_s) as resp:
                return resp.read()
        except OSError:
            return None  # a dead replica is a gap, not a crash

    def scrape(self) -> Dict[int, Dict]:
        """One pass over every published endpoint:
        ``{rank: {"snapshot": dict|None, "metrics": str|None,
        "events": list|None, "host": str}}``. Ranks whose server is
        gone scrape as ``None`` fields — the merged views show the
        hole instead of hiding it."""
        out: Dict[int, Dict] = {}
        for rank, ep in sorted(self.endpoints().items()):
            addr = ep["address"]
            snap = self._http(addr, "/snapshot.json")
            prom = self._http(addr, "/metrics")
            events = self._http(addr, "/events.json")
            out[rank] = {
                "host": ep.get("host", ""),
                "snapshot": (json.loads(snap) if snap else None),
                "metrics": (prom.decode() if prom else None),
                "events": (json.loads(events) if events else None),
            }
        return out

    # ---- merged views ----------------------------------------------
    @staticmethod
    def merged_gauges(snapshots: Dict[int, Optional[Dict]]) -> Dict:
        """Merge per-rank snapshot dicts into rank-labelled gauges
        with cross-rank percentiles: every numeric key becomes
        ``{key: {"by_rank": {rank: v}, "min", "max", "p50", "p95",
        "p99"}}`` — the fleet dashboard's one table. Use
        ``scrape()[rank]["snapshot"]`` as input (None snapshots —
        dead replicas — are skipped)."""
        by_key: Dict[str, Dict[int, float]] = {}
        for rank, snap in snapshots.items():
            if not snap:
                continue
            for key, value in snap.items():
                if isinstance(value, bool) or not isinstance(
                        value, (int, float)):
                    continue
                by_key.setdefault(key, {})[rank] = float(value)
        out: Dict[str, Dict] = {}
        for key, ranks in sorted(by_key.items()):
            vals = [ranks[r] for r in sorted(ranks)]
            out[key] = {
                "by_rank": {r: ranks[r] for r in sorted(ranks)},
                "min": min(vals), "max": max(vals),
                "p50": _percentile(vals, 50),
                "p95": _percentile(vals, 95),
                "p99": _percentile(vals, 99),
            }
        return out

    def merged_timeline(self,
                        events_by_rank: Dict[int, List[Dict]],
                        offsets: Optional[Dict[int, float]] = None,
                        hosts: Optional[Dict[int, str]] = None) -> Dict:
        """One Chrome-trace object with a LANE (pid) per rank: every
        rank's events aligned onto the shared wall axis through the
        clock handshake, shifted to start at 0 and converted to
        microseconds. Load in chrome://tracing / ui.perfetto.dev —
        rank lanes stack, so a straggling rank's long spans line up
        visually against its peers' idle gaps."""
        if offsets is None:
            offsets = self.clock_offsets()
        aligned: List[Tuple[int, float, Dict]] = []
        for rank, events in events_by_rank.items():
            off = offsets.get(rank, 0.0)
            for ev in events or []:
                aligned.append((rank, float(ev["ts"]) + off, ev))
        t0 = min((t for _, t, _ in aligned), default=0.0)
        trace: List[Dict] = []
        for rank in sorted(events_by_rank):
            name = f"rank {rank}"
            if hosts and hosts.get(rank):
                name += f" ({hosts[rank]})"
            trace.append({"name": "process_name", "ph": "M",
                          "pid": rank, "tid": 0,
                          "args": {"name": name}})
        for rank, t, ev in sorted(aligned, key=lambda x: x[1]):
            entry = {
                "name": ev.get("name", "?"),
                "cat": ev.get("cat", "run"),
                "ph": ev.get("ph", "i"),
                "ts": (t - t0) * 1e6,
                "pid": rank,
                "tid": ev.get("tid", 0),
            }
            if entry["ph"] == "X":
                entry["dur"] = float(ev.get("dur", 0.0)) * 1e6
            else:
                entry["s"] = "t"
            args = {k: v for k, v in ev.items()
                    if k not in ("name", "cat", "ph", "ts", "dur",
                                 "tid", "seq")}
            if args:
                entry["args"] = args
            trace.append(entry)
        return {"traceEvents": trace, "displayTimeUnit": "ms"}

    # ---- collective arrivals / straggler ---------------------------
    def arrivals(self) -> List[Dict]:
        """Every rank's arrival stamps, clock-aligned: each dict is
        ``{"name", "seq", "rank", "t" (aligned wall), "perf", ...}``
        in per-rank stamp order."""
        offsets = self.clock_offsets()
        out: List[Dict] = []
        for rank in range(self.world):
            raw = self._get("arrive_count", rank)
            count = int(raw) if raw else 0
            off = offsets.get(rank, 0.0)
            for i in range(count):
                payload = self._get("arrive", rank, i)
                if payload is None:
                    continue  # torn write window: skip, never wedge
                stamp = json.loads(payload)
                stamp["t"] = float(stamp["perf"]) + off
                out.append(stamp)
        return out

    def straggler_report(self, arrivals: Optional[List[Dict]] = None
                         ) -> Dict:
        """Group arrivals by ``(name, seq)`` and attribute the skew:
        for every matched collective the LAST rank to arrive is its
        straggler; per-rank lag percentiles (seconds behind the first
        arriver) plus slowest-counts decide the fleet's named
        straggler. ``{"collectives", "skew_p50/p95/p99_s",
        "straggler_rank", "by_rank", "by_name"}`` — ``straggler_rank``
        is None until at least one boundary matched on >= 2 ranks."""
        if arrivals is None:
            arrivals = self.arrivals()
        groups: Dict[Tuple[str, int], Dict[int, float]] = {}
        meta: Dict[str, Dict] = {}
        for stamp in arrivals:
            key = (str(stamp["name"]), int(stamp["seq"]))
            groups.setdefault(key, {})[int(stamp["rank"])] = float(
                stamp["t"])
            m = meta.setdefault(stamp["name"],
                                {"axis": None, "nbytes": None})
            if stamp.get("axis") is not None:
                m["axis"] = stamp["axis"]
            if stamp.get("nbytes") is not None:
                m["nbytes"] = int(stamp["nbytes"])

        lags: Dict[int, List[float]] = {}
        slowest: Dict[int, int] = {}
        skews: List[float] = []
        name_skews: Dict[str, List[float]] = {}
        name_slowest: Dict[str, Dict[int, int]] = {}
        matched = 0
        for (name, _seq), ranks in sorted(groups.items()):
            if len(ranks) < 2:
                continue  # nothing to attribute against
            matched += 1
            t_first = min(ranks.values())
            t_last = max(ranks.values())
            worst = max(ranks, key=lambda r: (ranks[r], r))
            slowest[worst] = slowest.get(worst, 0) + 1
            name_slowest.setdefault(name, {})[worst] = \
                name_slowest.setdefault(name, {}).get(worst, 0) + 1
            skews.append(t_last - t_first)
            name_skews.setdefault(name, []).append(t_last - t_first)
            for rank, t in ranks.items():
                lags.setdefault(rank, []).append(t - t_first)

        by_rank = {}
        for rank in sorted(lags):
            vals = lags[rank]
            by_rank[rank] = {
                "arrivals": len(vals),
                "slowest_count": slowest.get(rank, 0),
                "lag_p50_s": _percentile(vals, 50),
                "lag_p95_s": _percentile(vals, 95),
                "lag_p99_s": _percentile(vals, 99),
            }
        straggler = None
        if by_rank:
            straggler = max(
                by_rank,
                key=lambda r: (by_rank[r]["slowest_count"],
                               by_rank[r]["lag_p50_s"], r))
        by_name = {}
        for name in sorted(name_skews):
            counts = name_slowest.get(name, {})
            by_name[name] = {
                "events": len(name_skews[name]),
                "skew_p95_s": _percentile(name_skews[name], 95),
                "slowest_rank": (max(counts, key=lambda r: (counts[r], r))
                                 if counts else None),
                "axis": meta.get(name, {}).get("axis"),
                "nbytes": meta.get(name, {}).get("nbytes"),
            }
        return {
            "collectives": matched,
            "skew_p50_s": _percentile(skews, 50),
            "skew_p95_s": _percentile(skews, 95),
            "skew_p99_s": _percentile(skews, 99),
            "straggler_rank": straggler,
            "straggler_lag_p95_s": (
                by_rank[straggler]["lag_p95_s"]
                if straggler is not None else None),
            "by_rank": by_rank,
            "by_name": by_name,
        }


# --------------------------------------------------------- goodput

# spans that ARE the work the system exists to do
_PRODUCTIVE_SPANS = frozenset({
    "train.window",            # the trainer's per-window step wall
    "decode.drain",            # serving: one drained token block
    "serving.prefill", "serving.prefill_chunk", "serving.prefill_tok0",
    "serving.slot_insert", "serving.prefix_hit",
})
# spans emitted INSIDE train.window's wall (its own data/fetch waits):
# subtracted from the productive sum so waiting never counts as work
_WINDOW_NESTED = frozenset({"train.data", "train.metrics_fetch"})
# informational categories (each also reported as goodput_<cat>_s)
_SPAN_CATEGORIES = {
    "train.data": "data_wait",
    "train.metrics_fetch": "metrics_sync",
    "train.eval_fetch": "eval",
    "train.validate": "eval",
    "train.checkpoint": "checkpoint",
    # checkpoint.write nests inside train.checkpoint in the trainer;
    # tracked apart so the pair never double-counts one wall second
    "checkpoint.write": "checkpoint_write",
    "engine.drain": "drain",
}
# instant events whose attrs carry a lost-seconds payload.
# spec.verify (graftspec) is a span, but its waste_s attr is an
# instant-style cost: the fraction of the drained block's wall spent
# on REJECTED draft verify rows — work the chip did that yielded no
# token. Booked as spec_waste and SUBTRACTED from the productive
# serving sum (decode.drain covers the whole block's wall), so a
# low-acceptance speculative engine shows its waste as lost goodput
# instead of laundering it as serving time.
_INSTANT_COSTS = {
    "heal.restart": ("restart_backoff", "backoff_s"),
    "fault.retry": ("fault_retry", "delay_s"),
    "spec.verify": ("spec_waste", "waste_s"),
}


class GoodputLedger:
    """Classifies a run's wall clock into productive vs lost seconds
    from the graftscope events the bus already emits — no new clock
    reads, no new syncs, just accounting over the recorded timeline.

    Feed it :meth:`ingest` (``Event`` objects or their
    ``to_dict()``/JSONL dicts — both shapes carry ``seq``, the
    idempotence cursor: re-ingesting the same scope never
    double-counts) or let :func:`goodput_gauges` pull from the armed
    scope at scrape time. ``wall_s`` spans first-event-start to
    last-event-end; ``goodput_frac = productive_s / wall_s``.
    Categories (compile, checkpoint, data_wait, fault_retry,
    restart_backoff, drain, ...) are reported beside the fraction so
    the lost time is attributable, not just counted.

    Ring-only scopes (``keep=False``) can rotate events out between
    ingests; the cursor makes that a visible undercount (events
    arriving with a seq gap still ingest — nothing double-counts),
    so long-running servers should scrape at least as often as the
    flight ring turns over.
    """

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.events = 0
        self._cursor = -1
        self._t_min: Optional[float] = None
        self._t_max: Optional[float] = None
        # incremental scope consumption: the armed scope we last read
        # and how far into its stream we got (O(new events) per
        # scrape, not O(run) — a re-armed scope resets the cursor)
        self._scope = None
        self._scope_pos = 0
        # the stats endpoints serve snapshots from ThreadingHTTPServer
        # handler threads: two overlapping scrapes must not read the
        # same scope slice and double-count it
        self._mu = threading.Lock()

    # ---- ingestion -------------------------------------------------
    def _note(self, name: str, cat: str, ph: str, ts: float,
              dur: float, attrs: Dict) -> None:
        self.events += 1
        if self._t_min is None or ts < self._t_min:
            self._t_min = ts
        end = ts + (dur if ph == "X" else 0.0)
        if self._t_max is None or end > self._t_max:
            self._t_max = end

        def add(bucket: str, seconds: float) -> None:
            self.seconds[bucket] = self.seconds.get(bucket, 0.0) \
                + max(0.0, float(seconds))

        if ph == "X":
            if name in _PRODUCTIVE_SPANS:
                add("train_window" if name == "train.window"
                    else "serving", dur)
            if name in _WINDOW_NESTED:
                add("window_nested", dur)
            bucket = _SPAN_CATEGORIES.get(name)
            if bucket is None and cat == "compile":
                bucket = "compile"
            if bucket is not None:
                add(bucket, dur)
        cost = _INSTANT_COSTS.get(name)
        if cost is not None:
            bucket, attr = cost
            add(bucket, float(attrs.get(attr, 0.0) or 0.0))

    def ingest(self, events: Sequence) -> int:
        """Consume events past the seq cursor; returns how many were
        new. Accepts ``scope.Event`` objects and plain dicts (JSONL /
        ``/events.json`` rows) interchangeably. Thread-safe: the
        stats server scrapes from handler threads."""
        with self._mu:
            return self._ingest(events)

    def _ingest(self, events: Sequence) -> int:
        # caller holds self._mu
        new = 0
        for ev in events:
            if isinstance(ev, dict):
                seq = int(ev.get("seq", -1))
                if seq >= 0 and seq <= self._cursor:
                    continue
                attrs = {k: v for k, v in ev.items()
                         if k not in ("name", "cat", "ph", "ts",
                                      "dur", "tid", "seq")}
                self._note(str(ev.get("name", "?")),
                           str(ev.get("cat", "run")),
                           str(ev.get("ph", "i")),
                           float(ev.get("ts", 0.0)),
                           float(ev.get("dur", 0.0)), attrs)
            else:
                seq = ev.seq
                if seq <= self._cursor:
                    continue
                self._note(ev.name, ev.cat, ev.ph, ev.ts, ev.dur,
                           ev.attrs)
            if seq > self._cursor:
                self._cursor = seq
            new += 1
        return new

    def ingest_scope(self) -> int:
        """Pull whatever the armed graftscope has recorded since the
        last pull (0 when no scope is armed). Incremental: only the
        events recorded since the previous pull are copied and walked
        (``Scope.events_since``) — a Prometheus scrape loop stays
        O(new events), never O(whole run). A NEWLY armed scope (a
        supervised restart) resets the read cursor; the seq cursor in
        :meth:`ingest` still guarantees nothing double-counts."""
        s = graftscope.active_scope()
        if s is None:
            return 0
        with self._mu:
            # cursor read + slice + ingest are ONE atomic unit: two
            # overlapping scrapes must not consume the same slice
            if s is not self._scope:
                self._scope = s
                self._scope_pos = 0
            events, self._scope_pos = s.events_since(self._scope_pos)
            return self._ingest(events)

    # ---- classification --------------------------------------------
    @property
    def wall_s(self) -> float:
        if self._t_min is None or self._t_max is None:
            return 0.0
        return max(0.0, self._t_max - self._t_min)

    @property
    def productive_s(self) -> float:
        """Train windows minus their own nested waits, plus the
        serving work spans minus rejected-draft verify waste
        (graftspec) — never negative."""
        train = max(0.0, self.seconds.get("train_window", 0.0)
                    - self.seconds.get("window_nested", 0.0))
        serving = max(0.0, self.seconds.get("serving", 0.0)
                      - self.seconds.get("spec_waste", 0.0))
        return train + serving

    def gauges(self) -> Dict[str, float]:
        """The flat dict the stats endpoints merge in (every key
        prefixed ``goodput_`` so it rides /snapshot.json and
        /metrics beside the serving and hbm gauges)."""
        with self._mu:
            wall = self.wall_s
            productive = min(self.productive_s, wall) if wall else 0.0
            seconds = dict(self.seconds)
            events = float(self.events)
        out: Dict[str, float] = {
            "goodput_frac": (productive / wall) if wall > 0 else 0.0,
            "goodput_wall_s": wall,
            "goodput_productive_s": productive,
            "goodput_lost_s": max(0.0, wall - productive),
            "goodput_events": events,
        }
        for bucket in ("compile", "checkpoint", "checkpoint_write",
                       "data_wait", "metrics_sync", "eval",
                       "fault_retry", "restart_backoff", "drain",
                       "spec_waste"):
            out[f"goodput_{bucket}_s"] = seconds.get(bucket, 0.0)
        return out

    @classmethod
    def from_events(cls, events: Sequence) -> "GoodputLedger":
        ledger = cls()
        ledger.ingest(events)
        return ledger


_GOODPUT: Optional[GoodputLedger] = None


def arm_goodput(ledger: Optional[GoodputLedger] = None) -> GoodputLedger:
    """Arm the process-wide goodput ledger (the CLIs do this when
    ``--stats_port`` serves live gauges). One module global — the
    faults/scope discipline."""
    global _GOODPUT
    _GOODPUT = ledger if ledger is not None else GoodputLedger()
    return _GOODPUT


def disarm_goodput() -> None:
    global _GOODPUT
    _GOODPUT = None


def active_goodput() -> Optional[GoodputLedger]:
    return _GOODPUT


def goodput_gauges() -> Dict[str, float]:
    """The armed ledger's gauges after pulling the armed scope's new
    events — ``{}`` (and one global read) when disarmed. Snapshot
    functions call this unconditionally."""
    ledger = _GOODPUT
    if ledger is None:
        return {}
    ledger.ingest_scope()
    return ledger.gauges()


# ------------------------------------------- the serving fleet's directory

def publish_replica(store, rid: str, *, role: str = "both",
                    state: str = "starting",
                    address: Optional[str] = None,
                    run_uid: str = "run", prefix: str = "fleet",
                    now: Optional[float] = None) -> bool:
    """Publish one serving replica's identity to the control-plane
    store: ``fleet/<run_uid>/replica/<rid>`` -> ``{rid, role, state,
    address?, published_at}``. ``published_at`` is a wall
    clock stamp (``time.time()``, comparable across processes; ``now``
    for tests), refreshed by each publish, so a crashed publisher's
    entry ages out of :func:`replica_directory`'s TTL filter. The rid
    joins an append-only roster whose slots are claimed through the
    store's atomic ``add``, so concurrent publishers never lose each
    other. Best effort: a store outage drops the record and returns
    False."""
    payload = {"rid": str(rid), "role": str(role),
               "state": str(state),
               "published_at": float(time.time() if now is None
                                     else now)}
    if address is not None:
        payload["address"] = str(address)
    try:
        store.set(_k(prefix, run_uid, "replica", rid),
                  json.dumps(payload, sort_keys=True).encode())
    except (OSError, ValueError) as e:
        print(f"graftroute: replica publish {rid!r} failed "
              f"({type(e).__name__}: {e}); directory readers see a "
              "stale entry — routing correctness never depends on it",
              file=sys.stderr)
        return False
    base = _k(prefix, run_uid, "replicas")
    try:
        known = _roster_rids(store, base)
        if str(rid) not in known:
            idx = int(store.add(base + "/n", 1)) - 1
            store.set(f"{base}/{idx}", str(rid).encode())
    except (OSError, ValueError):
        return False
    return True


def unpublish_replica(store, rid: str, *, run_uid: str = "run",
                      prefix: str = "fleet") -> bool:
    """Delete ``rid``'s directory record (the router's reap and
    retirement): :func:`replica_directory` never returns it again. The
    roster slot stays claimed; a slot whose record is gone is skipped.
    Best effort, like :func:`publish_replica`."""
    try:
        store.delete(_k(prefix, run_uid, "replica", rid))
    except (OSError, ValueError) as e:
        print(f"graftroute: replica unpublish {rid!r} failed "
              f"({type(e).__name__}: {e}); the TTL filter ages the "
              "stale record out instead", file=sys.stderr)
        return False
    return True


def _roster_rids(store, base: str) -> List[str]:
    """The claimed roster slots, in claim order, without repeats; a
    claimed slot whose write has not landed yet reads empty and is
    skipped."""
    n = int(store.add(base + "/n", 0))
    rids: List[str] = []
    for i in range(n):
        raw = store.get(f"{base}/{i}")
        if not raw:
            continue
        rid = raw.decode()
        if rid not in rids:
            rids.append(rid)
    return rids


def replica_directory(store, *, run_uid: str = "run",
                      prefix: str = "fleet",
                      ttl_s: Optional[float] = None,
                      now: Optional[float] = None) -> Dict[str, Dict]:
    """The store-published replica directory, ``{rid: payload}``.
    ``ttl_s`` skips entries whose ``published_at`` is older than that
    many seconds (a crashed publisher stops refreshing its stamp);
    entries without a stamp, or with one that does not parse, are
    kept. ``now`` for tests. A store that cannot be read gives ``{}``."""
    out: Dict[str, Dict] = {}
    try:
        roster = _roster_rids(store, _k(prefix, run_uid, "replicas"))
    except (OSError, ValueError):
        return out
    t_now = time.time() if now is None else now
    for rid in roster:
        try:
            rec = store.get(_k(prefix, run_uid, "replica", rid))
        except (OSError, ValueError):
            continue
        if not rec:
            continue
        try:
            payload = json.loads(rec.decode())
        except ValueError:
            continue
        if ttl_s is not None:
            stamp = payload.get("published_at")
            try:
                aged = (stamp is not None
                        and t_now - float(stamp) > ttl_s)
            except (TypeError, ValueError):
                aged = False
            if aged:
                continue
        out[str(rid)] = payload
    return out


def fleet_serving_report(per_replica: Dict[str, Dict]) -> Dict:
    """The fleet's goodput view from per-replica snapshots
    (``Router.merged_metrics()["per_replica"]``): each replica's
    ``goodput_frac`` with their min and mean, and the straggler named,
    the replica with the lowest fraction."""
    fracs = {rid: float(s.get("goodput_frac", 0.0))
             for rid, s in per_replica.items()}
    out: Dict[str, object] = {
        "replicas": len(per_replica),
        "replicas_alive": sum(
            1 for s in per_replica.values()
            if s.get("state") not in ("dead",)),
    }
    if not fracs:
        return out
    vals = sorted(fracs.values())
    straggler = min(fracs, key=lambda rid: fracs[rid])
    out.update({
        "goodput_frac_per_replica": fracs,
        "goodput_frac_min": vals[0],
        "goodput_frac_mean": sum(vals) / len(vals),
        "straggler": straggler,
        "straggler_goodput_frac": fracs[straggler],
    })
    return out
