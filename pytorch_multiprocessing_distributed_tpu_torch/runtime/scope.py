"""Structured tracing, live telemetry and a flight recorder for serving
and training: the port of the JAX package's ``runtime/scope.py``, a
stdlib-only module kept as the port's own copy.

A **zero-host-sync structured event bus**: spans and instant events
carry monotonic host timestamps and are emitted ONLY at boundaries
where the host already waits on the card (the horizon token-block
readback, the first-token readback at admission, the trainer's
windowed metric fetch, a checkpoint write, a retry). On CUDA a host
span around a kernel launch would time the enqueue, not the work, so
every span here wraps a sync the code already had and none adds one:
no ``.item()``, ``.cpu()``, ``torch.cuda.synchronize()`` or event wait
exists for an event's sake (``chip_smoke.py`` phase 33 counts the sync
warnings of ``torch.cuda.set_sync_debug_mode("warn")`` armed and
disarmed).

Arming discipline is :mod:`.faults`'s: one module global. Disarmed,
every emit helper is a single global read + ``is None`` check:
:func:`emit` returns immediately, :func:`span` hands back a shared
no-op context manager. No allocation, no clock read, nothing.

Pieces:

- :class:`Event` / :class:`Scope`: the bus. A ``Scope`` keeps the full
  event log (``keep=True``, the export mode the CLIs arm) and ALWAYS
  keeps a bounded ring of the most recent events, the **flight
  recorder**. On an engine-fatal error (``PoolPoisonedError``, a
  watchdog fail-fast, an unhandled exception in a drive or trainer
  loop) the ring is dumped to disk (:func:`flight_dump`).
- :func:`emit` / :func:`span` / :func:`emit_span`: module-level
  emission against the armed scope. ``span`` is a context manager
  (Chrome-trace "X" complete event, duration measured on the host);
  ``emit_span`` records a span RETROACTIVELY from a duration the caller
  already measured (the trainer's data-wait meter).
- Exporters: :func:`to_chrome_trace` / :func:`write_chrome_trace`
  (Perfetto/``chrome://tracing``-loadable JSON),
  :func:`write_jsonl` / :func:`events_from_jsonl` (the event log the
  timeline plot reads), and :func:`prometheus_text` +
  :func:`start_stats_server` (text exposition over stdlib
  ``http.server``: ``--stats_port`` on the three CLIs).

Timestamps are ``time.perf_counter`` seconds, the clock every
``Request`` lifecycle stamp and engine meter uses, so scope events and
``ServingMetrics`` percentiles line up exactly.

Env hook: ``PMDT_SCOPE=1`` (or ``PMDT_SCOPE=/path/for/flight.jsonl``)
arms a scope at import for chaos drills on a live CLI, the same shape
as ``PMDT_FAULT_PLAN``.

Stdlib-only (no torch, no numpy): importable from the fault layer and
the schedulers without dragging a runtime in.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

__all__ = [
    "Event", "Scope", "arm", "disarm", "active_scope", "scoped",
    "set_identity", "get_identity",
    "emit", "span", "emit_span", "flight_dump",
    "to_chrome_trace", "write_chrome_trace", "write_jsonl",
    "events_from_jsonl", "prometheus_text", "scope_events_fn",
    "start_stats_server",
    "flight_recorder", "add_cli_args", "arm_from_args",
    "export_from_args",
]


class Event:
    """One structured event: a span (``ph="X"``, has a duration) or an
    instant (``ph="i"``). ``ts`` is ``time.perf_counter`` seconds (the
    span's START for ``X``); ``seq`` is a process-wide monotone — two
    events with equal timestamps still have a total order."""

    __slots__ = ("name", "cat", "ph", "ts", "dur", "tid", "seq", "attrs")

    def __init__(self, name: str, cat: str, ph: str, ts: float,
                 dur: float, tid: int, seq: int, attrs: Dict):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.seq = seq
        self.attrs = attrs

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def to_dict(self) -> Dict:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts": self.ts, "tid": self.tid, "seq": self.seq}
        if self.ph == "X":
            d["dur"] = self.dur
        if self.attrs:
            d.update(self.attrs)
        return d

    def __repr__(self) -> str:
        return (f"Event({self.name!r}, cat={self.cat!r}, ph={self.ph!r}"
                f", ts={self.ts:.6f}, dur={self.dur:.6f}, "
                f"seq={self.seq})")


_SEQ = itertools.count()

# graftfleet: process-wide identity tags ((host, rank, run_uid) — set
# by runtime.fleet.arm) merged into every RECORDED event's attrs, so a
# fleet collector can lane-split a merged timeline by rank. One module
# global; None (the default) adds nothing anywhere — and the merge
# only runs inside Scope.record, which a disarmed process never
# reaches, so the disarmed hot-path cost contract is untouched.
_IDENTITY: Optional[Dict] = None


def set_identity(identity: Optional[Dict]) -> None:
    """Install (or with None clear) the identity tags every recorded
    event carries from here on. Existing attrs win on collision —
    an event that explicitly names a rank keeps its own."""
    global _IDENTITY
    _IDENTITY = dict(identity) if identity else None


def get_identity() -> Optional[Dict]:
    return dict(_IDENTITY) if _IDENTITY is not None else None


class Scope:
    """An armed event sink.

    Args:
      keep: keep the FULL event log (export mode — the CLIs' choice;
        memory grows with the run). False = ring-only (always-on
        production mode: bounded memory, flight recorder still whole).
      flight_capacity: ring size — how many recent events a fatal
        dump preserves.
      flight_path: where :func:`flight_dump` writes when the caller
        passes no explicit path (None = dumps are skipped unless a
        path is given at dump time).
    """

    def __init__(self, keep: bool = True, flight_capacity: int = 2048,
                 flight_path: Optional[str] = None):
        if flight_capacity < 1:
            raise ValueError(
                f"flight_capacity must be >= 1, got {flight_capacity}")
        self.keep = bool(keep)
        self.flight_path = flight_path
        self.t0 = time.perf_counter()
        self.ring: Deque[Event] = deque(maxlen=int(flight_capacity))
        self.log: List[Event] = []
        self.dropped = 0  # events that exist only in (or fell off) the ring
        self._mu = threading.Lock()

    def record(self, event: Event) -> None:
        identity = _IDENTITY
        if identity is not None:
            for key, value in identity.items():
                event.attrs.setdefault(key, value)
        with self._mu:
            if self.keep:
                self.log.append(event)
            elif len(self.ring) == self.ring.maxlen:
                self.dropped += 1  # oldest ring entry evicted for good
            self.ring.append(event)

    def events(self) -> List[Event]:
        """Snapshot of the recorded events (full log, or the ring when
        ``keep=False``), in record order."""
        with self._mu:
            return list(self.log) if self.keep else list(self.ring)

    def events_since(self, start: int):
        """Incremental read: ``(events, next_start)`` — the retained
        events whose STREAM index (count of events ever recorded) is
        ``>= start``, plus the cursor to pass next time. A periodic
        consumer (graftfleet's goodput scrape) stays O(new events) per
        call instead of re-copying the whole log. In ring mode events
        older than the ring are gone — a too-old ``start`` yields what
        is left (downstream seq cursors make that a visible
        undercount, never a double count)."""
        with self._mu:
            if self.keep:
                return self.log[start:], len(self.log)
            base = self.dropped
            items = list(self.ring)[max(0, start - base):]
            return items, base + len(self.ring)

    def tail(self) -> List[Event]:
        """The flight-recorder window: the most recent events."""
        with self._mu:
            return list(self.ring)

    def counts(self) -> Dict[str, int]:
        """``{event name: occurrences}`` over :meth:`events`."""
        out: Dict[str, int] = {}
        for ev in self.events():
            out[ev.name] = out.get(ev.name, 0) + 1
        return out


_SCOPE: Optional[Scope] = None


def arm(scope: Scope) -> Scope:
    global _SCOPE
    _SCOPE = scope
    return scope


def disarm() -> None:
    global _SCOPE
    _SCOPE = None


def active_scope() -> Optional[Scope]:
    return _SCOPE


class scoped:
    """``with scoped(Scope()) as s: ...`` — arm for the block, always
    disarm (test/bench hygiene, mirrors ``faults.armed``)."""

    def __init__(self, scope: Optional[Scope] = None):
        self.scope = scope if scope is not None else Scope()

    def __enter__(self) -> Scope:
        return arm(self.scope)

    def __exit__(self, *exc) -> None:
        disarm()


# --------------------------------------------------------------- emission

def emit(name: str, cat: str = "run", **attrs) -> None:
    """Record an instant event. Disarmed cost: one global read + an
    ``is None`` check (the kwargs the CALLER evaluated are discarded —
    keep hot-path attrs to values already at hand; never compute, and
    never sync, to feed an event)."""
    s = _SCOPE
    if s is None:
        return
    s.record(Event(name, cat, "i", time.perf_counter(), 0.0,
                   threading.get_ident(), next(_SEQ), attrs))


def emit_span(name: str, dur: float, cat: str = "run",
              t_start: Optional[float] = None, **attrs) -> None:
    """Record a span RETROACTIVELY from a duration the caller already
    measured (e.g. the trainer's per-batch data-wait): the span ends
    now (or at ``t_start + dur`` when given) and started ``dur``
    seconds earlier."""
    s = _SCOPE
    if s is None:
        return
    ts = (time.perf_counter() - dur) if t_start is None else t_start
    s.record(Event(name, cat, "X", ts, max(0.0, dur),
                   threading.get_ident(), next(_SEQ), attrs))


class _NullSpan:
    """The disarmed ``span()`` result: a shared, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        """No-op twin of :meth:`_LiveSpan.note`."""


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("scope", "name", "cat", "attrs", "t_start")

    def __init__(self, scope: Scope, name: str, cat: str, attrs: Dict):
        self.scope = scope
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t_start = 0.0

    def __enter__(self) -> "_LiveSpan":
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        now = time.perf_counter()
        if exc_type is not None:
            # a span that died names its killer — the flight
            # recorder's most valuable line
            self.attrs.setdefault("error", exc_type.__name__)
        self.scope.record(Event(
            self.name, self.cat, "X", self.t_start,
            now - self.t_start, threading.get_ident(), next(_SEQ),
            self.attrs))
        return False

    def note(self, **attrs) -> None:
        """Attach attrs discovered mid-span (e.g. tokens realized by a
        drain, known only after the readback)."""
        self.attrs.update(attrs)


def span(name: str, cat: str = "run", **attrs):
    """Context manager recording one complete span (begin at
    ``__enter__``, duration at ``__exit__``). Disarmed: returns a
    shared no-op — one global read, no allocation, no clock read."""
    s = _SCOPE
    if s is None:
        return _NULL_SPAN
    return _LiveSpan(s, name, cat, dict(attrs))


# ---------------------------------------------------------- flight recorder

def flight_dump(reason: str, path: Optional[str] = None
                ) -> Optional[str]:
    """Dump the armed scope's ring buffer (the most recent events) as
    JSONL — the crash-grade artifact engine-fatal paths write before
    propagating. First line is a header naming the reason; events
    follow oldest-first. Returns the path written, or None when no
    scope is armed / no path is configured (a disarmed process keeps
    its zero-cost contract even while crashing).

    Best-effort BY CONTRACT: every caller sits on a raise path (an
    engine-fatal error is about to propagate), so a dump failure — a
    typo'd directory, a full disk, an unserializable attr — must
    never replace the real error with its own. It is reported to
    stderr and swallowed; the original exception stays the one the
    process dies with."""
    s = _SCOPE
    if s is None:
        return None
    target = path if path is not None else s.flight_path
    if not target:
        return None
    tail = s.tail()
    before_window = (max(0, len(s.log) - len(tail)) if s.keep
                     else s.dropped)
    header = {"graftscope_flight": reason,
              "events": len(tail),
              "events_before_window": before_window,
              "t0": s.t0,
              "wall_time": time.time()}
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            fh.write(json.dumps(header, sort_keys=True) + "\n")
            for ev in tail:
                fh.write(json.dumps(ev.to_dict(), sort_keys=True,
                                    default=repr) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
    except Exception as e:
        # the dump is diagnostics for a crash already in flight —
        # failing to write it must not mask that crash
        print(f"graftscope: flight dump to {target!r} failed "
              f"({type(e).__name__}: {e}); continuing with the "
              "original error", file=sys.stderr)
        return None
    return target


class flight_recorder:
    """``with flight_recorder("serve loop"): ...`` — on ANY exception
    escaping the block, dump the flight ring (named after the block +
    the exception) and re-raise. The graftfault-era loops wrap their
    drive bodies in this so a crash always leaves a timeline behind."""

    def __init__(self, what: str, path: Optional[str] = None):
        self.what = what
        self.path = path

    def __enter__(self) -> "flight_recorder":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and not issubclass(
                exc_type, (GeneratorExit, KeyboardInterrupt, SystemExit)):
            emit("engine.fatal", cat="fault", what=self.what,
                 error=exc_type.__name__)
            flight_dump(f"{self.what}: {exc_type.__name__}: {exc}",
                        self.path)
        return False


# --------------------------------------------------------------- exporters

def to_chrome_trace(events: Sequence[Event],
                    t0: Optional[float] = None,
                    pid: Optional[int] = None) -> Dict:
    """Chrome-trace/Perfetto JSON object from events.

    Timestamps are shifted to start at 0 (``t0`` defaults to the
    earliest event, or the armed/arming scope's ``t0``) and converted
    to microseconds: load the file in ``chrome://tracing`` or
    https://ui.perfetto.dev next to the ``torch.profiler`` trace from
    ``utils.profiler.trace``.
    """
    if t0 is None:
        t0 = min((ev.ts for ev in events),
                 default=_SCOPE.t0 if _SCOPE is not None else 0.0)
    if pid is None:
        pid = os.getpid()
    out = []
    for ev in events:
        entry = {
            "name": ev.name,
            "cat": ev.cat,
            "ph": ev.ph,
            "ts": (ev.ts - t0) * 1e6,
            "pid": pid,
            "tid": ev.tid,
        }
        if ev.ph == "X":
            entry["dur"] = ev.dur * 1e6
        else:
            entry["s"] = "t"  # thread-scoped instant
        if ev.attrs:
            entry["args"] = ev.attrs
        out.append(entry)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: Sequence[Event],
                       t0: Optional[float] = None) -> str:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(events, t0), fh)
    return path


def write_jsonl(path: str, events: Sequence[Event]) -> str:
    """The raw event log, one JSON object per line (the format
    :func:`events_from_jsonl` and the timeline plot read, and the same
    schema :func:`flight_dump` writes after its header line)."""
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
    return path


def events_from_jsonl(path: str) -> List[Dict]:
    """Parse a JSONL event log (or a flight dump — header lines
    without a ``name`` field are skipped) into plain dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "name" in obj and "ph" in obj:
                out.append(obj)
    return out


def _prom_name(key: str, prefix: str) -> str:
    safe = "".join(c if (c.isalnum() or c == "_") else "_"
                   for c in key)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return f"{prefix}_{safe}"


def prometheus_text(snapshot: Dict, prefix: str = "pmdt_serving"
                    ) -> str:
    """Prometheus text exposition (0.0.4) of a flat metrics snapshot.

    Every numeric value becomes a gauge named
    ``<prefix>_<sanitized key>``; non-numeric values (program lists,
    strings) are skipped — the snapshot stays the one source of truth
    and this stays a dependency-free projection of it."""
    lines = []
    for key in sorted(snapshot):
        value = snapshot[key]
        if isinstance(value, bool) or not isinstance(value,
                                                     (int, float)):
            continue
        name = _prom_name(key, prefix)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(value):g}")
    return "\n".join(lines) + "\n"


def scope_events_fn(since: int = 0) -> List[Dict]:
    """The standard ``events_fn`` for :func:`start_stats_server`: the
    ARMED scope's retained events from stream index ``since`` as
    ``to_dict`` rows ([] when disarmed). Reading through the module
    global — not a captured Scope — means a re-armed scope (a
    supervised restart) is served live, never a dead incarnation's
    log; the ``since`` cursor keeps periodic scrapes O(new events)."""
    s = _SCOPE
    if s is None:
        return []
    events, _ = s.events_since(max(0, int(since)))
    return [e.to_dict() for e in events]


def start_stats_server(snapshot_fn: Callable[[], Dict], port: int = 0,
                       host: str = "127.0.0.1",
                       prefix: str = "pmdt_serving",
                       health_fn: Optional[Callable[[], Dict]] = None,
                       events_fn: Optional[Callable[[int], List[Dict]]]
                       = None):
    """Serve live telemetry over stdlib ``http.server`` (daemon
    thread): ``/metrics`` is the Prometheus text exposition of
    ``snapshot_fn()``, ``/snapshot.json`` the raw JSON snapshot.
    ``port=0`` binds an ephemeral port — read it back from
    ``server.server_address[1]``. Call ``server.shutdown()`` to stop.

    ``health_fn`` (graftheal) adds ``/healthz``: the JSON payload of
    ``health_fn()`` (``runtime.heal.healthz`` — health-machine state +
    last-beat ages), status **200 only when** ``state == "ready"``,
    503 otherwise — the liveness/readiness probe a replica router
    consumes (a DRAINING engine stops receiving traffic the moment it
    flips, without racing its queue). Without ``health_fn`` the path
    404s like any other.

    ``events_fn`` (graftfleet) adds ``/events.json``: called as
    ``events_fn(since)`` where ``since`` is the stream cursor from
    the optional ``?since=N`` query (0 without one); returns the
    recorded event dicts from that point (``Event.to_dict`` rows —
    the JSONL schema as one JSON array). :func:`scope_events_fn` is
    the standard source (the ARMED scope, re-arms followed live); a
    :class:`~.fleet.FleetCollector` scrapes the full array for the
    merged per-rank timeline, while a periodic consumer passes the
    count it already holds to stay O(new events) per scrape.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            code = 200
            try:
                if self.path.startswith("/metrics"):
                    body = prometheus_text(snapshot_fn(), prefix)
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/snapshot.json"):
                    body = json.dumps(snapshot_fn(), sort_keys=True)
                    ctype = "application/json"
                elif (self.path.startswith("/events.json")
                        and events_fn is not None):
                    since = 0
                    if "?" in self.path:
                        from urllib.parse import parse_qs, urlsplit

                        query = parse_qs(urlsplit(self.path).query)
                        try:
                            since = int(query.get("since", ["0"])[0])
                        except ValueError:
                            since = 0
                    body = json.dumps(events_fn(since), default=repr)
                    ctype = "application/json"
                elif (self.path.startswith("/healthz")
                        and health_fn is not None):
                    payload = health_fn()
                    body = json.dumps(payload, sort_keys=True)
                    ctype = "application/json"
                    if payload.get("state") != "ready":
                        code = 503  # router: stop sending traffic
                else:
                    self.send_error(404)
                    return
            except Exception as e:  # a broken snapshot_fn must surface
                self.send_error(500, f"{type(e).__name__}: {e}")
                return
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):  # stats scrapes are not stdout news
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="pmdt-stats-server")
    thread.start()
    return server


# ------------------------------------------------------------ CLI glue

def add_cli_args(parser, stats_port: bool = False) -> None:
    """The shared graftscope flag set (``serve_lm.py`` /
    ``train_lm.py`` / ``main.py`` all take the same three and all
    opt into ``--stats_port`` — live serving/training gauges plus the
    graftmeter ``hbm_*`` ledger). Any one of them arms a full-log
    scope for the run."""
    g = parser.add_argument_group("graftscope")
    g.add_argument("--trace_out", default="", type=str, metavar="JSON",
                   help="write a Chrome-trace/Perfetto JSON timeline "
                        "of the run (load in chrome://tracing or "
                        "ui.perfetto.dev, beside the torch.profiler "
                        "trace from --profile)")
    g.add_argument("--events_out", default="", type=str,
                   metavar="JSONL",
                   help="write the raw graftscope event log, one JSON "
                        "object per line (the timeline plot's and the "
                        "postmortem tooling's input)")
    g.add_argument("--flight_path", default="", type=str,
                   metavar="JSONL",
                   help="flight-recorder dump destination on fatal "
                        "errors (default: derived from --events_out/"
                        "--trace_out, else graftscope_flight.jsonl)")
    if stats_port:
        g.add_argument("--stats_port", default=0, type=int,
                       help="serve live telemetry over stdlib "
                            "http.server on this port: /metrics is "
                            "the Prometheus text exposition of the "
                            "metrics snapshot, /snapshot.json the "
                            "raw JSON (0 = off)")


def arm_from_args(args) -> Optional[Scope]:
    """Arm a scope when any graftscope flag asks for one (None — and
    zero cost — otherwise). Full-log only when an export artifact
    (``--trace_out``/``--events_out``) will actually consume it;
    ``--stats_port``/``--flight_path`` alone arm ring-only — bounded
    memory on a long-running server, flight recorder still whole."""
    export = args.trace_out or args.events_out
    if not (export or args.flight_path
            or getattr(args, "stats_port", 0)):
        return None
    flight = args.flight_path
    if not flight:
        flight = (os.path.splitext(export)[0] + ".flight.jsonl"
                  if export else "graftscope_flight.jsonl")
    return arm(Scope(keep=bool(export), flight_path=flight))


def export_from_args(args, echo=print) -> None:
    """End-of-run artifact writes for :func:`arm_from_args` CLIs."""
    s = _SCOPE
    if s is None:
        return
    events = s.events()
    if args.trace_out:
        write_chrome_trace(args.trace_out, events, t0=s.t0)
        echo(f"graftscope trace: {args.trace_out} "
             f"({len(events)} events)")
    if args.events_out:
        write_jsonl(args.events_out, events)
        echo(f"graftscope events: {args.events_out}")


# env hook: arm a scope for the whole process (live-CLI drills, the
# PMDT_FAULT_PLAN shape). "1"/"on" arms ring-only with the default
# flight path — the ring's ONLY consumer is the crash dump, so a mode
# that could never write one would be pure overhead; any other value
# is the flight-dump path (full log kept for export).
_ENV_SCOPE = os.environ.get("PMDT_SCOPE")
if _ENV_SCOPE:
    if _ENV_SCOPE.lower() in ("1", "on", "true"):
        arm(Scope(keep=False, flight_path="graftscope_flight.jsonl"))
    else:
        arm(Scope(keep=True, flight_path=_ENV_SCOPE))
