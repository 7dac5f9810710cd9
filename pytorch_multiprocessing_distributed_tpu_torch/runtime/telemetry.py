"""The three CLIs' shared observability wiring (JAX ``main.py:438-513``,
``train_lm.py:554-599``, ``serve_lm.py:614-661``, written out three
times there): arm the scope and the device-memory ledger from the
flags, and serve the live gauges.

:func:`arm_from_args` arms a scope when ``--trace_out``,
``--events_out``, ``--flight_path`` or ``--stats_port`` asks for one
(:func:`.scope.arm_from_args`), and with ``--stats_port`` the
:mod:`.hbm` ledger, before any state or engine exists so their
registrations land on it.

:func:`start_stats` serves ``/metrics``, ``/snapshot.json``,
``/events.json`` and ``/healthz`` (:func:`.scope.start_stats_server`):
the CLI's live values merged with the ``hbm_*`` ledger gauges and the
``goodput_*`` gauges of an armed :class:`.fleet.GoodputLedger`;
``/healthz`` is :func:`.heal.healthz` of the CLI's health machine and
the armed heartbeat monitor (200 only while READY). The address is
published to an armed fleet monitor. A rank other than 0 serves on
``--stats_port + rank`` (the port runs one process per rank on one
machine, where JAX runs one per host). A port that does not bind
raises, as JAX's does. :func:`stop_stats` closes the listener, so a
supervised restart can bind the same port again.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from . import fleet, hbm, heal
from . import scope as graftscope

__all__ = ["arm_from_args", "start_stats", "stop_stats"]


def arm_from_args(args):
    """The scope (None when no flag asks for one) and, with
    ``--stats_port``, a fresh device-memory ledger."""
    scope = graftscope.arm_from_args(args)
    if getattr(args, "stats_port", 0):
        hbm.arm()
    return scope


def start_stats(port: int, live: Callable[[], Dict],
                health: Optional["heal.HealthState"], prefix: str = "pmdt",
                rank: int = 0,
                health_fn: Optional[Callable[[], Dict]] = None,
                label: str = "stats"):
    """The live stats server for ``live()`` on ``port + rank``; returns
    it (``server.server_address[1]`` is the bound port). ``health_fn``
    replaces ``/healthz``'s payload (the fleet router's aggregate);
    ``label`` starts the printed address line."""
    fleet.arm_goodput()

    def snapshot():
        snap = dict(live())
        ledger = hbm.active_ledger()
        if ledger is not None:
            snap.update(ledger.snapshot())
        snap.update(fleet.goodput_gauges())
        return snap

    server = graftscope.start_stats_server(
        snapshot, port=port + rank if port else 0, prefix=prefix,
        health_fn=health_fn or (
            lambda: heal.healthz(health, heal.active_monitor())),
        events_fn=graftscope.scope_events_fn)
    bound = server.server_address[1]
    print(f"{label}: http://127.0.0.1:{bound}/metrics (+ /healthz)",
          flush=True)
    fleet.publish_endpoint(f"127.0.0.1:{bound}")
    return server


def stop_stats(server) -> None:
    """Stop serving and close the listening socket (None: nothing)."""
    if server is not None:
        server.shutdown()
        server.server_close()
