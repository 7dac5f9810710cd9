"""The control-plane key-value stores (the port of the JAX package's
``runtime/store.py``).

- :class:`MemStore`: the in-process store with the client surface the
  heartbeat and poison keys use (``set/get/add/delete``), thread-safe
  like N clients of one server.
- :class:`TCPStore`: a client of ``torch.distributed.TCPStore`` (the
  store :mod:`..parallel.dist` opens at rendezvous, or one at
  ``host:port``) with the JAX client's surface, ``set/get/add/wait/
  delete/barrier``. Every operation runs under the bounded
  :func:`~.faults.retry_with_backoff`: a transient socket failure (or an
  injected :class:`~.faults.FaultInjected` at the ``store.get`` /
  ``store.set`` sites) is retried, with a reconnect between attempts
  after a real failure; a persistent one raises after the attempts.
- :class:`TCPStoreServer`: hosts a store on this process (the JAX
  package's C++ server; torch's store takes its place here).
"""

from __future__ import annotations

import threading
from datetime import timedelta
from typing import Optional

import torch.distributed as tdist

from .faults import (FaultInjected, maybe_fault, register_site,
                     retry_with_backoff)

_SITE_GET = register_site(
    "store.get", "runtime store fetch (get/wait) over the TCP socket")
_SITE_SET = register_site(
    "store.set", "runtime store mutation (set/add/delete) over the "
    "TCP socket")

# what a real socket failure of torch's store raises
_TRANSIENT = (OSError, tdist.DistNetworkError)


class MemStore:
    """In-process store with the client surface the heartbeat and
    poison keys use (``set/get/add/delete``): heartbeats work on one
    host and in tests without a server. ``wait``/``barrier`` belong to
    :class:`TCPStore`."""

    def __init__(self):
        self._kv: dict = {}
        self._mu = threading.Lock()

    def set(self, key: str, value: bytes) -> None:
        payload = maybe_fault(_SITE_SET, bytes(value))
        with self._mu:
            self._kv[key] = payload

    def get(self, key: str) -> Optional[bytes]:
        maybe_fault(_SITE_GET)
        with self._mu:
            return self._kv.get(key)

    def add(self, key: str, delta: int = 1) -> int:
        maybe_fault(_SITE_SET)
        with self._mu:
            value = int(self._kv.get(key, b"0")) + delta
            self._kv[key] = str(value).encode("ascii")
            return value

    def delete(self, key: str) -> bool:
        maybe_fault(_SITE_SET)
        with self._mu:
            return self._kv.pop(key, None) is not None

    def close(self) -> None:  # the surface of TCPStore
        pass


class TCPStoreServer:
    """Hosts a ``torch.distributed.TCPStore`` on this process (``port=0``
    picks a free port; :attr:`port` is the one bound)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._store = tdist.TCPStore(host, port, is_master=True,
                                     wait_for_workers=False)
        self.host, self.port = host, self._store.port

    def stop(self) -> None:
        self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class TCPStore:
    """Client of a ``torch.distributed.TCPStore`` with the JAX client's
    surface.

    Args:
      host, port: the server to connect to (ignored with ``store``).
      store: an open ``torch.distributed.TCPStore`` to use (the
        rendezvous store of :mod:`..parallel.dist`).
      retries: bounded attempts per operation (>= 1). :meth:`add`
        retries injected faults only (see its docstring).
      backoff_s: first-retry delay (doubles per retry, capped at 2 s).
      timeout_s: how long a connect, a ``get`` and a ``wait`` may block.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 20080, *,
                 store: Optional[tdist.Store] = None, retries: int = 3,
                 backoff_s: float = 0.05, timeout_s: float = 30.0):
        if retries < 1:
            raise ValueError(f"retries must be >= 1, got {retries}")
        self._timeout = timedelta(seconds=timeout_s)
        if store is None:
            store = self._connect(host, port)
        else:
            host, port = store.host, store.port
        self._store: Optional[tdist.Store] = store
        self._host, self._port = host, int(port)
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)

    def _connect(self, host: str, port: int) -> tdist.TCPStore:
        try:
            return tdist.TCPStore(host, port, is_master=False,
                                  timeout=self._timeout)
        except _TRANSIENT + (RuntimeError,) as e:
            raise ConnectionError(
                f"cannot connect to store at {host}:{port}: {e}") from e

    def _reconnect(self, attempt: int, exc: BaseException) -> None:
        """``on_retry`` hook: a real socket failure leaves the client
        dead, so reconnect before the next attempt (an injected fault
        fires before the wire call and leaves it healthy). If the
        reconnect fails the retries surface the persistent failure."""
        if isinstance(exc, FaultInjected):
            return
        try:
            self._store = self._connect(self._host, self._port)
        except ConnectionError:
            pass

    def _retry(self, fn, retry_on=_TRANSIENT):
        return retry_with_backoff(fn, attempts=self._retries,
                                  base_delay_s=self._backoff_s,
                                  retry_on=retry_on,
                                  on_retry=self._reconnect)

    def close(self) -> None:
        self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set(self, key: str, value: bytes) -> None:
        def once():
            payload = maybe_fault(_SITE_SET, value)
            self._store.set(key, payload)

        self._retry(once)

    def get(self, key: str) -> Optional[bytes]:
        """The value, or None when the key is absent (never blocks on
        an absent key)."""
        def once():
            maybe_fault(_SITE_GET)
            if not self._store.check([key]):
                return None
            return self._store.get(key)

        return self._retry(once)

    def add(self, key: str, delta: int = 1) -> int:
        """Atomically add to an integer key; returns the new value. Not
        retried on real socket failures: ``add`` is not idempotent, and
        a failure after the server committed would count twice on retry
        (orphaning a :meth:`barrier` arrival). Injected faults fire
        before the wire call, so they alone are retried."""
        def once():
            maybe_fault(_SITE_SET)
            return int(self._store.add(key, delta))

        return self._retry(once, retry_on=(FaultInjected,))

    def wait(self, key: str) -> bytes:
        """Block until ``key`` exists (at most ``timeout_s``); returns
        its value."""
        def once():
            maybe_fault(_SITE_GET)
            self._store.wait([key], self._timeout)
            return self._store.get(key)

        return self._retry(once)

    def delete(self, key: str) -> bool:
        def once():
            maybe_fault(_SITE_SET)
            return bool(self._store.delete_key(key))

        return self._retry(once)

    def barrier(self, name: str, world_size: int) -> None:
        """Counting barrier: arrive, then wait for the release key. One
        server-side arrivals counter identifies rounds (arrivals
        ``(k-1)*world+1 .. k*world`` are round k), so it is reusable with
        no client state; the releaser of round k deletes round k-1's
        release key."""
        arrival = self.add(f"__barrier__/{name}/arrivals", 1)
        round_no = (arrival - 1) // world_size + 1
        go_key = f"__barrier__/{name}/go/{round_no}"
        if arrival == round_no * world_size:  # the round's last arriver
            self.set(go_key, b"1")
            if round_no > 1:
                self.delete(f"__barrier__/{name}/go/{round_no - 1}")
        self.wait(go_key)
