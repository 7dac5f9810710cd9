"""Process bring-up for data-parallel runs (the port of the JAX package's
``parallel/dist.py``, single-node subset).

The JAX package's env contract, read the same way:

- ``PMDT_MASTER_ADDR=host:port`` — the rendezvous store (rank 0 hosts
  it); unset = one process, and every call here is a no-op;
- ``PMDT_WORLD_SIZE=N`` — required with ``PMDT_MASTER_ADDR``;
- ``PMDT_RANK`` — optional: without it ranks are handed out first come
  through the store's atomic counter;
- ``PMDT_INIT_TIMEOUT`` — seconds any wait may take (default 180);
  the whole bring-up runs under a watchdog
  (:func:`..runtime.faults.run_with_timeout`) that fails fast with an
  actionable :class:`..runtime.faults.FaultTimeout`;
- ``PMDT_HEARTBEAT="soft:hard[:interval]"`` — arms a liveness monitor
  over the rendezvous store (:func:`..runtime.heal.monitor_from_env`).

Rendezvous goes through ``torch.distributed.TCPStore``, then
``init_process_group`` on that store: ``nccl`` for CUDA devices (one
card per rank, ``cuda:{rank % device_count}``), ``gloo`` for the CPU.
The bring-up and :func:`barrier` pass the ``runtime.rendezvous`` fault
site.

The pre-collective liveness gate: :func:`gate_collectives` runs the
installed gate (the armed monitor's, :mod:`..runtime.heal`) at every
window boundary of the trainers and, under ``serve_lm --tp``, at each
engine step, before each host readback and while a rank waits for
rank 0, so a lost peer raises a named
:class:`..runtime.faults.PeerLostError` on every survivor instead of
hanging it in the next collective.

:func:`spawn_ranks` starts the ranks of one group on this host (the
CLIs' own spawn without the ``PMDT_*`` env), and :class:`StoreBroadcast`
carries rank 0's host messages to the other ranks over the rendezvous
store, with no collective and so no process-group timeout on the wait.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import socket
import sys
import tempfile
import threading
import time
from datetime import timedelta
from typing import Callable, List, Optional, Union

import torch
import torch.distributed as tdist

from ..runtime import fleet as graftfleet
from ..runtime import scope as graftscope
from ..runtime.faults import maybe_fault, register_site, run_with_timeout

_store: Optional[tdist.TCPStore] = None  # kept alive with the group

# a rendezvous or barrier that faults must fail fast and named
_SITE_RENDEZVOUS = register_site(
    "runtime.rendezvous",
    "multihost rendezvous/barrier on the control plane (store "
    "bring-up, coordinator publish, experiment barriers)")

# the installed pre-collective gate (None: one global read, no-op)
_collective_gate = None


def install_collective_gate(fn) -> None:
    """Install ``fn`` (raises :class:`..runtime.faults.PeerLostError` on
    a lost peer or a poison key) as the pre-collective gate;
    :func:`..runtime.heal.arm` does this for its monitor."""
    global _collective_gate
    _collective_gate = fn


def clear_collective_gate() -> None:
    global _collective_gate
    _collective_gate = None


def gate_collectives(device: Optional[torch.device] = None) -> None:
    """Run the liveness gate if one is installed (a no-op otherwise).
    Called at a boundary about to enter, or wait on, collectives that a
    dead peer would wedge: the trainers' window boundaries.

    With ``device`` a card, the gate also covers the wait for the work
    already queued there: NCCL collectives run on the card, so a step
    whose peer died never completes, and the window's host fetch would
    block in it for good. The wait polls the device and runs the gate
    until the queue drains, so the fetch after it cannot hang; a dead
    peer raises here instead.

    An armed fleet monitor stamps this rank's arrival first (one global
    read when none is armed), so the stamp lands even when the gate
    then raises."""
    graftfleet.note_arrival("dist.gate")
    gate = _collective_gate
    if gate is None:
        return
    gate()
    if device is not None and torch.device(device).type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        while not done.query():
            gate()
            time.sleep(0.005)


def _is_local_host(host: str) -> bool:
    if host in ("127.0.0.1", "localhost", "0.0.0.0"):
        return True
    try:
        return host in (socket.gethostname(), socket.getfqdn(),
                        socket.gethostbyname(socket.gethostname()))
    except OSError:
        return False


def _parse_master(master: str):
    try:
        host, port = master.rsplit(":", 1)
        return host, int(port)
    except ValueError:
        raise RuntimeError(
            f"PMDT_MASTER_ADDR={master!r} is not host:port") from None


def _open_store(host: str, port: int, world: int, rank_env: Optional[str],
                timeout: timedelta) -> tdist.TCPStore:
    """Host the store when this process is (or may be) rank 0, else
    connect to it. An explicit rank 0 hosts unconditionally; in
    first-come mode a local process tries and, when the port is taken,
    connects instead."""
    if rank_env == "0" or (rank_env is None and _is_local_host(host)):
        try:
            return tdist.TCPStore(host, port, world, is_master=True,
                                  timeout=timeout, wait_for_workers=False)
        except RuntimeError:
            if rank_env == "0":
                raise
    try:
        return tdist.TCPStore(host, port, world, is_master=False,
                              timeout=timeout)
    except RuntimeError as e:
        raise RuntimeError(
            f"could not reach the rendezvous store at {host}:{port} within "
            f"{timeout.total_seconds():.0f}s ({e}). Is the rank-0 process "
            "up, and is PMDT_MASTER_ADDR identical on every process?"
        ) from e


def init_process(device: Union[str, torch.device] = "cpu",
                 timeout: Optional[float] = None) -> None:
    """Join the data-parallel group named by the ``PMDT_*`` env, or do
    nothing when ``PMDT_MASTER_ADDR`` is unset (one process). Safe to
    call twice."""
    global _store
    from ..runtime import heal
    from ..runtime.store import TCPStore

    if tdist.is_initialized():
        return
    master = os.environ.get("PMDT_MASTER_ADDR")
    if not master:
        return
    maybe_fault(_SITE_RENDEZVOUS)
    if timeout is None:
        timeout = float(os.environ.get("PMDT_INIT_TIMEOUT", 180))
    world_s = os.environ.get("PMDT_WORLD_SIZE")
    if not world_s:
        raise RuntimeError(
            "PMDT_MASTER_ADDR is set but PMDT_WORLD_SIZE is not; "
            "store-mediated bring-up needs the world size (export "
            "PMDT_WORLD_SIZE=<number of processes>)")
    world = int(world_s)
    rank_env = os.environ.get("PMDT_RANK")
    host, port = _parse_master(master)
    wait = timedelta(seconds=timeout)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"

    def bring_up():
        store = _open_store(host, port, world, rank_env, wait)
        rank = (int(rank_env) if rank_env is not None
                else store.add("rendezvous/next_rank", 1) - 1)
        if not 0 <= rank < world:
            raise RuntimeError(
                f"rank {rank} outside PMDT_WORLD_SIZE {world}: more "
                "processes checked in than the declared world size")
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        tdist.init_process_group(backend, store=store, rank=rank,
                                 world_size=world, timeout=wait)
        return store, rank

    store, rank = run_with_timeout(
        bring_up, timeout, what=f"process-group bring-up ({master})",
        hint=("Not all processes reached the rendezvous. Check that every "
              "process was started with the same PMDT_WORLD_SIZE and "
              "PMDT_MASTER_ADDR, that none crashed earlier (inspect their "
              "logs), and that the port is reachable. Set "
              "PMDT_INIT_TIMEOUT to adjust this deadline."))
    if backend == "nccl":
        # the current device is per thread: the watchdog's was set above
        torch.cuda.set_device(rank % torch.cuda.device_count())
    _store = store
    # PMDT_HEARTBEAT: a liveness monitor over the rendezvous store
    heal.monitor_from_env(TCPStore(store=store), str(rank),
                          [str(i) for i in range(world)])
    # PMDT_FLEET: the fleet monitor over the same store (rank-tagged
    # events, the clock pair, endpoint and arrival stamps)
    graftfleet.monitor_from_env(TCPStore(store=store), socket.gethostname(),
                                rank, world)


def free_port() -> int:
    """A free TCP port on this host for a rendezvous of spawned ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, world: int, port: int, run: Callable,
                  argv: List[str], threads: int, result_path: str) -> None:
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    torch.set_num_threads(threads)
    if rank == 0:
        sys.stdin = open(0, closefd=False)
    result = run(argv)
    if rank == 0:
        with open(result_path, "w") as f:
            json.dump(result, f)


def spawn_ranks(run: Callable[[List[str]], dict], world: int,
                argv: List[str]) -> dict:
    """``run(argv)`` on ``world`` ranks spawned on this host, each under
    the ``PMDT_*`` env of one group (a fresh port) with its share of
    this process's intra-op threads; rank 0 keeps this process's
    standard input, and a SIGTERM to this process goes on to rank 0
    (the rank that takes it: ``serve_lm --tp`` drains, a trainer
    checkpoints) while this process waits for every rank. Returns rank
    0's result (a JSON object). ``run`` must be a module-level function
    (the ranks are spawned, not forked)."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.json")
        ranks = mp.start_processes(
            _spawned_rank, nprocs=world, join=False, start_method="spawn",
            args=(world, free_port(), run, argv, threads, result_path))
        # only the main thread may set a handler
        forward = threading.current_thread() is threading.main_thread()
        if forward:
            rank0 = ranks.processes[0].pid
            prev = signal.signal(signal.SIGTERM,
                                 lambda signum, _: os.kill(rank0, signum))
        try:
            while not ranks.join():
                pass
        finally:
            if forward:
                signal.signal(signal.SIGTERM,
                              signal.SIG_DFL if prev is None else prev)
        with open(result_path) as f:
            return json.load(f)


class StoreBroadcast:
    """Rank 0's host messages to every other rank, in order, over the
    rendezvous store. No collective is involved, so nothing bounds the
    wait for the next message: a follower may wait as long as rank 0
    does (``serve_lm --tp`` while ``--stdin`` stays quiet). A reader
    polls the message's key and calls ``idle`` between polls (the
    liveness gate); a lost store (rank 0 gone) raises. Each message is
    deleted by the last rank to read it."""

    _POLL_S = (0.0002, 0.05)  # first and longest sleep between polls

    def __init__(self, name: str):
        if _store is None:
            raise RuntimeError("StoreBroadcast needs a joined group "
                               "(init_process under the PMDT_* env)")
        self._name = name
        self._seq = 0

    def _key(self) -> str:
        self._seq += 1
        return f"{self._name}/{self._seq}"

    def send(self, obj) -> None:
        """Rank 0: publish the next message."""
        _store.set(self._key(), pickle.dumps(obj))

    def recv(self, idle: Optional[Callable[[], None]] = None):
        """Another rank: the next message, once rank 0 has sent it."""
        key = self._key()
        sleep, longest = self._POLL_S
        while not _store.check([key]):
            if idle is not None:
                idle()
            time.sleep(sleep)
            sleep = min(2 * sleep, longest)
        obj = pickle.loads(_store.get(key))
        if _store.add(f"{key}/read", 1) == get_world_size() - 1:
            _store.delete_key(key)
            _store.delete_key(f"{key}/read")
        return obj


def device_for_rank(device: Union[str, torch.device]) -> torch.device:
    """This rank's device: ``cuda`` -> ``cuda:{rank % device_count}``;
    an explicit index or the CPU is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", get_rank() % torch.cuda.device_count())
    return dev


def destroy_process_group() -> None:
    """Leave the group (no-op for one process), forgetting its grid. A
    monitor gating over the store about to close is disarmed first."""
    global _store
    from ..runtime import heal
    from .mesh import reset_grid

    heal.disarm()
    graftfleet.disarm()
    reset_grid()
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _store = None


def get_rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns logging and checkpoint writes."""
    return get_rank() == 0


def barrier() -> None:
    """Block until every rank arrives (no-op for one process). The gate
    runs first, so a dead peer fails it named before anyone blocks."""
    gate_collectives()
    maybe_fault(_SITE_RENDEZVOUS)
    graftfleet.note_arrival("barrier:barrier")
    if get_world_size() > 1:
        # the wait inside the span is this rank's lead over the last
        # arriver (a host barrier: it blocks until every rank arrives)
        with graftscope.span("collective.barrier", cat="collective",
                             barrier="barrier"):
            tdist.barrier()
