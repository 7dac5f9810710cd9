"""Process bring-up for data-parallel runs (the port of the JAX package's
``parallel/dist.py``, single-node subset).

The JAX package's env contract, read the same way:

- ``PMDT_MASTER_ADDR=host:port`` — the rendezvous store (rank 0 hosts
  it); unset = one process, and every call here is a no-op;
- ``PMDT_WORLD_SIZE=N`` — required with ``PMDT_MASTER_ADDR``;
- ``PMDT_RANK`` — optional: without it ranks are handed out first come
  through the store's atomic counter;
- ``PMDT_INIT_TIMEOUT`` — seconds any wait may take (default 180).

Rendezvous goes through ``torch.distributed.TCPStore``, then
``init_process_group`` on that store: ``nccl`` for CUDA devices (one
card per rank, ``cuda:{rank % device_count}``), ``gloo`` for the CPU.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as tdist

_store: Optional[tdist.TCPStore] = None  # kept alive with the group


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
    if tdist.is_initialized():
        return
    master = os.environ.get("PMDT_MASTER_ADDR")
    if not master:
        return
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
    store = _open_store(host, port, world, rank_env, wait)
    rank = (int(rank_env) if rank_env is not None
            else store.add("rendezvous/next_rank", 1) - 1)
    if not 0 <= rank < world:
        raise RuntimeError(
            f"rank {rank} outside PMDT_WORLD_SIZE {world}: more processes "
            "checked in than the declared world size")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world, timeout=wait)
    _store = store


def device_for_rank(device: Union[str, torch.device]) -> torch.device:
    """This rank's device: ``cuda`` -> ``cuda:{rank % device_count}``;
    an explicit index or the CPU is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", get_rank() % torch.cuda.device_count())
    return dev


def destroy_process_group() -> None:
    """Leave the group (no-op for one process), forgetting its grid."""
    global _store
    from .mesh import reset_grid

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
    """Block until every rank arrives (no-op for one process)."""
    if get_world_size() > 1:
        tdist.barrier()
