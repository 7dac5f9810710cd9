"""All-reduce bandwidth benchmark of the port — the twin of the JAX
package's ``benchmarks/allreduce_bw.py``, on the card by default.

    python -m pytorch_multiprocessing_distributed_tpu_torch.allreduce_bw \\
        [--sizes-mb 1 16 64] [--iters 20] [--ring] [--check] \\
        [--device cuda|cpu] [--world_size N] [--loopback N] \\
        [--ring_configs G:T:S:K[:C] ...]

Puts the production collective and the hand-built ring side by side on
the same payloads. Per payload size it prints one JSON line per
implementation with the JAX script's keys (``metric``, ``payload_mb``,
``devices``, ``time_ms``, ``bus_gb_per_sec``, ``platform``), plus
``kind`` (the card's name, or ``cpu``) and ``payload_bytes``:

- the ``psum`` twin, :func:`.parallel.collectives.psum_`: NCCL on the
  cards, gloo on the CPU (``psum_nccl_…``, ``psum_gloo_…``; one process
  has no collective to run: ``psum_local_…``);
- with ``--ring`` and more than one rank, the ring
  (:func:`.ops.ring_allreduce.ring_all_reduce`): the CUDA kernel over
  peer memory on the cards (``cuda_ring_…``), the plain hops over gloo
  on the CPU (``gloo_ring_…``), with its ``launches`` on rank 0;
- with ``--loopback N``, the ring alone, N ranks in one process on one
  device (:func:`.ops.ring_allreduce.ring_all_reduce_loopback`; the
  kernel's single-card form, ``cuda_ring_loopback_…``, or the plain
  version on the CPU, ``plain_ring_loopback_…``);
- with ``--ring_configs`` on the card, the ring (or the loopback) again
  under each setting ``G:T:S:K[:C]`` of the kernel (``RING_BLOCKS``
  blocks, ``RING_THREADS`` data threads, ``RING_STEP`` elements a step,
  ``RING_SLOTS`` slots, ``RING_CONTROL`` control warps, kept as it is
  where C is left out; each a new comm buffer), timed in turns (the
  list, then the list reversed): one ``…_ab_…`` line per setting and
  payload with its ``config``, both turns' ``turn_ms`` and their mean
  as ``time_ms``; the settings are restored after.

Each rank is one process: ``--world_size`` ranks (default: every visible
card, or 2 on the CPU) are spawned through ``torch.multiprocessing``,
one per card over NCCL or gloo processes on the CPU; the kernels are
built in this process first, so ranks do not race ``nvcc``. The payload
is ``size // 4`` f32 ones per rank. On the card a call's time is CUDA
events around ``--iters`` calls after one warm-up call and a barrier,
each rank's time per call, and the slowest rank's is reported; on the
CPU the host clock. Bus bandwidth is the JAX script's ``bytes * 2(n-1)/n
/ time``, in GiB/s. ``--check`` first holds the ring bit for bit against
the plain version, computed on each rank from the same seeded inputs of
every rank, and adds ``max_abs_err``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from typing import Callable, List, Optional

import torch

from .device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="all-reduce bus bandwidth: psum (NCCL or gloo) and the "
                    "ring kernel")
    p.add_argument("--sizes-mb", nargs="+", type=float, default=[1, 16, 64])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--ring", action="store_true",
                   help="also run the ring all-reduce (its CUDA kernel on "
                        "the cards)")
    p.add_argument("--check", action="store_true",
                   help="hold the ring bit for bit against its plain "
                        "version first")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--world_size", type=int, default=None,
                   help="ranks, one process each (default: every visible "
                        "card; 2 on the CPU)")
    p.add_argument("--loopback", type=int, default=0, metavar="N",
                   help="run the ring alone over N ranks in this process "
                        "on one device")
    p.add_argument("--ring_configs", nargs="+", type=ring_config,
                   default=[], metavar="G:T:S:K[:C]",
                   help="also time the ring kernel under each setting: "
                        "blocks, data threads, step elements, slots "
                        "[, control warps]")
    return p


def ring_config(text: str) -> tuple:
    """``"G:T:S:K[:C]"`` -> the kernel's ``(RING_BLOCKS, RING_THREADS,
    RING_STEP, RING_SLOTS[, RING_CONTROL])``."""
    parts = text.split(":")
    if len(parts) not in (4, 5) or not all(p.isdigit() for p in parts):
        raise argparse.ArgumentTypeError(
            f"a ring setting is G:T:S:K[:C] (four or five integers), got "
            f"{text!r}")
    return tuple(int(p) for p in parts)


def bus_gib_per_s(size_bytes: int, n: int, seconds: float) -> float:
    """The ring formula of the JAX script: ``bytes * 2(n-1)/n / time``,
    in GiB/s."""
    return size_bytes * 2 * (n - 1) / n / seconds / 2 ** 30


def _line(metric: str, size_bytes: int, n: int, seconds: float,
          device: torch.device, **extra) -> dict:
    on_card = device.type == "cuda"
    return dict(
        metric=metric, payload_mb=round(size_bytes / 2 ** 20, 2),
        payload_bytes=size_bytes, devices=n, time_ms=seconds * 1e3,
        bus_gb_per_sec=bus_gib_per_s(size_bytes, n, seconds),
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(device) if on_card else "cpu",
        **extra)


def _per_call_s(fn: Callable[[], object], iters: int, device: torch.device,
                barrier: Callable[[], None]) -> float:
    """This rank's seconds per call: one warm-up call, a barrier, then
    ``iters`` calls between CUDA events (the host clock on the CPU)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    barrier()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def seeded_inputs(elems: int, n: int, device: torch.device, seed: int = 0
                  ) -> List[torch.Tensor]:
    """Every rank's check input, each rank computing all n alike: rank r
    draws from a generator on ``device`` seeded ``seed + r``, scaled by
    1e3."""
    out = []
    for r in range(n):
        gen = torch.Generator(device=device).manual_seed(seed + r)
        out.append(torch.randn(elems, generator=gen, device=device) * 1e3)
    return out


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def _ring_ab(args, calls: List[tuple], time_s: Callable, metric: str,
             n: int, device: torch.device) -> List[dict]:
    """Each ``(size, call)`` of ``calls`` timed under each of
    ``--ring_configs`` in turns (the list, then reversed; every payload
    under one setting before the next, so each turn opens one comm
    buffer a setting), one line per setting and payload; the kernel's
    settings are restored after."""
    from .ops import ring_allreduce as ring

    names = ("RING_BLOCKS", "RING_THREADS", "RING_STEP", "RING_SLOTS",
             "RING_CONTROL")
    saved = tuple(getattr(ring, k) for k in names)
    turns: dict = {}
    try:
        for config in args.ring_configs + args.ring_configs[::-1]:
            for k, v in zip(names, config):
                setattr(ring, k, v)
            for size, call in calls:
                turns.setdefault((config, size), []).append(time_s(call))
    finally:
        for k, v in zip(names, saved):
            setattr(ring, k, v)
    return [_line(metric, size, n, sum(t) / len(t), device,
                  config=":".join(map(str, c)),
                  turn_ms=[x * 1e3 for x in t])
            for (c, size), t in turns.items()]


def _bench_group(args, device: torch.device) -> List[dict]:
    """This rank's part of the benchmark in its process group (or alone);
    returns the lines (on every rank; the slowest rank's times)."""
    from .ops.ring_allreduce import ring_all_reduce, torch_ring_all_reduce
    from .parallel import dist
    from .parallel.collectives import all_gather_objects, psum_

    n, rank = dist.get_world_size(), dist.get_rank()

    def slowest(seconds: float) -> float:
        return max(all_gather_objects(seconds)) if n > 1 else seconds

    backend = (torch.distributed.get_backend() if n > 1 else "local")
    ring_name = "cuda_ring" if device.type == "cuda" else "gloo_ring"
    lines, ab_calls = [], []
    for mb in args.sizes_mb:
        size = int(mb * 2 ** 20)
        x = torch.ones(size // 4, dtype=torch.float32, device=device)
        dt = _per_call_s(lambda: psum_(x), args.iters, device, dist.barrier)
        lines.append(_line(f"psum_{backend}_allreduce_bus_bw", size, n,
                           slowest(dt), device))
        if not (args.ring and n > 1):
            continue
        extra = {}
        if args.check:
            xs = seeded_inputs(size // 4, n, device)
            err = _max_err(ring_all_reduce(xs[rank]),
                           torch_ring_all_reduce(xs)[rank])
            extra["max_abs_err"] = max(all_gather_objects(err))
            del xs
        x.fill_(1.0)
        before = ring_all_reduce.launches
        dt = _per_call_s(lambda: ring_all_reduce(x), args.iters, device,
                         dist.barrier)
        lines.append(_line(f"{ring_name}_allreduce_bus_bw", size, n,
                           slowest(dt), device,
                           launches=ring_all_reduce.launches - before,
                           **extra))
        ab_calls.append((size, lambda x=x: ring_all_reduce(x)))
    if args.ring_configs:
        lines += _ring_ab(
            args, ab_calls,
            lambda fn: slowest(_per_call_s(fn, args.iters, device,
                                           dist.barrier)),
            f"{ring_name}_ab_allreduce_bus_bw", n, device)
    return lines


def _bench_loopback(args, device: torch.device) -> List[dict]:
    """The ring alone over ``--loopback`` ranks on one device."""
    from .ops.ring_allreduce import (ring_all_reduce_loopback,
                                     torch_ring_all_reduce)

    n = args.loopback
    metric = ("cuda_ring_loopback_allreduce_bus_bw" if device.type == "cuda"
              else "plain_ring_loopback_allreduce_bus_bw")
    lines, ab_calls = [], []
    for mb in args.sizes_mb:
        size = int(mb * 2 ** 20)
        extra = {}
        if args.check:
            xs = seeded_inputs(size // 4, n, device)
            got = ring_all_reduce_loopback(xs)
            want = torch_ring_all_reduce(xs)
            extra["max_abs_err"] = max(_max_err(g, w)
                                       for g, w in zip(got, want))
            del xs, got, want
        xs = [torch.ones(size // 4, dtype=torch.float32, device=device)
              for _ in range(n)]
        before = ring_all_reduce_loopback.launches
        dt = _per_call_s(lambda: ring_all_reduce_loopback(xs), args.iters,
                         device, lambda: None)
        lines.append(_line(metric, size, n, dt, device,
                           launches=ring_all_reduce_loopback.launches
                           - before, **extra))
        ab_calls.append((size, lambda xs=xs: ring_all_reduce_loopback(xs)))
    if args.ring_configs:
        lines += _ring_ab(
            args, ab_calls,
            lambda fn: _per_call_s(fn, args.iters, device, lambda: None),
            "cuda_ring_loopback_ab_allreduce_bus_bw", n, device)
    return lines


def run(args) -> List[dict]:
    """One rank's benchmark under the ``PMDT_*`` env (or one process);
    returns its lines."""
    from .ops.ring_allreduce import release_peer_buffers
    from .parallel import dist

    device = resolve_device(args.device)
    dist.init_process(device)
    device = dist.device_for_rank(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if args.loopback:
        lines = _bench_loopback(args, device)
    else:
        lines = _bench_group(args, device)
    # collective (a rank that raised leaves the group by exiting instead)
    release_peer_buffers()
    dist.destroy_process_group()
    return lines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, world: int, port: int, argv: List[str],
                  threads: int, out_path: str) -> None:
    """A rank started by :func:`main`: the ``PMDT_*`` env of this process
    names the group; rank 0 writes the lines to ``out_path``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    torch.set_num_threads(threads)
    lines = run(build_parser().parse_args(argv))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(lines, f)


def _check_args(args) -> None:
    if args.iters < 1:
        raise SystemExit(f"--iters must be >= 1, got {args.iters}")
    if args.loopback < 0 or args.loopback == 1:
        raise SystemExit(f"--loopback takes N >= 2 ranks, got "
                         f"{args.loopback}")
    if args.world_size is not None and args.world_size < 1:
        raise SystemExit(f"--world_size must be >= 1, got {args.world_size}")
    if args.loopback and args.world_size not in (None, 1):
        raise SystemExit("--loopback runs in one process: drop "
                         "--world_size")
    if args.ring_configs and (args.device != "cuda"
                              or not (args.ring or args.loopback)):
        raise SystemExit("--ring_configs times the ring's CUDA kernel: it "
                         "needs --device cuda and --ring or --loopback")


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the benchmark on ``argv`` (default ``sys.argv[1:]``), print
    one JSON line per payload and implementation, and return the
    lines."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_args(args)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    world = args.world_size or (torch.cuda.device_count() if on_card else 2)
    if args.loopback or os.environ.get("PMDT_MASTER_ADDR"):
        world = 1
    if on_card and world > torch.cuda.device_count():
        raise SystemExit(
            f"--world_size {world} needs {world} CUDA devices, this machine "
            f"has {torch.cuda.device_count()} (one rank per card; pass "
            "--device cpu for gloo ranks on the CPU)")
    if on_card and (args.ring or args.loopback):
        from .ops import _build

        _build.build_all(["ring_allreduce"])
    if world == 1:
        lines = run(args)
    else:
        import torch.multiprocessing as mp

        threads = max(1, torch.get_num_threads() // world)
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "lines.json")
            mp.spawn(_spawned_rank, nprocs=world, join=True,
                     args=(world, _free_port(), argv + ["--world_size",
                                                        str(world)],
                           threads, out_path))
            with open(out_path) as f:
                lines = json.load(f)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
