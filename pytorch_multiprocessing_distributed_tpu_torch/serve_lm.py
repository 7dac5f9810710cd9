"""Continuous-batching LM serving CLI — the port of the JAX package's
``serve_lm.py``, single-engine path, on the card by default.

    python -m pytorch_multiprocessing_distributed_tpu_torch.serve_lm \\
        --model gpt_small --random_init --dtype bfloat16 --max_slots 8 \\
        --synthetic 16 --max_new_tokens 32 --decode_horizon 4 \\
        --kv_layout paged --page_size 16 --prefix_cache 8 --kv_dtype int8

Flags keep the JAX CLI's names and meanings for what the port does.
``--ckpt`` serves the port's own training checkpoints: ``train_lm``'s
``model_<epoch>.pth`` (its sidecar checked first), or with a directory
the run's ``orbax/`` tree (the latest committed epoch, or
``--ckpt_epoch``), a pipelined run's stacked tree unstacked; or an
``.npz`` of the flattened JAX param tree
(:func:`.serving.params.load_params`). Requests come from ``--requests
FILE`` (JSON Lines), ``--stdin`` (one byte-level prompt per line) or
``--synthetic N`` (the JAX CLI's seeded prompts, the same for the same
``--seed``). Tokens stream to stdout as ``req=<uid> tok=<id>`` lines and
``req=<uid> tokens=[...]`` when a request finishes; the final metrics
snapshot is printed as ``metrics: {...}``.

``--kv_layout paged`` (with ``--page_size``, ``--num_pages`` and
``--prefix_cache``), ``--kv_dtype int8`` and ``--prefill_chunk`` keep the
JAX CLI's names, defaults and meanings; the snapshot then carries the
prefix-cache and page counters and the pool's bytes. ``--draft_k K``
arms speculative decode (greedy only): self-drafting from each
request's own tokens, or with ``--draft_model NAME`` a registry GPT
(random weights from ``--seed + 1``, or ``--draft_ckpt`` read as
``--ckpt`` is) proposing the drafts; the snapshot then carries the
``spec_*`` and ``accept_len_*`` keys.

``--tp M`` serves tensor-parallel on M ranks, one per card (JAX's
``make_mesh(n_dev // tp, tp)`` without its data axis: that axis only
copies the computation, so the port's world is exactly M). Without the
``PMDT_*`` env it spawns the M ranks itself (NCCL on the cards, gloo
ranks with ``--device cpu``); under it (``PMDT_MASTER_ADDR``,
``PMDT_WORLD_SIZE`` = M, ``PMDT_RANK``) each process is one rank. Every
rank builds the model, keeps its shard
(:func:`.inference.tp.shard_params_for_tp_decode`) and runs the same
engine on a ``(1, M)`` grid; rank 0 alone reads the request source,
sends each step's submissions and their outcomes to the other ranks
over the rendezvous store before the step (no collective waits on a
quiet ``--stdin``), streams tokens and writes ``--metrics_out``. The
snapshot then carries ``tp``, a rank's resident param bytes beside
JAX's per-device bytes, its KV pool bytes, the all-gathers a decode
step and the decode kernels' launches on rank 0.

Fault tolerance, as the JAX CLI's: SIGTERM drains (admission closes,
in-flight requests finish up to ``--drain_deadline_s``, overdue ones
fail named, exit 0); ``--journal wal.jsonl`` journals every admitted
request and its tokens, so a re-run of the same command (after a kill)
or a restart redelivers the unfinished ones token-exact and skips the
source's requests the journal already knows; ``--max_restarts N
--restart_backoff S`` rebuilds the engine after a named fatal and
replays the journal. Redelivery is exact for greedy decode only (the
engine refuses a journal with ``--temperature``); in f32 the streams
replay exactly, and in bf16 a stream whose replay diverges (another
batch mix may pick another GEMM) stops with the journal's named error,
never with other tokens. A real device fault (a hung kernel, an illegal
address) leaves the CUDA context unusable: the in-process restarts fail
until ``RestartBudgetExhausted``, and recovery is a new process over
the journal. Under ``--tp M > 1``, ``--journal``, ``--max_restarts``
and ``--drain_deadline_s`` are refused, and SIGTERM is not a drain.

The snapshot is the last engine's, as the JAX CLI's (after a restart,
the rebuilt engine's counters, ``requests_redelivered`` among them; its
``decode_passes_by_k`` and ``decode_launches`` too); ``restarts`` and
``drain_s`` are the run's, and ``attempts`` lists every engine the run
built, a crashed one's too, with its decode passes and the decode
kernels' launches.

Observability, as the JAX CLI's (:mod:`.runtime.scope`), on the
one-card drive loop and on ``--tp`` rank 0: ``--trace_out`` (a
Chrome/Perfetto trace), ``--events_out`` (the event log, with one
``request.timeline`` record per terminal request), ``--flight_path``
(the flight recorder's dump on a fatal) and ``--stats_port``
(``/metrics``, ``/snapshot.json``, ``/events.json`` and ``/healthz``,
200 while the engine is READY, served while each engine serves; the
serving meters beside the ``hbm_*`` ledger and the ``goodput_*``
gauges, which the final snapshot carries too).

The JAX CLI's fleet, wire and autoscale flags are rejected with a
message naming ROADMAP.md.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .device import resolve_device
from .inference.tp import check_mesh, shard_params_for_tp_decode
from .models import get_model
from .ops.decode_attention import (decode_attention,
                                   paged_decode_attention,
                                   paged_verify_decode_attention,
                                   verify_decode_attention)
from .parallel import dist
from .parallel.mesh import Grid, make_grid
from .runtime import fleet, hbm, heal, telemetry
from .runtime import scope as graftscope
from .serving import (QueueFull, Request, ServingEngine, init_params,
                      load_params)
from .serving.scheduler import FAILED

# flags of the JAX CLI the port does not have yet
NOT_PORTED_FLAGS = (
    "--replicas", "--role", "--router_port", "--listen", "--rid",
    "--connect", "--fleet_store", "--fleet_run", "--fleet_ttl",
    "--autoscale", "--rollout",
)
# the heal flags a --tp run refuses (clock-driven decisions would have
# to travel in the store lockstep)
TP_REFUSED = ("--journal", "--max_restarts", "--drain_deadline_s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA continuous-batching LM serving")
    p.add_argument('--model', default='gpt_tiny', type=str,
                   help='gpt_tiny | gpt_small | gpt_medium')
    p.add_argument('--ckpt', default='', type=str,
                   help='model_<epoch>.pth of the port\'s train_lm, an '
                        'orbax run directory (train_lm --save_path), or '
                        'an .npz of the flattened JAX param tree')
    p.add_argument('--ckpt_backend', default='auto',
                   choices=['auto', 'msgpack', 'orbax'])
    p.add_argument('--ckpt_epoch', default=None, type=int,
                   help='orbax only: serve a specific epoch '
                        '(default latest)')
    p.add_argument('--random_init', action='store_true',
                   help='serve fresh random params from --seed')
    p.add_argument('--device', default='cuda', type=str,
                   help="torch device (default cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument('--max_slots', default=4, type=int,
                   help='concurrent requests decoded per step')
    p.add_argument('--s_max', default=0, type=int,
                   help='per-slot token capacity (0 = max_seq_len)')
    p.add_argument('--max_queue', default=0, type=int,
                   help='queued-request bound (0 = unbounded)')
    p.add_argument('--decode_buckets', default='auto', type=str,
                   help="decode window ladder: 'auto', 'off' or sizes "
                        "'64,128,512'")
    p.add_argument('--prefill_chunk', default=0, type=int,
                   help='admit prompts in chunks of N tokens, one chunk '
                        'per engine step between decode horizons (0 = '
                        'whole-prompt prefill-on-join)')
    p.add_argument('--decode_horizon', default=1, type=int,
                   help='fuse up to H decode steps per token readback')
    p.add_argument('--decode_attn', default='auto',
                   choices=['auto', 'cuda', 'torch'],
                   help='decode attention: the CUDA kernel (cuda), the '
                        'plain PyTorch version on the CPU (torch), or '
                        'by device (auto)')
    p.add_argument('--kv_layout', default='dense',
                   choices=['dense', 'paged'],
                   help='KV cache layout: dense slots (s_max columns per '
                        'slot) or pages behind a per-slot page table (a '
                        'request pins ceil(total/page_size) pages; '
                        'token-exact with dense)')
    p.add_argument('--page_size', default=0, type=int,
                   help='paged: columns per KV page (0 = min_bucket)')
    p.add_argument('--num_pages', default=0, type=int,
                   help='paged: total pages incl. the scratch page (0 = '
                        'the dense worst case)')
    p.add_argument('--kv_dtype', default='model',
                   choices=['model', 'int8'],
                   help='KV elements: model dtype, or int8 lanes plus one '
                        'f32 scale per head_dim group')
    p.add_argument('--prefix_cache', default=0, type=int,
                   help='paged + greedy: LRU entries of the shared-prefix '
                        'cache (identical prompts prefill once; 0 = off)')
    p.add_argument('--draft_k', default=0, type=int,
                   help='speculative decode: up to K draft tokens '
                        'verified per target pass (0 = off; greedy '
                        'only). Self-drafting n-gram tables unless '
                        '--draft_model is given')
    p.add_argument('--draft_model', default='', type=str,
                   help='registry name of a small draft GPT proposing '
                        'the drafts (must share the vocab; random '
                        'weights from --seed + 1 unless --draft_ckpt)')
    p.add_argument('--draft_ckpt', default='', type=str,
                   help='params for --draft_model (read as --ckpt)')
    p.add_argument('--max_new_tokens', default=32, type=int)
    p.add_argument('--eos', default=-1, type=int,
                   help='stop token id (-1 = none)')
    p.add_argument('--tp', default=1, type=int,
                   help='model-axis size: serve on M ranks, one per card, '
                        'each holding its heads of the KV pool and its '
                        'share of the weights (--device cpu: gloo ranks)')
    p.add_argument('--temperature', default=0.0, type=float)
    p.add_argument('--top_k', default=0, type=int)
    p.add_argument('--top_p', default=0.0, type=float)
    p.add_argument('--seed', default=0, type=int)
    p.add_argument('--dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--requests', default='', type=str,
                   help='JSON Lines request file')
    p.add_argument('--stdin', action='store_true',
                   help='read one byte-level prompt per stdin line')
    p.add_argument('--synthetic', default=0, type=int,
                   help='serve N synthetic prompts (default 8 when no '
                        'other source is given)')
    p.add_argument('--metrics_out', default='', type=str,
                   help='write the final metrics snapshot as JSON')
    p.add_argument('--quiet', action='store_true',
                   help='suppress per-token streaming lines')
    p.add_argument('--drain_deadline_s', default=0.0, type=float,
                   help='graceful-drain bound: on SIGTERM (or source '
                        'exhaustion) in-flight requests get this many '
                        'seconds to finish; overdue ones are FAILED '
                        'named, then the engine exits 0 '
                        '(0 = unbounded drain)')
    p.add_argument('--journal', default='', type=str, metavar='JSONL',
                   help='request-redelivery WAL: admitted-but-'
                        'unfinished requests are journaled (fsync\'d '
                        'appends, atomic compaction) and a restarted '
                        'engine re-submits them token-exact — the '
                        'supervised-restart recovery path (greedy '
                        'decode only)')
    p.add_argument('--max_restarts', default=0, type=int,
                   help='supervised restart budget: catch named-fatal '
                        'errors (GraftFaultError family), rebuild the '
                        'engine, replay the --journal, and keep '
                        'serving — at most N times, with exponential '
                        '--restart_backoff (0 = die on first fatal)')
    p.add_argument('--restart_backoff', default=1.0, type=float,
                   help='first-restart delay in seconds (doubles per '
                        'restart, capped at 30s)')
    graftscope.add_cli_args(p, stats_port=True)
    return p


def _load_requests(args, vocab_size, skipped):
    """Yield ``(prompt_ids, max_new_tokens)`` from the selected source
    (the JAX CLI's generator, line for line); malformed jsonl lines are
    appended to ``skipped``."""
    if args.requests:
        with open(args.requests) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    if "prompt" in obj:
                        ids = [int(t) for t in obj["prompt"]]
                    elif "text" in obj:
                        ids = [min(b, vocab_size - 1)
                               for b in obj["text"].encode("utf-8")]
                    else:
                        raise ValueError("needs 'prompt' or 'text'")
                    max_new = int(obj.get("max_new_tokens",
                                          args.max_new_tokens))
                except (ValueError, TypeError, AttributeError) as e:
                    skipped.append(f"line {lineno}: {e}")
                    continue
                yield ids, max_new
    elif args.stdin:
        for line in sys.stdin:
            line = line.rstrip("\n")
            if line:
                yield ([min(b, vocab_size - 1)
                        for b in line.encode("utf-8")],
                       args.max_new_tokens)
    else:
        n = args.synthetic or 8
        rng = np.random.default_rng(args.seed)
        for i in range(n):
            length = int(rng.integers(4, 24))
            yield (rng.integers(0, vocab_size, (length,)).tolist(),
                   args.max_new_tokens)


def _reject_not_ported(argv: List[str]) -> None:
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            raise SystemExit(
                f"{flag} is not ported to PyTorch yet (ROADMAP.md, 'Port: "
                "serving features still to port'); use the JAX CLI "
                "serve_lm.py for it")


def _launch_counts() -> dict:
    """The decode kernels' launch counters, by variant."""
    counts = {}
    for fn in (decode_attention, paged_decode_attention,
               verify_decode_attention, paged_verify_decode_attention):
        counts[fn.__name__] = fn.launches
        counts[f"{fn.__name__}_int8"] = fn.int8_launches
    return counts


def _attempt(engine: ServingEngine, request: Request) -> str:
    """Submit ``request``; its outcome as :class:`_Lockstep` records it."""
    try:
        engine.enqueue(request)
        return "accepted"
    except QueueFull:
        return "queue full"
    except ValueError:
        return "rejected"


class _Lockstep:
    """Rank 0's request source replayed on every rank of a ``--tp``
    grid. Rank 0 drives it as it drives an engine: it records each
    submission it tries and its outcome (accepted, queue full, rejected)
    and, before each engine step and the final drain, sends those made
    since the last one over the rendezvous store
    (:class:`.parallel.dist.StoreBroadcast`: no collective, so a
    follower waits on a quiet source for as long as it stays quiet). The
    other ranks submit the same requests in the same order, raise unless
    each meets rank 0's outcome (the engine state is the same on every
    rank), and step with it. The liveness gate runs at each step
    boundary and while a rank waits. ``channel`` carries the messages
    (``send``/``recv``, :class:`.parallel.dist.StoreBroadcast`'s)."""

    def __init__(self, engine: ServingEngine, channel):
        self.engine = engine
        self._tried: list = []
        self._channel = channel

    @property
    def eos_id(self):
        return self.engine.eos_id

    @property
    def health(self):
        return self.engine.health

    @property
    def in_flight(self):
        return self.engine.in_flight

    def enqueue(self, request: Request) -> Request:
        entry = [list(request.prompt), request.max_new_tokens, request.uid,
                 "accepted"]
        self._tried.append(entry)
        try:
            return self.engine.enqueue(request)
        except QueueFull:
            entry[3] = "queue full"
            raise
        except ValueError:
            entry[3] = "rejected"
            raise

    def _sync(self, final: bool) -> None:
        dist.gate_collectives()
        self._channel.send({"tried": self._tried, "final": final})
        self._tried = []

    def step(self):
        self._sync(False)
        return self.engine.step()

    def drain(self, deadline_s=None):
        self._sync(True)
        return self.engine.drain(deadline_s)

    def follow(self) -> None:
        """A rank other than 0: replay rank 0's submissions and steps
        until its drain."""
        engine = self.engine
        while True:
            msg = self._channel.recv(idle=dist.gate_collectives)
            dist.gate_collectives()
            for prompt, max_new, uid, want in msg["tried"]:
                got = _attempt(engine, Request(prompt, max_new,
                                               engine.eos_id, uid=uid))
                if got != want:
                    raise RuntimeError(
                        f"rank {dist.get_rank()} left rank 0's lockstep: "
                        f"request {uid} was {got} here and {want} on "
                        "rank 0")
            if msg["final"]:
                engine.drain()
                return
            engine.step()


def _pumped(source, idle, every_s: float = 0.1):
    """``source``'s items, read on a thread of their own; ``idle()``
    runs every ``every_s`` while the source keeps the caller waiting
    (``--tp --stdin``: rank 0's liveness gate keeps beating)."""
    box: queue.Queue = queue.Queue()

    def pump():
        try:
            for item in source:
                box.put((True, item))
            box.put((False, None))
        except BaseException as e:  # re-raised on the caller's thread
            box.put((False, e))

    threading.Thread(target=pump, daemon=True).start()
    while True:
        try:
            more, item = box.get(timeout=every_s)
        except queue.Empty:
            idle()
            continue
        if more:
            yield item
        elif item is None:
            return
        else:
            raise item


def _join_grid(args, device: torch.device) -> Grid:
    """Join the ``PMDT_*`` group of ``--tp`` ranks and lay it out as the
    ``(1, M)`` grid; a rank's card is ``cuda:{rank}``."""
    world = os.environ.get("PMDT_WORLD_SIZE")
    if world is None or int(world) != args.tp:
        raise SystemExit(
            f"--tp {args.tp} serves on {args.tp} ranks but "
            f"PMDT_WORLD_SIZE={world} (one rank per card; the port has no "
            "data axis)")
    _check_cards(args.tp, device)
    dist.init_process(device)
    return make_grid(1, args.tp)


def _check_cards(tp: int, device: torch.device) -> None:
    if device.type == "cuda" and torch.cuda.device_count() < tp:
        raise SystemExit(
            f"--tp {tp} needs {tp} CUDA devices (one rank per card: NCCL "
            f"cannot put two ranks on one), this machine has "
            f"{torch.cuda.device_count()}; pass --device cpu for gloo ranks "
            "on the CPU")


def _rank_main(argv: List[str]) -> dict:
    """One rank started by :func:`main`'s spawn (rank 0 reads the
    parent's standard input under ``--stdin``)."""
    return serve(build_parser().parse_args(argv))


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    final metrics snapshot (rank 0's under ``--tp``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    _reject_not_ported(argv)
    args = build_parser().parse_args(argv)
    _check_args(args)
    if args.tp == 1 or os.environ.get("PMDT_MASTER_ADDR"):
        return serve(args)
    _check_cards(args.tp, resolve_device(args.device))
    return dist.spawn_ranks(_rank_main, args.tp, argv)


def _check_args(args) -> None:
    """The CLI's refusals, before any rank starts or any model work."""
    if args.ckpt and args.random_init:
        raise SystemExit("--ckpt and --random_init are mutually exclusive")
    if not args.ckpt and not args.random_init:
        raise SystemExit("pass --ckpt PATH (.npz params) or --random_init "
                         "(smoke run)")
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.tp > 1:
        for flag in TP_REFUSED:
            if getattr(args, flag[2:]):
                raise SystemExit(
                    f"{flag} is not ported to PyTorch under --tp {args.tp} "
                    "yet (ROADMAP.md, 'Port: serving features still to "
                    "port'): its decisions would have to travel in the "
                    "ranks' store lockstep")
        # the engine's check, in its words, before any rank starts
        check_mesh(Grid(1, args.tp), get_model(args.model).num_heads,
                   "TP serving")
    # speculative decode: loud rejection before any model work
    if args.draft_k and args.temperature > 0:
        raise SystemExit(
            "--draft_k (speculative decode) is greedy-only: drop "
            "--temperature or disarm speculation")
    if args.draft_model and not args.draft_k:
        raise SystemExit("--draft_model needs --draft_k > 0")


def _attempt_counts(engine: ServingEngine, launches0: dict) -> dict:
    """One engine's decode passes by realised draft length (0 = plain
    decode) and the decode kernels' launches since ``launches0``, taken
    just before it was built."""
    now = _launch_counts()
    return {"decode_passes_by_k": {str(k): n for k, n in
                                   sorted(engine.passes_by_k.items())},
            "decode_launches": {name: now[name] - launches0[name]
                                for name in now}}


def _drive(args, vocab_size, build_engine, emit, rejected, skipped, served,
           attempts, tp: bool):
    """Rank 0's drive loop, as JAX's ``serve_once``: each attempt builds
    an engine over the journal, redelivers its unfinished requests,
    serves the source and drains; under ``--max_restarts`` a
    :class:`.runtime.heal.Supervisor` runs the attempts. Under ``--tp``
    the one attempt feeds a :class:`_Lockstep` in place of the engine
    (no journal, restarts or drain handler there). Each attempt's
    :func:`_attempt_counts` go to ``attempts``. Returns (the last
    engine, the restarts, the drain's seconds)."""
    # one source across restarts: a request taken from it before a
    # crash is in the journal (redelivered), the rest stay unread;
    # uids src-<i> count across attempts, so a re-run of the whole
    # process skips what the journal already knows
    source = _load_requests(args, vocab_size, skipped)
    if tp and args.stdin:
        # rank 0's liveness gate keeps beating on a quiet stdin
        source = _pumped(source, dist.gate_collectives)
    src_idx = [0]
    # the one item taken from the source but not yet admitted, kept
    # across a crash (the source never yields it again)
    pending_src = [None]
    drain_s = [0.0]

    def _serve_source(feed, engine, journal):
        """Redeliver the journal, serve the source while READY, drain."""
        if journal is not None:
            replay_events: list = []
            served.extend(engine.redeliver(
                journal.unfinished(), events_out=replay_events))
            emit(replay_events)
        while not feed.health.draining:
            if pending_src[0] is None:
                try:
                    prompt, max_new = next(source)
                except StopIteration:
                    break
                pending_src[0] = (f"src-{src_idx[0]}", prompt,
                                  max_new)
                src_idx[0] += 1
            uid, prompt, max_new = pending_src[0]
            if journal is not None and journal.known(uid):
                pending_src[0] = None  # served or redelivered
                continue
            request = Request(prompt, max_new, feed.eos_id, uid=uid)
            handled = False
            while True:
                try:
                    feed.enqueue(request)
                    served.append(request)
                    handled = True
                    break
                except QueueFull:
                    if feed.health.draining:
                        break  # stays pending for a restart
                    # bounded queue + finite source =
                    # backpressure: serve a step, then re-enqueue
                    # the same request (its TTFT keeps the first
                    # attempt's submit stamp)
                    emit(feed.step())
                except ValueError as e:
                    rejected[0] += 1
                    print(f"rejected: {e}", file=sys.stderr)
                    handled = True  # never valid
                    break
            if handled:
                pending_src[0] = None
            if feed.health.draining:
                break
            if args.stdin:
                emit(feed.step())  # online: serve while reading
        # serve while READY, then the terminal drain: finish up to
        # the deadline, fail the overdue named, compact the
        # journal (empty after a clean drain), land DEAD
        while feed.in_flight and not feed.health.draining:
            emit(feed.step())
        t0 = time.perf_counter()
        emit(feed.drain(args.drain_deadline_s or None))
        drain_s[0] = time.perf_counter() - t0

    def serve_once(attempt):
        """One engine: built (replaying the journal's unfinished
        requests), fed from the source, drained. SIGTERM flips it to
        DRAINING; a named fatal propagates to the supervisor."""
        if attempt:
            # the crashed engine is unreachable but held in reference
            # cycles: collect it, so its KV pool is freed before the
            # next one is allocated
            gc.collect()
        journal = (heal.RequestJournal(args.journal) if args.journal
                   else None)
        launches0 = _launch_counts()
        engine = build_engine(journal)
        if attempt:
            print(f"graftheal: restart {attempt}: engine rebuilt"
                  + (f", replaying {len(journal.unfinished())} "
                     f"journaled request(s)" if journal else ""),
                  flush=True)
        feed = (_Lockstep(engine, dist.StoreBroadcast("serve_lm/steps"))
                if tp else engine)
        prev_handler = None if tp else heal.install_drain_handler(engine)
        stats_server = None
        if args.stats_port:
            def live():
                snap = engine.metrics.snapshot()
                if hbm.active_ledger() is not None:
                    snap["hbm_per_slot_bytes"] = engine.pool.per_slot_bytes
                return snap

            stats_server = telemetry.start_stats(
                args.stats_port, live, engine.health, prefix="pmdt_serving")
        try:
            with graftscope.flight_recorder("serve_lm drive loop"):
                _serve_source(feed, engine, journal)
        finally:
            if not tp:
                heal.restore_drain_handler(prev_handler)
            telemetry.stop_stats(stats_server)
            # a crashed engine is counted here and then dropped
            attempts.append(_attempt_counts(engine, launches0))
        return engine

    if not args.max_restarts:
        return serve_once(0), 0, drain_s[0]
    supervisor = heal.Supervisor(serve_once,
                                 max_restarts=args.max_restarts,
                                 backoff_s=args.restart_backoff)
    engine = supervisor.run()
    return engine, supervisor.restarts, drain_s[0]


def serve(args) -> dict:
    """One rank of the CLI (the only one without ``--tp``): build the
    model and the engine, serve the source, return the snapshot."""
    device = resolve_device(args.device)
    grid = _join_grid(args, device) if args.tp > 1 else None
    primary = dist.is_primary()
    if primary:
        # armed before the engine exists, so its pool and params land
        # on the ledger and its admission spans on the timeline
        telemetry.arm_from_args(args)
    if grid is not None:
        device = dist.device_for_rank(device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    model = get_model(args.model, dtype=dtype)
    if args.random_init:
        params = init_params(model, args.seed, device)
    else:
        params = {k: v.to(device) for k, v in load_params(
            model, args.ckpt, args.ckpt_backend, args.ckpt_epoch).items()}
    model.load_state_dict(params, assign=True)
    del params
    if grid is not None:
        # this rank's shard; the whole params go with the model
        model = shard_params_for_tp_decode(model, grid)

    if args.decode_buckets == 'auto':
        decode_buckets = None
    elif args.decode_buckets == 'off':
        decode_buckets = ()
    else:
        decode_buckets = [int(b) for b in args.decode_buckets.split(',')]
    draft_model = draft_params = None
    if args.draft_k and args.draft_model:
        draft_model = get_model(args.draft_model, dtype=dtype,
                                vocab_size=model.vocab_size)
        if args.draft_ckpt:
            draft_params = load_params(draft_model, args.draft_ckpt)
        else:
            draft_params = init_params(draft_model, args.seed + 1, device)
    generator = None
    if args.temperature > 0:
        # one seed on every rank: the same logits draw the same token
        generator = torch.Generator(device=device).manual_seed(args.seed)
    def build_engine(journal=None):
        return ServingEngine(
            model, mesh=grid, max_slots=args.max_slots,
            s_max=args.s_max or None,
            max_queue=args.max_queue or None,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, generator=generator,
            eos_id=None if args.eos < 0 else args.eos,
            decode_buckets=decode_buckets,
            decode_horizon=args.decode_horizon,
            decode_attn=args.decode_attn,
            prefill_chunk=args.prefill_chunk or None,
            kv_layout=args.kv_layout, kv_dtype=args.kv_dtype,
            page_size=(args.page_size or None
                       if args.kv_layout == 'paged' else None),
            num_pages=(args.num_pages or None
                       if args.kv_layout == 'paged' else None),
            prefix_cache=(args.prefix_cache
                          if args.kv_layout == 'paged' else 0),
            draft_k=args.draft_k, draft_model=draft_model,
            draft_params=draft_params, journal=journal)

    def emit(events):
        if args.quiet or not primary:
            return
        for request, token, finished in events:
            print(f"req={request.uid} tok={token}"
                  + (f" done({request.finish_reason})" if finished
                     else ""), flush=True)
            if finished:
                print(f"req={request.uid} tokens={request.tokens}",
                      flush=True)

    rejected = [0]
    skipped: List[str] = []
    # every request an engine took, redelivered ones too (by uid the last
    # record stands: a restart leaves the crashed engine's stale one)
    served: List[Request] = []
    attempts: List[dict] = []  # each engine's passes and launches
    restarts, drain_s = 0, 0.0
    if primary:
        engine, restarts, drain_s = _drive(
            args, model.vocab_size, build_engine, emit, rejected, skipped,
            served, attempts, tp=grid is not None)
        for msg in skipped:
            print(f"rejected: {msg}", file=sys.stderr)
        for request in {r.uid: r for r in served}.values():
            # one lifecycle record per terminal request (by uid the
            # last record stands: a restart leaves a stale one)
            graftscope.emit("request.timeline", cat="request",
                            **request.timeline())
            if request.state == FAILED:
                print(f"failed: req={request.uid} "
                      f"reason={request.finish_reason} "
                      f"{type(request.error).__name__}: {request.error}",
                      file=sys.stderr, flush=True)
    else:
        launches0 = _launch_counts()
        engine = build_engine()
        _Lockstep(engine, dist.StoreBroadcast("serve_lm/steps")).follow()
        attempts.append(_attempt_counts(engine, launches0))

    snap = engine.metrics.snapshot()
    snap["rejected"] = rejected[0] + len(skipped)
    snap["restarts"] = restarts
    snap["drain_s"] = drain_s
    snap["decode_buckets"] = list(engine.decode_buckets)
    snap["decode_windows"] = list(engine.decode_windows)
    snap["decode_horizon"] = engine.decode_horizon
    snap["decode_programs"] = [list(p) for p in engine.decode_programs]
    snap["draft_k"] = engine.draft_k
    snap["spec_programs"] = [list(p) for p in engine.spec_programs]
    # the last engine's, as the rest of the snapshot; each engine the
    # run built (a crashed one's too) under "attempts"
    snap.update(attempts[-1])
    snap["attempts"] = attempts
    pool = engine.pool
    snap["kv_layout"], snap["kv_dtype"] = args.kv_layout, args.kv_dtype
    if args.kv_layout == 'paged':
        snap["page_size"] = pool.page_size
        snap["num_pages"] = pool.num_pages
        # after the drain, the prefix cache's entries are the only
        # holders of pages left
        snap["pages_in_use"] = pool.pages_in_use
        snap["prefix_cache_pages"] = (
            len(engine._prefix_cache.page_ids())
            if engine._prefix_cache is not None else 0)
    snap["kv_pool_bytes"] = pool.kv_bytes  # a rank's; spare columns in
    if hbm.active_ledger() is not None:
        snap.update(hbm.active_ledger().snapshot())
        snap["hbm_per_slot_bytes"] = pool.per_slot_bytes
    snap.update(fleet.goodput_gauges())
    snap["device"] = str(device)
    snap["tp"] = args.tp
    if grid is not None:
        tp = engine.model.tp
        snap["param_bytes"] = tp.resident_bytes["params"]
        snap["jax_param_bytes"] = tp.resident_bytes["jax_params"]
        snap["small_leaf_bytes"] = sum(
            tp.resident_bytes["small_leaves"].values())
        snap["tp_gathers"] = tp.gathers
        snap["tp_decode_gathers"] = engine.decode_gathers
    if grid is not None:
        # no rank closes the group (rank 0: its store) while another
        # still talks to it
        dist.barrier()
        dist.destroy_process_group()
    if not primary:
        return snap
    print("metrics: " + json.dumps(snap, sort_keys=True), flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    graftscope.export_from_args(args)
    return snap


if __name__ == "__main__":
    main()
