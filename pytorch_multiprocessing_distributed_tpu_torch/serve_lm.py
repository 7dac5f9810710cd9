"""Continuous-batching LM serving CLI — the port of the JAX package's
``serve_lm.py`` (one engine, ``--tp`` ranks or the in-process fleet),
on the card by default.

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
the journal.

Under ``--tp M > 1`` the same flags hold, through rank 0's lockstep: no
other rank takes a decision from its own clock or disk. Rank 0 alone
writes the journal, reads the clock and takes SIGTERM (the CLI that
spawned the ranks passes its SIGTERM on to rank 0); its messages
carry each attempt's redelivery list, each step's expired uids
(:attr:`.serving.ServingEngine.decisions`), DRAINING at the submission
where it began, and the drain deadline's overdue uids, which the other
ranks apply exactly (or raise). At the end every rank's outcome of each
request (state, reason, token count) is held to rank 0's, and the
snapshot's ``tp_ranks`` lists each rank's completed and failed counts
and its ``attempts``. Under ``--max_restarts`` every rank runs
its own supervisor: a fatal that strikes every rank at the same
dispatch (every rank reads the same ``PMDT_FAULT_PLAN``) rebuilds M
engines at the same pass, each attempt over a channel of its own. A
fatal or a watchdog trip on one rank alone leaves the others in a
gather, where the liveness gate ends the run named.

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

The fleet, as the JAX CLI's in-process one: ``--replicas N`` serves
through N engine replicas on the one card behind a
:class:`.serving.Router` (load- and prefix-aware placement, admission
windows, work stealing, redelivery when a replica dies); ``--role both``
(every replica prefills and decodes), ``split`` (replica 0 only
prefills and hands each block to the decode replicas) or a list
``prefill,decode,decode``; ``--journal`` keeps one WAL a decode-capable
replica (``<journal>.<rid>``); ``--max_restarts`` rebuilds the whole
fleet after a ``FleetDead``; ``--router_port`` serves the merged metrics
(``pmdt_fleet_*``) and the fleet's ``/healthz``. The final ``metrics:``
line is the router's merged snapshot. A fleet under ``--tp M > 1`` is
refused.

The JAX CLI's wire and autoscale flags are rejected with a message
naming ROADMAP.md.
"""

from __future__ import annotations

import argparse
import contextlib
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
from .serving import (QueueFull, Request, Router,
                      ServingEngine, ServingReplica, init_params,
                      load_params)
from .serving.scheduler import FAILED

# flags of the JAX CLI the port does not have yet
NOT_PORTED_FLAGS = (
    "--listen", "--rid", "--connect", "--fleet_store", "--fleet_run",
    "--fleet_ttl", "--autoscale", "--rollout",
)


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
    p.add_argument('--replicas', default=1, type=int,
                   help='serve through an in-process fleet of N engine '
                        'replicas behind one load- and cache-aware '
                        'router: admission windows, work stealing, '
                        'journal redelivery on replica death (1 = the '
                        'single-engine path)')
    p.add_argument('--role', default='both', type=str,
                   help="replica roles: 'both' (every replica prefills "
                        "and decodes), 'split' (replica 0 only prefills "
                        "and hands finished KV blocks to the decode "
                        "replicas; needs --replicas >= 2), or a comma "
                        "list 'prefill,decode,decode' of length "
                        "--replicas (at least one decode-capable role)")
    p.add_argument('--router_port', default=0, type=int,
                   help='serve the router\'s stats: merged fleet '
                        'metrics on /metrics + /snapshot.json, the '
                        'replicas\' states on /healthz (0 = off)')
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
    """Rank 0's request source, clock and disk replayed on every rank of
    a ``--tp`` grid. Rank 0 drives it as it drives an engine: it records
    each submission it tries and its outcome (accepted, queue full,
    rejected) and, before each engine step and the final drain, sends
    those made since the last one over the rendezvous store
    (:class:`.parallel.dist.StoreBroadcast`: no collective, so a
    follower waits on a quiet source for as long as it stays quiet). The
    other ranks submit the same requests in the same order, raise unless
    each meets rank 0's outcome (the engine state is the same on every
    rank), and step with it.

    Rank 0's decisions travel the same way: the journal's redelivery
    list at the start of an attempt (:meth:`redeliver`), each clock
    decision the engine takes inside a step or the drain (its
    ``decisions`` seam: expired uids, the drain deadline's overdue
    uids), and DRAINING: a SIGTERM on rank 0 (:meth:`begin_drain`, the
    drain handler's target) reaches its engine at the next submission
    or step boundary, and a marker at that place in the message flips
    the other ranks there too. The liveness gate runs at each step
    boundary and while a rank waits. ``channel`` carries the messages
    (``send``/``recv``, :class:`.parallel.dist.StoreBroadcast`'s)."""

    def __init__(self, engine: ServingEngine, channel):
        self.engine = engine
        self._tried: list = []
        self._channel = channel
        self._drain_asked: Optional[str] = None
        engine.decisions = self._lead

    @property
    def eos_id(self):
        return self.engine.eos_id

    @property
    def health(self):
        return self.engine.health

    @property
    def in_flight(self):
        return self.engine.in_flight

    def begin_drain(self, reason: str = "drain") -> None:
        """Ask for DRAINING (signal-safe: it only records the reason);
        it takes effect at the next submission or step boundary."""
        if self._drain_asked is None:
            self._drain_asked = reason

    def _apply_drain(self) -> None:
        if self._drain_asked is not None and self.engine.health.ready:
            self.engine.begin_drain(self._drain_asked)
            self._tried.append(["drain", self._drain_asked])

    def enqueue(self, request: Request) -> Request:
        self._apply_drain()
        entry = ["submit", list(request.prompt), request.max_new_tokens,
                 request.uid, request.deadline_s, "accepted"]
        self._tried.append(entry)
        try:
            return self.engine.enqueue(request)
        except QueueFull:
            entry[-1] = "queue full"
            raise
        except ValueError:
            entry[-1] = "rejected"
            raise

    def _lead(self, kind: str, decide):
        """Rank 0's engine decisions: taken here, sent to the others."""
        value = decide()
        self._channel.send({"decide": kind, "value": value})
        return value

    def _sync(self, final: bool, deadline_s=None) -> None:
        self._apply_drain()
        dist.gate_collectives()
        self._channel.send({"tried": self._tried, "final": final,
                            "deadline_s": deadline_s})
        self._tried = []

    def step(self):
        self._sync(False)
        return self.engine.step()

    def drain(self, deadline_s=None):
        self._sync(True, deadline_s)
        return self.engine.drain(deadline_s)

    def redeliver(self, entries, events_out=None):
        """Redeliver the journal's ``entries`` here and on every rank."""
        self._channel.send({"redeliver": [
            [e.uid, list(e.prompt), e.max_new_tokens, e.eos_id,
             list(e.tokens)] for e in entries]})
        return self.engine.redeliver(entries, events_out=events_out)

    def _recv(self):
        msg = self._channel.recv(idle=dist.gate_collectives)
        dist.gate_collectives()
        return msg

    def _replay(self, kind: str, decide):
        """A follower's engine decisions: rank 0's, in order."""
        msg = self._recv()
        if msg.get("decide") != kind:
            raise RuntimeError(
                f"rank {dist.get_rank()} left rank 0's lockstep: its "
                f"engine takes a {kind!r} decision where rank 0 sent "
                f"{sorted(msg)}")
        return msg["value"]

    def follow(self, served: Optional[list] = None) -> None:
        """A rank other than 0: replay rank 0's redelivery, submissions,
        drain marker, steps and decisions until its drain; each request
        its engine takes goes to ``served``."""
        engine = self.engine
        served = [] if served is None else served
        engine.decisions = self._replay
        while True:
            msg = self._recv()
            if "redeliver" in msg:
                entries = []
                for uid, prompt, max_new, eos_id, tokens in msg["redeliver"]:
                    entry = heal.JournalEntry(uid, prompt, max_new, eos_id)
                    entry.tokens = list(tokens)
                    entries.append(entry)
                served.extend(engine.redeliver(entries))
                continue
            if "tried" not in msg:
                raise RuntimeError(
                    f"rank {dist.get_rank()} left rank 0's lockstep: rank "
                    f"0 sent {sorted(msg)} where this rank steps")
            for item in msg["tried"]:
                if item[0] == "drain":
                    engine.begin_drain(item[1])
                    continue
                _, prompt, max_new, uid, deadline_s, want = item
                request = Request(prompt, max_new, engine.eos_id, uid=uid,
                                  deadline_s=deadline_s)
                got = _attempt(engine, request)
                if got == "accepted":
                    served.append(request)
                if got != want:
                    raise RuntimeError(
                        f"rank {dist.get_rank()} left rank 0's lockstep: "
                        f"request {uid} was {got} here and {want} on "
                        "rank 0")
            if msg["final"]:
                engine.drain(msg["deadline_s"])
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
    if _fleet_mode(args):
        if args.tp > 1:
            raise SystemExit(
                f"--replicas/--role under --tp {args.tp} is not ported to "
                "PyTorch yet (ROADMAP.md, 'Port: serving features still "
                "to port'): the in-process fleet serves on one card")
        _fleet_roles(args)


def _fleet_mode(args) -> bool:
    return args.replicas > 1 or args.role != 'both'


def _fleet_roles(args) -> List[str]:
    """The replicas' roles, with the JAX CLI's checks in its order and
    its words."""
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.role == 'both':
        roles = ['both'] * args.replicas
    elif args.role == 'split':
        if args.replicas < 2:
            raise SystemExit(
                "--role split needs --replicas >= 2 (one prefill replica "
                "handing KV blocks to >= 1 decode replica)")
        roles = ['prefill'] + ['decode'] * (args.replicas - 1)
    else:
        roles = [r.strip() for r in args.role.split(',')]
        if len(roles) != args.replicas:
            raise SystemExit(
                f"--role lists {len(roles)} role(s) for --replicas "
                f"{args.replicas}")
    if not any(r in ('both', 'decode') for r in roles):
        raise SystemExit(
            "at least one replica must be decode-capable (role 'both' or "
            "'decode') — a prefill-only fleet can never emit a token")
    return roles


def _attempt_counts(engine: ServingEngine, launches0: dict) -> dict:
    """One engine's decode passes by realised draft length (0 = plain
    decode) and the decode kernels' launches since ``launches0``, taken
    just before it was built."""
    now = _launch_counts()
    return {"decode_passes_by_k": {str(k): n for k, n in
                                   sorted(engine.passes_by_k.items())},
            "decode_launches": {name: now[name] - launches0[name]
                                for name in now}}


def _drive(args, vocab_size, attempt, emit, rejected, skipped, served):
    """Rank 0's drive loop, as JAX's ``serve_once``, for one engine, a
    :class:`_Lockstep` of ``--tp`` ranks or the fleet: each attempt
    builds its feed, redelivers the journal's unfinished requests,
    serves the source and drains; under ``--max_restarts`` a
    :class:`.runtime.heal.Supervisor` runs the attempts. ``attempt(n)``
    is a context manager that builds attempt ``n`` and yields (the feed,
    its journal or None, what the attempt returns, the flight
    recorder's label); the drain handler asks the feed for DRAINING.
    Returns (the last attempt's result, the restarts, the drain's
    seconds)."""
    # one source across restarts: a request taken from it before a
    # crash is in the journal (redelivered), the rest stay unread;
    # uids src-<i> count across attempts, so a re-run of the whole
    # process skips what the journal already knows
    source = _load_requests(args, vocab_size, skipped)
    if args.tp > 1 and args.stdin:
        # rank 0's liveness gate keeps beating on a quiet stdin
        source = _pumped(source, dist.gate_collectives)
    src_idx = [0]
    # the one item taken from the source but not yet admitted, kept
    # across a crash (the source never yields it again)
    pending_src = [None]
    drain_s = [0.0]

    def _serve_source(feed, journal):
        """Redeliver the journal, serve the source while READY, drain."""
        if journal is not None:
            replay_events: list = []
            served.extend(feed.redeliver(
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
                    served.append(feed.enqueue(request))
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

    def serve_once(n):
        """One attempt: built (replaying the journal's unfinished
        requests), fed from the source, drained. SIGTERM flips it to
        DRAINING; a named fatal propagates to the supervisor."""
        if n:
            # the crashed engines are unreachable but held in reference
            # cycles: collect them, so their KV pools are freed before
            # the next ones are allocated
            gc.collect()
        with attempt(n) as (feed, journal, result, label):
            prev_handler = heal.install_drain_handler(feed)
            try:
                with graftscope.flight_recorder(label):
                    _serve_source(feed, journal)
            finally:
                heal.restore_drain_handler(prev_handler)
        return result

    if not args.max_restarts:
        return serve_once(0), 0, drain_s[0]
    supervisor = heal.Supervisor(serve_once,
                                 max_restarts=args.max_restarts,
                                 backoff_s=args.restart_backoff)
    result = supervisor.run()
    return result, supervisor.restarts, drain_s[0]


def _engine_attempts(args, build_engine, attempts, tp: bool):
    """:func:`_drive`'s attempts for one engine: each builds an engine
    over the journal (under ``--tp`` behind a :class:`_Lockstep` over a
    channel of its own) and serves ``--stats_port`` while it runs; its
    :func:`_attempt_counts` go to ``attempts``."""

    @contextlib.contextmanager
    def attempt(n):
        journal = (heal.RequestJournal(args.journal) if args.journal
                   else None)
        launches0 = _launch_counts()
        engine = build_engine(journal)
        if n:
            print(f"graftheal: restart {n}: engine rebuilt"
                  + (f", replaying {len(journal.unfinished())} "
                     f"journaled request(s)" if journal else ""),
                  flush=True)
        feed = (_Lockstep(engine,
                          dist.StoreBroadcast(f"serve_lm/steps/{n}"))
                if tp else engine)
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
            yield feed, journal, engine, "serve_lm drive loop"
        finally:
            telemetry.stop_stats(stats_server)
            # a crashed engine is counted here and then dropped
            attempts.append(_attempt_counts(engine, launches0))

    return attempt


class _FleetFeed:
    """A :class:`.serving.Router` as :func:`_drive` feeds an engine and
    reads its journal: submissions go through fleet placement (a
    ``FleetSaturated`` is the ``QueueFull`` that steps the fleet), and
    the router replays its replicas' journals (``redeliver``); the rest
    (``step``, ``drain``, ``begin_drain``, ``in_flight``, ``known``) is
    the router's own."""

    def __init__(self, router: Router):
        self.router = router
        self.health = router  # the drive loop reads ``health.draining``
        self.eos_id = router.replicas[0].engine.eos_id

    def __getattr__(self, name):
        return getattr(self.router, name)

    def enqueue(self, request: Request) -> Request:
        return self.router.submit(request.prompt, request.max_new_tokens,
                                  uid=request.uid)

    def redeliver(self, entries, events_out=None):
        return self.router.recover(events_out=events_out)

    def unfinished(self) -> list:
        return []  # the router replays each replica's own journal


def _fleet_attempts(args, build_engine, launches):
    """:func:`_drive`'s attempts for the in-process fleet, as the JAX
    CLI's: each builds one replica a role over the card behind a
    :class:`.serving.Router` (each decode-capable replica journaling to
    ``<journal>.<rid>``) and serves ``--router_port`` while it runs; a
    replica's death is absorbed inside the router, and only a
    ``FleetDead`` reaches the supervisor. Each attempt's decode
    launches go to ``launches``."""
    roles = _fleet_roles(args)

    @contextlib.contextmanager
    def attempt(n):
        launches0 = _launch_counts()
        replicas = []
        for i, role in enumerate(roles):
            rid = f"r{i}"
            journal = None
            if args.journal and role != 'prefill':
                journal = heal.RequestJournal(f"{args.journal}.{rid}")
            replicas.append(ServingReplica(rid, build_engine(journal),
                                           role=role, journal=journal))
        router = Router(replicas)
        if n:
            print(f"graftheal: restart {n}: fleet rebuilt "
                  f"({len(replicas)} replica(s))", flush=True)
        stats_server = None
        if args.router_port:
            def fleet_snapshot():
                snap = router.merged_metrics()
                snap.update(fleet.fleet_serving_report(
                    snap.get("per_replica", {})))
                return snap

            stats_server = telemetry.start_stats(
                args.router_port, fleet_snapshot, None, prefix="pmdt_fleet",
                health_fn=router.healthz, label="router stats")
        feed = _FleetFeed(router)
        try:
            yield feed, feed, router, "serve_lm fleet drive loop"
        finally:
            telemetry.stop_stats(stats_server)
            now = _launch_counts()
            launches.append({name: now[name] - launches0[name]
                             for name in now})

    return attempt


def _fleet_snapshot(router, restarts, rejected, launches) -> dict:
    """The fleet's final snapshot: the router's merged metrics under
    JAX's keys, then the port's (restarts, the last fleet's passes and
    decode seconds a replica, the decode kernels' launches over every
    attempt, the roles)."""
    for request in router.records().values():
        graftscope.emit("request.timeline", cat="request",
                        **request.timeline())
    snap = router.merged_metrics()
    snap["rejected"] = rejected
    snap.update(fleet.fleet_serving_report(snap.get("per_replica", {})))
    snap["fleet_state"] = router.healthz()["state_name"]
    snap.update(fleet.goodput_gauges())
    snap["restarts"] = restarts
    snap["decode_passes_by_k_per_replica"] = {
        r.rid: {str(k): n for k, n in sorted(r.engine.passes_by_k.items())}
        for r in router.replicas}
    snap["decode_launches"] = {name: sum(a[name] for a in launches)
                               for name in launches[-1]}
    snap["decode_elapsed_s_per_replica"] = {
        r.rid: r.engine.metrics.decode_elapsed_s for r in router.replicas}
    snap["replicas_roles"] = {r.rid: r.role for r in router.replicas}
    return snap


def _ranks_alike(served, snap, attempts) -> list:
    """Under ``--tp``, on every rank: each request's terminal outcome
    (state, finish reason, token count) gathered from every rank,
    raising unless each rank's equals rank 0's. Returns each rank's
    completed and failed counts and its ``attempts``."""
    mine = {"outcomes": {str(r.uid): [r.state, r.finish_reason,
                                      len(r.tokens)]
                         for r in {r.uid: r for r in served}.values()},
            "requests_completed": snap["requests_completed"],
            "requests_failed": snap["requests_failed"],
            "attempts": attempts}
    ranks = [None] * dist.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    want = ranks[0]["outcomes"]
    for rank, theirs in enumerate(ranks):
        got = theirs.pop("outcomes")
        if got != want:
            differ = sorted(uid for uid in set(got) | set(want)
                            if got.get(uid) != want.get(uid))
            raise RuntimeError(
                f"rank {rank} left rank 0's lockstep: requests {differ} "
                "ended otherwise there than on rank 0")
    return ranks


def _follow(args, build_engine, served, attempts):
    """A ``--tp`` rank other than 0: each attempt builds its engine and
    replays rank 0's lockstep over that attempt's channel; under
    ``--max_restarts`` its own supervisor rebuilds at the same pass as
    rank 0's (the same fault strikes every rank at the same dispatch).
    Returns (the last engine, its restarts)."""

    def follow_once(attempt):
        if attempt:
            gc.collect()  # the crashed engine's pool, before the new one
        launches0 = _launch_counts()
        engine = build_engine()
        try:
            _Lockstep(engine, dist.StoreBroadcast(
                f"serve_lm/steps/{attempt}")).follow(served)
        finally:
            attempts.append(_attempt_counts(engine, launches0))
        return engine

    if not args.max_restarts:
        return follow_once(0), 0
    supervisor = heal.Supervisor(follow_once,
                                 max_restarts=args.max_restarts,
                                 backoff_s=args.restart_backoff)
    return supervisor.run(), supervisor.restarts


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
    if _fleet_mode(args):
        launches: List[dict] = []  # each fleet's decode launches
        router, restarts, _ = _drive(
            args, model.vocab_size,
            _fleet_attempts(args, build_engine, launches), emit, rejected,
            skipped, served)
        for msg in skipped:
            print(f"rejected: {msg}", file=sys.stderr)
        return _finish(args, _fleet_snapshot(
            router, restarts, rejected[0] + len(skipped), launches))
    restarts, drain_s = 0, 0.0
    if primary:
        engine, restarts, drain_s = _drive(
            args, model.vocab_size,
            _engine_attempts(args, build_engine, attempts, grid is not None),
            emit, rejected, skipped, served)
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
        engine, restarts = _follow(args, build_engine, served, attempts)

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
        snap["tp_ranks"] = _ranks_alike(served, snap, attempts)
        # no rank closes the group (rank 0: its store) while another
        # still talks to it
        dist.barrier()
        dist.destroy_process_group()
    if not primary:
        return snap
    return _finish(args, snap)


def _finish(args, snap: dict) -> dict:
    """Print the final snapshot, write ``--metrics_out`` and the
    observability exports; returns ``snap``."""
    print("metrics: " + json.dumps(snap, sort_keys=True), flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    graftscope.export_from_args(args)
    return snap


if __name__ == "__main__":
    main()
