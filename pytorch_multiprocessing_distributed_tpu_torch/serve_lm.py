"""Continuous-batching LM serving CLI — the port of the JAX package's
``serve_lm.py``, single-engine path, on the card by default.

    python -m pytorch_multiprocessing_distributed_tpu_torch.serve_lm \\
        --model gpt_small --random_init --dtype bfloat16 --max_slots 8 \\
        --synthetic 16 --max_new_tokens 32 --decode_horizon 4 \\
        --kv_layout paged --page_size 16 --prefix_cache 8 --kv_dtype int8

Flags keep the JAX CLI's names and meanings for what this slice does;
``--ckpt`` takes an ``.npz`` of the flattened JAX param tree
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
``spec_*`` and ``accept_len_*`` keys. The JAX CLI's fleet, wire,
autoscale, journal, restart, observability and TP flags are rejected
with a message naming ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from .device import resolve_device
from .models import get_model
from .serving import (QueueFull, Request, ServingEngine, init_params,
                      load_params)

# flags of the JAX CLI this slice does not port
NOT_PORTED_FLAGS = (
    "--ckpt_backend", "--ckpt_epoch", "--tp", "--replicas", "--role",
    "--router_port",
    "--listen", "--rid", "--connect", "--fleet_store", "--fleet_run",
    "--fleet_ttl", "--autoscale", "--rollout", "--drain_deadline_s",
    "--journal", "--max_restarts", "--restart_backoff", "--stats_port",
    "--trace_out", "--events_out", "--flight_path",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA continuous-batching LM serving")
    p.add_argument('--model', default='gpt_tiny', type=str,
                   help='gpt_tiny | gpt_small | gpt_medium')
    p.add_argument('--ckpt', default='', type=str,
                   help='.npz of the flattened JAX param tree '
                        '("block_0/attn/wqkv/kernel" keys)')
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
                   help='.npz params for --draft_model (as --ckpt)')
    p.add_argument('--max_new_tokens', default=32, type=int)
    p.add_argument('--eos', default=-1, type=int,
                   help='stop token id (-1 = none)')
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


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    final metrics snapshot."""
    argv = sys.argv[1:] if argv is None else list(argv)
    _reject_not_ported(argv)
    args = build_parser().parse_args(argv)
    if args.ckpt and args.random_init:
        raise SystemExit("--ckpt and --random_init are mutually exclusive")
    if not args.ckpt and not args.random_init:
        raise SystemExit("pass --ckpt PATH (.npz params) or --random_init "
                         "(smoke run)")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    model = get_model(args.model, dtype=dtype)
    if args.random_init:
        params = init_params(model, args.seed, device)
    else:
        params = {k: v.to(device) for k, v in load_params(args.ckpt).items()}
    model.load_state_dict(params, assign=True)

    if args.decode_buckets == 'auto':
        decode_buckets = None
    elif args.decode_buckets == 'off':
        decode_buckets = ()
    else:
        decode_buckets = [int(b) for b in args.decode_buckets.split(',')]
    # speculative decode: loud rejection before any model work
    if args.draft_k and args.temperature > 0:
        raise SystemExit(
            "--draft_k (speculative decode) is greedy-only: drop "
            "--temperature or disarm speculation")
    if args.draft_model and not args.draft_k:
        raise SystemExit("--draft_model needs --draft_k > 0")
    draft_model = draft_params = None
    if args.draft_k and args.draft_model:
        draft_model = get_model(args.draft_model, dtype=dtype,
                                vocab_size=model.vocab_size)
        if args.draft_ckpt:
            draft_params = load_params(args.draft_ckpt)
        else:
            draft_params = init_params(draft_model, args.seed + 1, device)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=device).manual_seed(args.seed)
    engine = ServingEngine(
        model, max_slots=args.max_slots, s_max=args.s_max or None,
        max_queue=args.max_queue or None, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, generator=generator,
        eos_id=None if args.eos < 0 else args.eos,
        decode_buckets=decode_buckets, decode_horizon=args.decode_horizon,
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
        draft_params=draft_params)

    def emit(events):
        if args.quiet:
            return
        for request, token, finished in events:
            print(f"req={request.uid} tok={token}"
                  + (f" done({request.finish_reason})" if finished
                     else ""), flush=True)
            if finished:
                print(f"req={request.uid} tokens={request.tokens}",
                      flush=True)

    rejected = 0
    skipped: List[str] = []
    for i, (prompt, max_new) in enumerate(
            _load_requests(args, model.vocab_size, skipped)):
        request = Request(prompt, max_new, engine.eos_id, uid=f"src-{i}")
        while True:
            try:
                engine.enqueue(request)
                break
            except QueueFull:
                # bounded queue + finite source = backpressure: serve a
                # step, then re-enqueue the same request (its TTFT keeps
                # the first attempt's submit stamp)
                emit(engine.step())
            except ValueError as e:
                rejected += 1
                print(f"rejected: {e}", file=sys.stderr)
                break
        if args.stdin:
            emit(engine.step())  # online source: serve while reading
    emit(engine.drain())
    for msg in skipped:
        print(f"rejected: {msg}", file=sys.stderr)

    snap = engine.metrics.snapshot()
    snap["rejected"] = rejected + len(skipped)
    snap["decode_buckets"] = list(engine.decode_buckets)
    snap["decode_windows"] = list(engine.decode_windows)
    snap["decode_horizon"] = engine.decode_horizon
    snap["decode_programs"] = [list(p) for p in engine.decode_programs]
    snap["draft_k"] = engine.draft_k
    snap["spec_programs"] = [list(p) for p in engine.spec_programs]
    # decode passes by realised draft length (0 = plain decode): what
    # the kernels' launch counts follow
    snap["decode_passes_by_k"] = {str(k): n for k, n in
                                  sorted(engine.passes_by_k.items())}
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
        snap["kv_pool_bytes"] = pool.kv_bytes
    else:
        snap["kv_pool_bytes"] = pool.kv_bytes  # spare columns included
    snap["device"] = str(device)
    print("metrics: " + json.dumps(snap, sort_keys=True), flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    return snap


if __name__ == "__main__":
    main()
