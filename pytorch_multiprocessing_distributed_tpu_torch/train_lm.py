"""Language-model training CLI — the port of the JAX package's
``train_lm.py`` in its four ``--parallel`` modes (``dp``, ``sp``,
``tp``, ``pp``), on the card by default.

    python -m pytorch_multiprocessing_distributed_tpu_torch.train_lm \\
        --model gpt_small --dtype bfloat16 --batch_size 8 --seq_len 1024 \\
        --epochs 1 --save_path /tmp/lm

Flags keep the JAX CLI's names, meanings and order of checks, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Artifacts are the JAX CLI's: the ``Epoch: [e][i/n]`` print lines,
``train.log`` rows ``[epoch, avg loss, exp(min(avg, 20))]``,
``test.log`` under ``--val_frac``, ``model_{epoch}.pth`` checkpoints
(the port's own payload, see :mod:`.train.checkpoint`) with ``.sha256``
sidecars, ``--resume PATH|auto`` and a greedy ``--sample`` (beam search
of ``--sample_beams`` beams, the best printed).

One process per rank, with the JAX package's env contract
(``PMDT_MASTER_ADDR``, ``PMDT_WORLD_SIZE``, ``PMDT_RANK``;
:mod:`.parallel.dist`): NCCL on the cards, gloo on the CPU. Under
``--parallel dp`` each rank trains on its rows of the global
``--batch_size``. ``--parallel sp --degree N --sp_mode
ring|zigzag|ulysses`` lays the ranks out as JAX's ``(data, seq)`` mesh,
``world / N`` by ``N`` row-major (rank ``r`` at data index ``r // N``,
seq index ``r % N``): a rank takes its data index's rows and its seq
index's columns, attention runs over the ring (or Ulysses' all-to-all)
of its seq group, and gradients are summed over every rank.
``--vocab_chunks K`` streams the head and CE over K vocab slices.
``--parallel tp --degree M [--zero1|--fsdp]`` lays them out as JAX's
``(data, model)`` mesh: each rank holds its slices of the state under
JAX's GSPMD placements (:mod:`.train.placement`), gathers each weight
at use and reduces its gradient over ``data`` into its moment slice.
``--parallel pp --degree N --pp_schedule gpipe|1f1b`` lays them out as
``(data, pipe)``: rank ``r`` is stage ``r % N`` of data replica ``r //
N``, holding that stage's blocks and vocab slices
(:mod:`.parallel.gpt_pipeline`); its checkpoints carry JAX's stacked
tree. ``--zero`` (``dp`` only) shards the moments and the update
(:mod:`.parallel.zero`); ``--remat`` (``dp``, ``sp``, ``tp``)
recomputes the forward in the backward. ``--n_experts E [--moe_top_k
K]`` trains a Mixture-of-Experts GPT (:mod:`.ops.moe`) in any of the
four modes, against the balance loss (``--moe_aux_weight``) and the
router z-loss, and prints its ``Aux`` column; ``--sample`` decodes it
droplessly.

``--ckpt_backend orbax`` writes sharded checkpoints under
``{save_path}/orbax/<epoch>/`` (each rank its own slices, in every
``--parallel`` mode but ``--zero``; :mod:`.train.orbax_ckpt`), restored
before any placement; ``--ckpt_async`` writes the periodic ones in the
background. ``--max_restarts N [--restart_backoff S]`` runs the CLI
under :class:`.runtime.heal.Supervisor`: a named fatal tears the group
down and restarts with ``--resume auto``. At every print boundary the
liveness gate runs (:func:`.parallel.dist.gate_collectives`): under
``PMDT_HEARTBEAT`` a lost peer is a named ``PeerLostError``.

The observability flags are JAX's (:mod:`.runtime.scope`):
``--trace_out``, ``--events_out``, ``--flight_path`` and
``--stats_port`` (rank ``r`` serves on the port plus ``r``). The loop
emits JAX's spans at its boundaries: ``train.data`` (the wait for the
next batch), ``train.h2d`` (``tp``/``pp``: the batch upload),
``train.metrics_fetch`` (the print boundary's sync), ``train.window``,
``train.step_skipped``, ``train.validate`` and ``train.checkpoint``;
the clock reads they take happen only while a scope is armed.

``--hf_init PATH`` starts from an HF GPT-2 ``state_dict`` file and
``--hf_export`` writes ``model_{epochs}.hf.pth`` after training
(:mod:`.utils.gpt_interop`); either builds the GPT-2 configuration
(LayerNorm eps 1e-5, no head bias), as JAX does.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .data import TokenLoader, synthetic_tokens
from .device import resolve_device
from .models import get_model
from .ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
from .parallel import dist
from .parallel.gpt_pipeline import (create_pipelined_lm_state,
                                    make_pipelined_lm_eval_step,
                                    make_pipelined_lm_train_step,
                                    unstack_pipeline_params)
from .parallel.mesh import make_grid
from .runtime import heal, telemetry
from .runtime import scope as graftscope
from .parallel.ulysses import _check_heads
from .parallel.zero import plan_buckets, zeroify_state
from .serving.params import init_params
from .train import (create_lm_train_state, local_rows, make_lm_eval_step,
                    make_lm_eval_step_tp, make_lm_train_step,
                    make_lm_train_step_tp, to_device)
from .train.lm import seq_columns
from .train.placement import plan_placement, shard_state
from .train.checkpoint import (checkpoint_epoch, load_checkpoint,
                               load_with_fallback, prune_checkpoints,
                               resolve_auto_resume, save_checkpoint)
from .train.optim import cosine_lr, sgd
from .train.step import register_state_hbm
from .utils import Logger, throughput
from .utils.gpt_interop import (GPT2_LN_EPS, load_gpt2_checkpoint,
                                save_gpt2_checkpoint)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA GPT training (data and sequence parallel)")
    p.add_argument('--model', default='gpt_tiny', type=str,
                   help='gpt_tiny | gpt_small | gpt_medium')
    p.add_argument('--device', default='cuda', type=str,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument('--batch_size', default=32, type=int,
                   help='global batch (sequences per step)')
    p.add_argument('--seq_len', default=128, type=int)
    p.add_argument('--epochs', default=2, type=int)
    p.add_argument('--lr', default=0.1, type=float)
    p.add_argument('--lr_schedule', default='constant',
                   choices=['constant', 'cosine'])
    p.add_argument('--warmup_epochs', default=0, type=int)
    p.add_argument('--save_path', default='./lm_run/', type=str)
    p.add_argument('--resume', default='', type=str,
                   help="checkpoint path to resume from, or 'auto' = "
                        "latest model_<epoch>.pth under --save_path")
    p.add_argument('--save_every', default=0, type=int,
                   help='also checkpoint every N epochs (0 = final only)')
    p.add_argument('--keep_checkpoints', default=0, type=int,
                   help='retain only the newest K checkpoints (0 = all)')
    p.add_argument('--ckpt_backend', default='msgpack',
                   choices=['msgpack', 'orbax'],
                   help="'msgpack' = the single-file model_<epoch>.pth "
                        "(the port's torch.save payload); 'orbax' = "
                        "sharded per-rank writes under {save_path}/orbax/ "
                        "(torch.distributed.checkpoint)")
    p.add_argument('--ckpt_async', action='store_true',
                   help='write the periodic checkpoints in the background '
                        '(orbax only; the final one is durable before '
                        'exit)')
    p.add_argument('--print_freq', default=10, type=int)
    p.add_argument('--seed', default=0, type=int)
    p.add_argument('--corpus', default='', type=str,
                   help='a .npy int32 token file, or a text file / '
                        'directory (byte-level tokens); empty = synthetic')
    p.add_argument('--corpus_tokens', default=200_000, type=int,
                   help='synthetic stream length when --corpus is empty')
    p.add_argument('--dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--parallel', default='dp',
                   choices=['dp', 'sp', 'tp', 'pp'])
    p.add_argument('--pp_schedule', default='gpipe',
                   choices=['gpipe', '1f1b'])
    p.add_argument('--degree', default=1, type=int)
    p.add_argument('--sp_mode', default='ring',
                   choices=['ring', 'zigzag', 'ulysses'])
    p.add_argument('--n_experts', default=0, type=int)
    p.add_argument('--moe_top_k', default=1, type=int)
    p.add_argument('--moe_aux_weight', default=0.01, type=float)
    p.add_argument('--remat', action='store_true')
    p.add_argument('--vocab_chunks', default=0, type=int)
    p.add_argument('--grad_accum', default=1, type=int,
                   help='microbatches per update')
    p.add_argument('--zero', action='store_true')
    p.add_argument('--zero1', action='store_true')
    p.add_argument('--fsdp', action='store_true')
    p.add_argument('--val_frac', default=0.0, type=float,
                   help='hold out this fraction of the token stream and '
                        'log per-epoch val loss/ppl to test.log')
    p.add_argument('--hf_init', default='', type=str, metavar='PATH',
                   help='initialize from an HF-format GPT-2 state_dict '
                        '(torch .pth/.bin); geometry must match --model')
    p.add_argument('--hf_export', action='store_true',
                   help='after training, also write the weights as an '
                        'HF-loadable GPT-2 state_dict '
                        '(model_{epochs}.hf.pth); dense models only')
    p.add_argument('--sample', default=0, type=int,
                   help='after training, print N decoded continuation '
                        'tokens (greedy unless --sample_beams)')
    p.add_argument('--sample_beams', default=0, type=int,
                   help='> 1: decode --sample tokens with beam search of '
                        'this width (prints the best beam)')
    p.add_argument('--max_restarts', default=0, type=int,
                   help='supervised restart: catch named-fatal errors '
                        '(GraftFaultError family), re-run rendezvous, '
                        'restart the run with --resume auto (newest '
                        'digest-valid checkpoint), at most N times with '
                        'exponential backoff (0 = die on first fatal)')
    p.add_argument('--restart_backoff', default=1.0, type=float,
                   help='first-restart delay in seconds (doubles per '
                        'restart, capped at 30s)')
    graftscope.add_cli_args(p, stats_port=True)
    return p


def _check_model_flags(args) -> dict:
    """The JAX CLI's first checks, on the MoE and HF flags, in its
    order; returns the model's keywords (the MoE ones, and GPT-2's
    LayerNorm eps and biasless head under ``--hf_init``/``--hf_export``:
    the export must not have to drop a trained parameter)."""
    model_kw = dict(n_experts=args.n_experts)
    if args.moe_top_k != 1:
        if not args.n_experts:
            raise SystemExit('--moe_top_k needs --n_experts > 0')
        model_kw.update(moe_top_k=args.moe_top_k)
    if args.hf_init or args.hf_export:
        if args.n_experts:
            raise SystemExit(
                '--hf_init/--hf_export cover dense GPTs (MoE blocks have '
                'no GPT-2 representation)')
        model_kw.update(ln_eps=GPT2_LN_EPS, head_bias=False)
    if args.resume and args.hf_init:
        raise SystemExit(
            '--resume restores a full TrainState; --hf_init seeds fresh '
            'initial weights — pick one')
    return model_kw


def _load_hf_init(args, model, model_kw):
    """``--hf_init``'s params (CPU f32, the port's names), after JAX's
    geometry check against ``--model``; None without the flag."""
    if not args.hf_init:
        return None
    hf_model, params = load_gpt2_checkpoint(args.hf_init, model.num_heads,
                                            **model_kw)
    keys = ('vocab_size', 'max_seq_len', 'hidden_size', 'num_layers',
            'mlp_dim')
    mine = {k: getattr(model, k) for k in keys}
    theirs = {k: getattr(hf_model, k) for k in keys}
    if mine != theirs:
        raise SystemExit(
            f'--hf_init geometry {theirs} does not match --model '
            f'{args.model} {mine}')
    return params


# the second axis of each --parallel mode's grid (dp has one rank on it)
_AXES = {'dp': 'seq', 'sp': 'seq', 'tp': 'model', 'pp': 'pipe'}


def _check_ckpt_flags(args) -> None:
    """The JAX CLI's checks of the checkpoint flags, in its order (before
    the model is built)."""
    if args.save_every < 0:
        raise SystemExit(f'--save_every must be >= 0, got {args.save_every}')
    if args.ckpt_async and args.ckpt_backend != 'orbax':
        raise SystemExit('--ckpt_async applies to --ckpt_backend orbax')
    if args.ckpt_backend == 'orbax' and args.resume not in ('', 'auto'):
        try:
            int(args.resume)
        except ValueError:
            raise SystemExit(
                f"--ckpt_backend orbax: --resume must be 'auto' or an "
                f"epoch number (orbax checkpoints are epoch-keyed "
                f"directories under {{save_path}}/orbax/), got "
                f"{args.resume!r}")


def _check_flags(args, model) -> None:
    """The JAX CLI's pre-run checks after the model is built, in its
    order."""
    if args.seq_len > model.max_seq_len:
        raise SystemExit(
            f"--seq_len {args.seq_len} exceeds the model's max_seq_len "
            f"{model.max_seq_len}")
    if (args.zero1 or args.fsdp) and args.parallel != 'tp':
        raise SystemExit(
            "--zero1/--fsdp shard state through the GSPMD path; use "
            f"--parallel tp (got --parallel {args.parallel})")
    if args.zero and args.parallel != 'dp':
        raise SystemExit(
            "--zero rewrites the explicit DP step's grad exchange "
            "(reduce-scatter -> sharded update -> all-gather); use "
            f"--parallel dp (got --parallel {args.parallel}; the tp "
            "path's --zero1/--fsdp shard via GSPMD placement instead)")
    if args.zero and args.ckpt_backend == 'orbax':
        raise SystemExit(
            "--zero checkpoints via msgpack gather-on-save (artifacts "
            "round-trip between --zero and plain runs); --ckpt_backend "
            "orbax would persist the sharded layout")
    if args.pp_schedule != 'gpipe' and args.parallel != 'pp':
        raise SystemExit(
            f"--pp_schedule {args.pp_schedule} only applies to --parallel "
            f"pp (got --parallel {args.parallel})")
    if args.remat and args.parallel == 'pp':
        raise SystemExit(
            "--remat is not wired into the pipelined step (gpipe bounds "
            "live activations to the in-flight microbatches; 1f1b "
            "already rematerializes each stage backward internally)")
    if args.vocab_chunks > 1 and args.parallel in ('tp', 'pp'):
        raise SystemExit(
            '--vocab_chunks streams the head inside the dp/sp step '
            '(tp shards the head over the model axis; pp computes a '
            'vocab-parallel LSE already)')
    if args.grad_accum > 1 and args.parallel in ('tp', 'pp'):
        raise SystemExit(
            "--grad_accum is wired into the dp/sp step (pp microbatches "
            "already; for tp use a smaller global batch)")
    if args.val_frac and not 0.0 < args.val_frac < 1.0:
        raise SystemExit(
            f"--val_frac must be in (0, 1), got {args.val_frac}")
    if args.sample_beams and not args.sample:
        raise SystemExit('--sample_beams needs --sample N')
    if args.sample_beams and not 1 <= args.sample_beams <= model.vocab_size:
        raise SystemExit(
            f'--sample_beams must be in [1, vocab_size={model.vocab_size}]'
            f', got {args.sample_beams}')
    if args.sample and args.seq_len + args.sample > model.max_seq_len:
        raise SystemExit(
            f"--seq_len {args.seq_len} + --sample {args.sample} exceeds "
            f"max_seq_len {model.max_seq_len}")


def _check_grid(args, model, world: int) -> int:
    """The JAX CLI's checks of the ranks against ``--degree`` and of the
    sequence against the seq axis, in its order; returns the degree
    (1 under ``--parallel dp``, which ignores ``--degree`` as JAX
    does)."""
    deg = args.degree if args.parallel != 'dp' else 1
    if deg < 1 or world % deg:
        raise SystemExit(f"{world} ranks not divisible by --degree {deg}")
    if args.parallel == 'sp':
        try:
            seq_columns(args.seq_len, deg, 0, args.sp_mode == 'zigzag')
            if args.sp_mode == 'ulysses':
                _check_heads(model.num_heads, deg)
        except ValueError as e:
            raise SystemExit(str(e))
    return deg


def _load_tokens(args, vocab_size):
    """(tokens, corpus_is_text) from ``--corpus`` or the synthetic
    stream (the JAX CLI's sniff and checks)."""
    if not args.corpus:
        return synthetic_tokens(args.corpus_tokens, vocab_size=vocab_size,
                                seed=args.seed), False
    from .data.text import load_text_corpus, sniff_bytes

    if os.path.isdir(args.corpus):
        kind = 'text'
    else:
        with open(args.corpus, 'rb') as f:
            kind = sniff_bytes(f.read(6))
    if kind == 'npz':
        raise SystemExit(
            f"--corpus {args.corpus} is an npz/zip archive — pass the "
            "np.save (.npy) array itself, or a text file")
    if kind == 'npy':
        tokens, is_text = np.load(args.corpus).astype(np.int32), False
    else:
        try:
            tokens, is_text = load_text_corpus(args.corpus), True
        except ValueError as e:
            raise SystemExit(str(e))
    if len(tokens) == 0:
        raise SystemExit(f"--corpus {args.corpus} contains no tokens")
    if tokens.max() >= vocab_size or tokens.min() < 0:
        raise SystemExit(
            f"--corpus token ids span [{tokens.min()}, {tokens.max()}] but "
            f"--model {args.model} has vocab_size {vocab_size}")
    return tokens, is_text


def _launches():
    return {"flash_fwd": flash_fwd.launches,
            "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches}


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``), under
    :class:`.runtime.heal.Supervisor` when ``--max_restarts`` is set
    (JAX ``train_lm.py:163-185``: a restart tears the process group
    down and resumes with ``--resume auto``; the summary then counts
    the ``restarts``). Returns the summary of :func:`run`."""
    args = build_parser().parse_args(
        sys.argv[1:] if argv is None else list(argv))
    if not args.max_restarts:
        return run(args)
    from .runtime import heal

    def target(attempt):
        if attempt:
            args.resume = 'auto'
        return run(args)

    sup = heal.Supervisor(target, max_restarts=args.max_restarts,
                          backoff_s=args.restart_backoff,
                          rendezvous=dist.destroy_process_group)
    summary = sup.run()
    summary["restarts"] = sup.restarts
    return summary


def run(args) -> dict:
    """One run of the CLI on parsed ``args``. Returns a
    summary: per-epoch train and val losses, the first printed loss,
    steps, tokens/s and the steady step time (host clock, synced at the
    print boundaries), the kernels' launches on this rank during the
    run, the ``[data, degree]`` grid and this rank's place, on the card
    its peak memory, this rank's resident bytes of params and moments,
    an MoE run's balance loss at each printed step (``moe_aux``, the
    ``Aux`` column), under ``--sample`` the sampled tokens, and under
    ``--hf_export`` the written file (rank 0)."""
    moe_kw = _check_model_flags(args)
    _check_ckpt_flags(args)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    sp = args.parallel == 'sp'
    model_kw = dict(seq_axis='seq', sp_mode=args.sp_mode) if sp else {}
    model = get_model(args.model, dtype=dtype, **moe_kw, **model_kw)
    hf_params = _load_hf_init(args, model, dict(moe_kw, **model_kw))
    _check_flags(args, model)
    if args.lr_schedule == 'cosine':
        lr = cosine_lr(args.lr, args.epochs,
                       warmup_epochs=args.warmup_epochs)
    else:
        if args.warmup_epochs:
            raise SystemExit(
                "--warmup_epochs applies to --lr_schedule cosine")
        lr = args.lr

    # armed before any state exists: the ledger takes its registrations
    telemetry.arm_from_args(args)
    # the device and the process group only after every flag check
    device = resolve_device(args.device)
    dist.init_process(device)
    device = dist.device_for_rank(device)
    world = dist.get_world_size()
    primary = dist.is_primary()
    deg = _check_grid(args, model, world)
    # JAX's (data, seq|model|pipe) mesh, row-major: dp replicas of deg
    # ranks each
    grid = make_grid(world // deg, deg, axis=_AXES[args.parallel])
    dp = grid.data
    seq_axis = 'seq' if sp else None

    tokens, corpus_is_text = _load_tokens(args, model.vocab_size)
    val_loader = None
    if args.val_frac:
        n_val = int(len(tokens) * args.val_frac)
        min_val = args.batch_size * args.seq_len
        if n_val < min_val:
            raise SystemExit(
                f"--val_frac {args.val_frac} holds out {n_val} tokens but "
                f"one eval batch needs {min_val} — grow the corpus or the "
                "fraction")
        tokens, val_tokens = tokens[:-n_val], tokens[-n_val:]
        val_loader = TokenLoader(val_tokens, batch_size=args.batch_size,
                                 seq_len=args.seq_len, world_size=dp,
                                 shuffle=False, seed=args.seed)
    loader = TokenLoader(tokens, batch_size=args.batch_size,
                         seq_len=args.seq_len, world_size=dp,
                         seed=args.seed)
    if (args.batch_size // dp) % args.grad_accum:
        raise SystemExit(
            f"global batch {args.batch_size} must divide by data-parallel "
            f"size x grad_accum = {dp} x {args.grad_accum}")

    def rows(batch):
        """This rank's rows of a global batch, on the device."""
        return to_device(local_rows(batch, grid.data_index, dp), device)

    ck = None
    resume_path = args.resume
    if args.ckpt_backend == 'orbax':
        from .train.orbax_ckpt import OrbaxCheckpointer

        ck = OrbaxCheckpointer(args.save_path, async_=args.ckpt_async,
                               keep=args.keep_checkpoints or None)
        resume_path = ''
        if args.resume == 'auto':
            resume_epoch = ck.latest_epoch()
            if resume_epoch is None and primary:
                print(f"--resume auto: no orbax checkpoint under "
                      f"{ck.directory}; starting fresh", flush=True)
        else:
            resume_epoch = int(args.resume) if args.resume else None
    elif args.resume == 'auto':
        resume_path = resolve_auto_resume(args.save_path) or ''
        if not resume_path and primary:
            print(f"--resume auto: no checkpoint under "
                  f"{args.save_path}; starting fresh", flush=True)
    resumed = False

    def maybe_resume(st):
        """The checkpoint into the freshly built state (the stacked tree
        for pp; before any placement or sharding), as JAX's
        ``maybe_resume``."""
        nonlocal resumed
        if ck is not None and resume_epoch is not None:
            ck.restore(st, resume_epoch)
            resumed = True
            if primary:
                print(f"Resumed from {ck.directory}/{resume_epoch} "
                      f"(continuing at epoch {st.epoch + 1})", flush=True)
            return st
        if not resume_path:
            return st
        resumed = True
        if args.resume == 'auto':
            st, used = load_with_fallback(
                args.save_path, st, anchor=checkpoint_epoch(resume_path))
        else:
            st, used = load_checkpoint(resume_path, st), resume_path
        if primary:
            print(f"Resumed from {used} (continuing at epoch "
                  f"{st.epoch + 1})", flush=True)
        return st

    opt = sgd(learning_rate=lr)
    params = (init_params(model, args.seed, device) if hf_params is None
              else {k: t.to(device) for k, t in hf_params.items()})
    del hf_params
    if args.parallel == 'pp':
        state = maybe_resume(create_pipelined_lm_state(model, params, deg))
        step = make_pipelined_lm_train_step(
            model, opt, schedule=args.pp_schedule,
            moe_aux_weight=args.moe_aux_weight)
        eval_step = make_pipelined_lm_eval_step(model)
        resident = state.resident_bytes()
    elif args.parallel == 'tp':
        placement = plan_placement(model, dp, deg, zero1=args.zero1,
                                   fsdp=args.fsdp)
        state = shard_state(
            maybe_resume(create_lm_train_state(model, params)), placement,
            grid)
        step = make_lm_train_step_tp(model, opt, remat=args.remat,
                                     moe_aux_weight=args.moe_aux_weight)
        eval_step = make_lm_eval_step_tp(model)
        resident = placement.resident_bytes()
        del resident["batch_stats"]
    else:
        plan = plan_buckets(model, world) if args.zero else None
        state = maybe_resume(create_lm_train_state(model, params,
                                                   plan=plan))
        if plan is not None:
            zeroify_state(state, plan, dist.get_rank())
        step = make_lm_train_step(model, opt, grad_accum=args.grad_accum,
                                  seq_axis=seq_axis,
                                  vocab_chunks=args.vocab_chunks,
                                  remat=args.remat,
                                  moe_aux_weight=args.moe_aux_weight)
        eval_step = make_lm_eval_step(model, seq_axis=seq_axis,
                                      vocab_chunks=args.vocab_chunks)
        resident = {"params": 4 * state.n,
                    "opt_state": 4 * state.momentum.numel()}
    del params
    if val_loader is None:
        eval_step = None
    start_epoch = state.epoch + 1 if resumed else 1

    os.makedirs(args.save_path, exist_ok=True)
    logger = Logger(os.path.join(args.save_path, 'train.log'))
    test_logger = (Logger(os.path.join(args.save_path, 'test.log'))
                   if val_loader is not None else None)
    launches0 = _launches()
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    summary = {"epoch_losses": [], "val_losses": [], "first_loss": None,
               "steps": 0, "skipped": 0, "train_s": 0.0,
               "steady_step_s": None, "world_size": world,
               "grid": [dp, deg], "parallel": args.parallel,
               "rank": dist.get_rank(), "device": str(device),
               "resident_bytes": resident, "moe_aux": []}
    steady = []  # (seconds, steps) between an epoch's first and last print

    register_state_hbm(state)
    live: dict = {}
    stats_server = health = None
    if args.stats_port:
        health = heal.HealthState()
        stats_server = telemetry.start_stats(
            args.stats_port, lambda: live, health, rank=dist.get_rank())
        health.to_ready("training")

    def save(epoch: int, **attrs) -> None:
        with graftscope.span("train.checkpoint", cat="train", epoch=epoch,
                             backend=args.ckpt_backend, **attrs):
            if ck is not None:
                ck.save(state, epoch)  # retention inside
                if attrs.get("final"):
                    ck.wait()  # the final save durable before exit
            else:
                save_checkpoint(args.save_path, state, epoch)
                if args.keep_checkpoints and primary:
                    prune_checkpoints(args.save_path, args.keep_checkpoints)

    def train_epochs():
        nonlocal state
        # the clock reads of the spans: only while a scope is armed
        armed = graftscope.active_scope() is not None
        for epoch in range(start_epoch, args.epochs + 1):
            state.epoch = epoch
            loader.set_epoch(epoch)
            t0, losses, seen = time.time(), 0.0, 0
            t_first = None
            t_ready = time.perf_counter() if armed else 0.0
            t_window = t_ready
            for i, batch in enumerate(loader):
                if armed:
                    graftscope.emit_span(
                        "train.data", time.perf_counter() - t_ready,
                        cat="train", epoch=epoch, batch=i)
                if args.parallel in ('tp', 'pp'):
                    with graftscope.span("train.h2d", cat="train",
                                         batch=i):
                        tok = rows(batch)
                else:
                    tok = rows(batch)
                state, metrics = step(state, tok)
                summary["steps"] += 1
                if i % args.print_freq == 0 or i == len(loader) - 1:
                    # the liveness gate, before the print boundary's
                    # host sync (the loop's one) waits on the card
                    dist.gate_collectives(device)
                    with graftscope.span("train.metrics_fetch",
                                         cat="train", epoch=epoch,
                                         batch=i) as mspan:
                        skipped = int(metrics['skipped'])
                        loss = None if skipped else float(metrics['loss'])
                    if armed:
                        now_p = time.perf_counter()
                        graftscope.emit_span(
                            "train.window", now_p - t_window, cat="train",
                            epoch=epoch, batch=i)
                        t_window = now_p
                    now = time.time()
                    if t_first is None:
                        t_first = (now, i)
                    elif i == len(loader) - 1:
                        steady.append((now - t_first[0], i - t_first[1]))
                    if skipped:
                        mspan.note(skipped=True)
                        graftscope.emit("train.step_skipped", cat="train",
                                        epoch=epoch, batch=i)
                        summary["skipped"] += 1
                        if primary:
                            print(f"Epoch: [{epoch}][{i}/{len(loader)}]\t"
                                  "step skipped (non-finite grads)",
                                  flush=True)
                        t_ready = time.perf_counter() if armed else 0.0
                        continue
                    losses, seen = losses + loss, seen + 1
                    if summary["first_loss"] is None:
                        summary["first_loss"] = loss
                    if 'moe_aux' in metrics:
                        summary["moe_aux"].append(float(metrics['moe_aux']))
                    tok_s = (args.batch_size * args.seq_len * (i + 1)
                             / (now - t0))
                    live.update(epoch=epoch, batch=i, loss=loss,
                                tokens_per_sec=tok_s)
                    if primary:
                        extra = (f"\tAux {summary['moe_aux'][-1]:.3f}"
                                 if 'moe_aux' in metrics else '')
                        print(f"Epoch: [{epoch}][{i}/{len(loader)}]\t"
                              f"Loss {loss:.4f}\tTok/s {tok_s:.0f}{extra}",
                              flush=True)
                t_ready = time.perf_counter() if armed else 0.0
            summary["train_s"] += time.time() - t0
            avg = losses / max(1, seen)
            summary["epoch_losses"].append(avg)
            if primary:
                logger.write([epoch, avg, math.exp(min(avg, 20.0))])
            if eval_step is not None:
                with graftscope.span("train.validate", cat="train",
                                     epoch=epoch):
                    tot, cnt = 0.0, 0.0
                    for batch in val_loader:
                        m = eval_step(state, rows(batch))
                        c = float(m['count'])
                        tot, cnt = tot + float(m['loss']) * c, cnt + c
                    vloss = tot / max(1.0, cnt)
                summary["val_losses"].append(vloss)
                if primary:
                    print(f"Val: [{epoch}]\tLoss {vloss:.4f}\t"
                          f"PPL {math.exp(min(vloss, 20.0)):.2f}",
                          flush=True)
                    test_logger.write(
                        [epoch, vloss, math.exp(min(vloss, 20.0))])
            if (args.save_every and epoch % args.save_every == 0
                    and epoch < args.epochs):
                save(epoch)

    try:
        # a crash unwinding the loop dumps the flight ring first
        with graftscope.flight_recorder("train_lm epoch loop"):
            train_epochs()
    except BaseException:
        # a supervised restart binds the same --stats_port again
        telemetry.stop_stats(stats_server)
        raise

    if start_epoch <= args.epochs:
        save(args.epochs, final=True)
    elif primary:
        print(f"--resume: checkpoint already at epoch {start_epoch - 1} >= "
              f"--epochs {args.epochs}; nothing to train", flush=True)

    # the whole params on every rank (a collective under tp and pp): pp
    # unstacks them, as JAX does
    whole = None
    if args.parallel in ('tp', 'pp') and (args.hf_export or args.sample):
        whole = (unstack_pipeline_params(state.stacked(state.params),
                                         model.vocab_size)
                 if args.parallel == 'pp' else state.state_dict())
    if args.hf_export and primary:
        out = os.path.join(args.save_path, f"model_{args.epochs}.hf.pth")
        save_gpt2_checkpoint(out, whole if whole is not None
                             else model.state_dict())
        summary["hf_export"] = out
        print(f"HF export: {out}", flush=True)

    if args.sample:
        from .inference import beam_search, generate
        from .inference.generate import register_generate_hbm

        prompt = torch.as_tensor(tokens[: args.seq_len][None, :],
                                 dtype=torch.long, device=device)
        if whole is not None:
            # decoded whole on this rank's card (JAX decodes a dense tp
            # model TP-sharded greedily, the same tokens, and beams and
            # an MoE model whole, as here)
            dense = get_model(args.model, dtype=dtype, **moe_kw)
            dense.load_state_dict({k: v.detach().clone() for k, v in
                                   whole.items()}, assign=True)
        else:
            # the dense model, as JAX's model.clone(seq_axis=None)
            dense = model.clone(seq_axis=None) if sp else model
        # the decode's KV residency on the armed ledger
        register_generate_hbm(dense, 1, args.seq_len + args.sample)
        with torch.no_grad():
            if args.sample_beams > 1:
                beams, _ = beam_search(dense, prompt,
                                       max_new_tokens=args.sample,
                                       beam_size=args.sample_beams)
                out = beams[:, 0]  # the best beam
            else:
                out = generate(dense, prompt, max_new_tokens=args.sample)
        ids = out[0, -args.sample:].tolist()
        summary["sample"] = ids
        if primary:
            print("sample:", ids)
            if corpus_is_text:
                from .data.text import detokenize

                print("sample text:", repr(detokenize(ids)), flush=True)

    now = _launches()
    summary["launches"] = {k: now[k] - launches0[k] for k in now}
    summary["tokens_per_sec"], summary["tokens_per_sec_per_card"] = \
        throughput(args.batch_size * args.seq_len * summary["steps"],
                   summary["train_s"], world)
    if steady:
        summary["steady_step_s"] = (sum(s for s, _ in steady)
                                    / sum(n for _, n in steady))
    if device.type == 'cuda':
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            device)
    if ck is not None:
        ck.close()
    if primary:
        graftscope.export_from_args(args)
    if health is not None:
        health.to_dead("run complete")
    telemetry.stop_stats(stats_server)
    dist.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
