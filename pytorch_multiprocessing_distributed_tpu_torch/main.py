"""Image-classification training CLI — the port of the JAX package's
``main.py`` (the reference's trainer: ResNet-18 on CIFAR-10, synchronous
data-parallel SGD with synchronized BatchNorm), on the card by default.

    python -m pytorch_multiprocessing_distributed_tpu_torch.main \\
        --model res --synthetic --world_size 1 --save_path /tmp/run

The JAX image zoo and datasets come along: ``--model`` names any
registered image model (ResNet-18 ... 152, VGG, DenseNet, ViT,
ConvNeXt), ``--dataset imagenet`` reads the synthetic ImageNet set
(``--synthetic``) or an image tree at ``--data_root`` at
``--image_size`` (default 224) with the ImageNet stem, and ``--optimizer
lamb`` trains with LAMB (lr 1e-3 unless ``--lr``, weight decay 1e-4).

Flags keep the JAX CLI's names, defaults and order of checks, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
The JAX step's transforms come along: ``--grad_accum N`` (strided
microbatches, one update), ``--clip_grad_norm C`` (global-norm
clipping), ``--ema DECAY`` (an EMA of the params, evaluated on and
checkpointed as ``ema_params``), ``--remat`` (the loss function under
``torch.utils.checkpoint``), ``--zero`` (graftzero's sharded update:
reduce-scatter, update on this rank's shard of the moments, all-gather;
:mod:`.parallel.zero`) and ``--torch_export`` (the final weights as the
reference's ``state_dict``, ``model_{epochs}.torch.pth``; ResNet family
only).
The JAX GSPMD placements come along: ``--zero1`` (the moments sliced
over ``data``), ``--fsdp`` (params, stats, moments and EMA sliced over
``data``) and ``--model_parallel M`` (every leaf's trailing JAX dim
sliced over ``model``), alone or together, on a grid of ``world_size x
M`` ranks: each rank holds the slices JAX's ``state_shardings`` leaves
on the device at its ``(data, model)`` coordinate (:mod:`.train.placement`,
:mod:`.train.gspmd`).
Artifacts are the JAX CLI's: a snapshot of this script, the ``Epoch:
[e][i/n]``, ``test : [i/n]`` and ``Accuracy`` lines, ``train.log`` and
``test.log`` rows ``[epoch, loss, accuracy]``, ``model_{epoch}.pth``
checkpoints (the port's own payload, :mod:`.train.checkpoint`) with
``.sha256`` sidecars, ``--resume PATH|auto``, and ``test_accuracy.png``
and ``loss.png``.

The JAX CLI's fault tolerance comes along: ``--ckpt_backend orbax``
writes sharded checkpoints under ``{save_path}/orbax/<epoch>/`` (each
rank its own slices, :mod:`.train.orbax_ckpt`; ``--resume`` is then
``auto`` or an epoch number), ``--ckpt_async`` writes the periodic ones
in the background, ``--max_restarts N [--restart_backoff S]`` runs each
rank under :class:`.runtime.heal.Supervisor` (a named fatal, such as a
lost peer or a failed checkpoint write, tears the group down and
restarts the run with ``--resume auto``), a SIGTERM checkpoints and
exits 0 at the next window boundary, and ``--profile LOGDIR`` traces
the run with ``torch.profiler`` (:mod:`.utils.profiler`).

One process per rank: under the JAX package's env contract
(``PMDT_MASTER_ADDR``, ``PMDT_WORLD_SIZE``, ``PMDT_RANK``;
:mod:`.parallel.dist`) the process joins the group as one rank; the
group holds ``world_size x model_parallel`` ranks, rank ``r`` at data
index ``r // M`` and model index ``r % M`` (:mod:`.parallel.mesh`).
Without it, more than one rank spawns them through
``torch.multiprocessing`` (the reference's ``mp.spawn``): one per card
over NCCL, or gloo processes with ``--device cpu``. The JAX default
``--world_size 2`` stays the default; asking for more ranks than cards
raises.

On the card, f32 convolutions run under PyTorch's default
``torch.backends.cudnn.allow_tf32 = True`` (TF32 tensor cores, as the
reference ran) and f32 matmuls in full f32 (PyTorch's default).

The JAX CLI's observability flags come along (:mod:`.runtime.scope`):
``--trace_out t.json`` (a Chrome/Perfetto trace of the run's spans),
``--events_out e.jsonl`` (the event log), ``--flight_path f.jsonl``
(where a crash dumps the flight recorder) and ``--stats_port P``
(``/metrics``, ``/snapshot.json``, ``/events.json`` and ``/healthz``
while the run is up: the trainer's live loss and images/s, the
``hbm_*`` ledger and the ``goodput_*`` gauges; rank ``r`` serves on
``P + r``). The primary rank writes the trace and the event log at the
end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import List, Optional

import torch

from .data import get_loader
from .device import resolve_device
from .models import LM_MODELS, get_model, init_model
from .ops.fused_update import fused_sgd_
from .ops.losses import smooth_cross_entropy_loss
from .parallel import all_gather_objects, dist
from .parallel import zero as zero_mod
from .parallel.mesh import make_grid
from .runtime import heal, telemetry
from .runtime import scope as graftscope
from .train import create_train_state, lamb, sgd, sgd_fused
from .train.checkpoint import (checkpoint_epoch, load_checkpoint,
                               load_with_fallback, resolve_auto_resume)
from .train.optim import cosine_lr, multistep_lr
from .train.placement import plan_placement, shard_state
from .train.trainer import Trainer
from .utils import throughput
from .utils.torch_interop import is_resnet_name, save_torch_checkpoint

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Confidence Aware Learning")
    p.add_argument('--batch_size', default=64, type=int, help='Batch size')
    p.add_argument('--epochs', default=20, type=int,
                   help='Total number of epochs to run')
    p.add_argument('--model', default='res', type=str,
                   help='res | resnet18 ... resnet152 | vgg | vgg11 ... '
                        'vgg19 | dense | densenet121 | densenet_bc100 | '
                        'vit_b16 | vit_s16 | vit_tiny | convnext_t/s/b/l')
    p.add_argument('--save_path', default='./test/', type=str,
                   help='logs, checkpoints, plots and a snapshot of this '
                        'script land here')
    p.add_argument('--gpu', default='7', type=str,
                   help='GPU id (unused, as in the JAX CLI)')
    p.add_argument('--print-freq', '-p', default=10, type=int, metavar='N',
                   help='print frequency (default: 10)')
    p.add_argument('--world_size', default=2, type=int,
                   help='data-parallel ranks (one process each)')
    p.add_argument('--device', default='cuda', type=str,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path, gloo between ranks)")
    p.add_argument('--dataset', default='cifar',
                   choices=['cifar', 'imagenet'])
    p.add_argument('--data_root', default='', type=str,
                   help='holds cifar-10-batches-py (cifar) or train/ and '
                        'val/ image trees (imagenet)')
    p.add_argument('--synthetic', action='store_true',
                   help='deterministic synthetic CIFAR or ImageNet (no '
                        'files needed)')
    p.add_argument('--num_classes', default=0, type=int,
                   help='label count (0 = the dataset\'s: 10 for cifar, '
                        '1000 for synthetic imagenet)')
    p.add_argument('--image_size', default=0, type=int,
                   help='square input size (0 = 32 for cifar, 224 for '
                        'imagenet)')
    p.add_argument('--dtype', default='float32',
                   choices=['float32', 'bfloat16'],
                   help='compute dtype for conv/matmul (params stay f32)')
    p.add_argument('--model_parallel', default=1, type=int,
                   help='ranks of the model axis: every leaf\'s trailing '
                        'JAX dim sliced over them (world_size x '
                        'model_parallel ranks in all)')
    p.add_argument('--zero', action='store_true',
                   help='sharded weight update: reduce-scatter the grads, '
                        'update this rank\'s shard of the optimizer '
                        'moments, all-gather (parallel/zero.py)')
    p.add_argument('--zero1', action='store_true',
                   help='GSPMD placement: the optimizer moments sliced over '
                        'the data axis')
    p.add_argument('--fsdp', action='store_true',
                   help='GSPMD placement: params, stats, moments and EMA '
                        'sliced over the data axis, gathered at use')
    p.add_argument('--grad_accum', default=1, type=int,
                   help='split each rank\'s batch into N strided '
                        'microbatches, one optimizer step')
    p.add_argument('--clip_grad_norm', default=0.0, type=float,
                   help='clip the averaged gradients to this global norm '
                        '(0 = off)')
    p.add_argument('--label_smoothing', default=0.0, type=float,
                   help='cross-entropy label smoothing epsilon')
    p.add_argument('--ema', default=0.0, type=float, metavar='DECAY',
                   help='track an EMA of the params with this decay and '
                        'evaluate on it (0 = off)')
    p.add_argument('--remat', action='store_true',
                   help='recompute the forward in the backward '
                        '(torch.utils.checkpoint over the loss function)')
    p.add_argument('--seed', default=0, type=int, help='init seed')
    p.add_argument('--resume', default='', type=str,
                   help="checkpoint path to resume from, or 'auto' = "
                        "latest model_*.pth in --save_path")
    p.add_argument('--save_every', default=0, type=int,
                   help='checkpoint every N epochs (0 = final epoch only)')
    p.add_argument('--keep_checkpoints', default=0, type=int,
                   help='retain only the K newest checkpoints (0 = all)')
    p.add_argument('--ckpt_backend', default='msgpack',
                   choices=['msgpack', 'orbax'],
                   help="'msgpack' = the single-file model_<epoch>.pth "
                        "(the port's torch.save payload); 'orbax' = "
                        "sharded per-rank writes under {save_path}/orbax/ "
                        "(torch.distributed.checkpoint), no gather")
    p.add_argument('--ckpt_async', action='store_true',
                   help='write the periodic checkpoints in the background '
                        '(orbax backend only); the final-epoch and '
                        'preemption saves are durable before exit')
    p.add_argument('--lr', default=0.0, type=float,
                   help='base learning rate (0 = 0.1, the reference; '
                        '1e-3 for lamb)')
    p.add_argument('--lr_schedule', default='multistep',
                   choices=['multistep', 'cosine'],
                   help='multistep = MultiStepLR([60, 80], 0.1); cosine = '
                        'cosine decay over --epochs')
    p.add_argument('--warmup_epochs', default=0, type=int,
                   help='linear LR warmup epochs (cosine only)')
    p.add_argument('--optimizer', default='sgd',
                   choices=['sgd', 'lamb', 'sgd_fused'],
                   help='sgd = the reference; sgd_fused = the same SGD in '
                        'the fused single-pass CUDA kernel on the card; '
                        'lamb = LAMB (layerwise trust ratios)')
    p.add_argument('--profile', default='', type=str, metavar='LOGDIR',
                   help='trace the run with torch.profiler into LOGDIR '
                        '(TensorBoard-loadable; off when empty)')
    p.add_argument('--torch_export', action='store_true',
                   help='also export the final weights as the reference\'s '
                        'torch state_dict (model_{epoch}.torch.pth; ResNet '
                        'family only)')
    p.add_argument('--max_restarts', default=0, type=int,
                   help='supervised restart: on a named fatal '
                        '(GraftFaultError family: lost peer, failed '
                        'checkpoint write, exhausted retries) tear the '
                        'group down and restart with --resume auto, at '
                        'most N times with doubling backoff (0 = die on '
                        'the first)')
    p.add_argument('--restart_backoff', default=1.0, type=float,
                   help='first-restart delay in seconds (doubles per '
                        'restart, capped at 30s)')
    graftscope.add_cli_args(p, stats_port=True)
    return p


def _check_flags(args) -> None:
    """The JAX CLI's flag checks (those of the flags this slice keeps),
    in its order, before any device, process group or data work."""
    if args.torch_export and not is_resnet_name(args.model):
        raise SystemExit(
            f"--torch_export supports the ResNet family only "
            f"(got --model {args.model})")
    if args.model in LM_MODELS:
        raise SystemExit(
            f"--model {args.model} is a language model: it trains through "
            "pytorch_multiprocessing_distributed_tpu_torch.train_lm, not "
            "this image-classification CLI")
    if args.optimizer == 'sgd_fused' and (
            args.zero1 or args.fsdp or args.model_parallel > 1):
        raise SystemExit(
            "--optimizer sgd_fused is the explicit shard_map-DP path's "
            "fused kernel; under --zero1/--fsdp/--model_parallel the GSPMD "
            "partitioner cannot shard through the opaque call (it would "
            "replicate the moment buffers, defeating the sharding). Use "
            "--optimizer sgd there.")
    if args.zero and (args.zero1 or args.fsdp or args.model_parallel > 1):
        raise SystemExit(
            "--zero is the explicit shard_map-DP sharded update; "
            "--zero1/--fsdp/--model_parallel run the GSPMD path, which "
            "shards state via placement instead — pick one family.")
    if args.zero and args.optimizer == 'sgd_fused':
        raise SystemExit(
            "--zero shards the update through the transform's "
            "update()/shard_update() path; the fused whole-update "
            "kernel cannot run on shards. Use --optimizer sgd or lamb "
            "with --zero.")
    if args.zero and args.ckpt_backend == 'orbax':
        raise SystemExit(
            "--zero checkpoints via msgpack gather-on-save (the artifact "
            "round-trips between --zero and plain runs); --ckpt_backend "
            "orbax would persist the sharded layout.")
    if args.warmup_epochs and args.lr_schedule != 'cosine':
        raise SystemExit(
            "--warmup_epochs applies to --lr_schedule cosine (the "
            "reference's MultiStepLR has no warmup)")
    if args.dataset != 'imagenet' and (args.image_size or 32) != 32:
        raise SystemExit(
            "--dataset cifar is fixed at 32x32 (the reference resizes to "
            "32); --image_size applies to --dataset imagenet")
    if args.world_size < 1:
        raise SystemExit(f"--world_size must be >= 1, got {args.world_size}")
    if args.model_parallel < 1:
        raise SystemExit(
            f"--model_parallel must be >= 1, got {args.model_parallel}")


def _gspmd(args) -> bool:
    """The JAX CLI's ``use_gspmd``: the placed state and step."""
    return args.model_parallel > 1 or args.zero1 or args.fsdp


def _schedule(args, base_default: float = 0.1):
    base = args.lr or base_default
    if args.lr_schedule == 'cosine':
        return cosine_lr(base, args.epochs, warmup_epochs=args.warmup_epochs)
    return multistep_lr(base, milestones=[60, 80], gamma=0.1)


def run(args) -> dict:
    """One rank: join the group named by the ``PMDT_*`` env (no group
    for one process), lay it out as the ``(data, model)`` grid, train and
    validate every epoch, checkpoint, plot. Returns the rank's
    summary."""
    # armed before any state exists: the ledger takes its registrations
    telemetry.arm_from_args(args)
    device = resolve_device(args.device)
    dist.init_process(device)
    world = dist.get_world_size()
    if world != args.world_size * args.model_parallel:
        raise SystemExit(
            f"--world_size {args.world_size} x --model_parallel "
            f"{args.model_parallel} but the process group has {world} "
            "rank(s) (PMDT_WORLD_SIZE)")
    grid = make_grid(args.world_size, args.model_parallel)
    device = dist.device_for_rank(device)
    rank, primary = dist.get_rank(), dist.is_primary()

    is_imagenet = args.dataset == 'imagenet'
    image_size = args.image_size or (224 if is_imagenet else 32)
    # loaders first, so the head can size itself from the dataset (an
    # image tree derives its own class count), as in JAX
    # the model ranks of a data replica read its rows (JAX's P(data))
    train_loader, test_loader = get_loader(args, world_size=grid.data,
                                           rank=grid.data_index)
    dataset = getattr(train_loader, "dataset", None)
    num_classes = (args.num_classes or getattr(dataset, "num_classes", 0)
                   or (1000 if is_imagenet else 10))
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    model = get_model(args.model, dtype=dtype, num_classes=num_classes,
                      stem="imagenet" if is_imagenet else "cifar",
                      image_size=image_size)
    init_model(model, args.seed).to(device)
    if args.optimizer == 'lamb':
        optimizer = lamb(learning_rate=_schedule(args, 1e-3),
                         weight_decay=0.0001)
    else:
        make = sgd_fused if args.optimizer == 'sgd_fused' else sgd
        optimizer = make(learning_rate=_schedule(args), momentum=0.9,
                         weight_decay=0.0001, nesterov=True)
    plan = zero_mod.plan_buckets(model, world) if args.zero else None
    state = create_train_state(model, optimizer, ema=args.ema > 0,
                               plan=plan)

    start_epoch = 1
    if args.ckpt_backend == 'orbax' and args.resume:
        start_epoch = _orbax_resume(args, state, primary)
    elif args.resume:
        path = args.resume
        if args.resume == 'auto':
            path = resolve_auto_resume(args.save_path) or ''
            if not path and primary:
                print(f"--resume auto: no checkpoint under "
                      f"{args.save_path}; starting fresh", flush=True)
        if path:
            if args.resume == 'auto':
                state, used = load_with_fallback(
                    args.save_path, state, anchor=checkpoint_epoch(path))
            else:
                state, used = load_checkpoint(path, state), path
            start_epoch = state.epoch + 1
            if primary:
                print(f"Resumed from {used} (continuing at epoch "
                      f"{start_epoch})", flush=True)
    if plan is not None:
        # moments sharded from the first step: the replicated ones (a
        # fresh init or the resumed checkpoint) become this rank's shards
        zero_mod.zeroify_state(state, plan, rank)
    if _gspmd(args):
        # likewise this rank's slices of the whole state (JAX shard_state)
        state = shard_state(state, plan_placement(
            model, grid.data, grid.model, zero1=args.zero1,
            fsdp=args.fsdp), grid)

    trainer = Trainer(
        model=model, optimizer=optimizer, state=state,
        train_loader=train_loader, test_loader=test_loader,
        save_path=args.save_path, epochs=args.epochs, device=device,
        print_freq=args.print_freq, start_epoch=start_epoch,
        loss_fn=smooth_cross_entropy_loss(args.label_smoothing),
        save_every=args.save_every, keep_checkpoints=args.keep_checkpoints,
        remat=args.remat, grad_accum=args.grad_accum,
        clip_grad_norm=args.clip_grad_norm or None,
        ema_decay=args.ema or None, ckpt_backend=args.ckpt_backend,
        ckpt_async=args.ckpt_async)
    stats_server = health = None
    if args.stats_port:
        health = heal.HealthState()
        stats_server = telemetry.start_stats(
            args.stats_port, lambda: trainer.live, health, rank=rank)
        health.to_ready("training")
    launches0 = fused_sgd_.launches
    try:
        if args.profile:
            from .utils.profiler import trace

            with trace(args.profile, worker_name=f"rank{rank}"):
                trainer.fit()
        else:
            trainer.fit()
    except BaseException:
        # a supervised restart binds the same --stats_port again
        telemetry.stop_stats(stats_server)
        raise
    if args.torch_export:
        # params are replicated under --zero (only the moments are
        # sharded); a placed state gathers its slices first, on every rank
        state = trainer.state
        weights = state.state_dict() if _gspmd(args) else model
        if primary:
            out = os.path.join(args.save_path,
                               f"model_{args.epochs}.torch.pth")
            save_torch_checkpoint(out, weights)
            print(f"Exported torch state_dict -> {out}", flush=True)
    if start_epoch > args.epochs and primary:
        print(f"--resume: checkpoint already at epoch {start_epoch - 1} >= "
              f"--epochs {args.epochs}; nothing to train", flush=True)
    s = dict(trainer.summary)
    steady = s.pop("steady")
    rate, per_card = throughput(args.batch_size * s["steps"], s["train_s"],
                                world)
    state = trainer.state
    opt_bytes = zero_mod.opt_state_bytes(state)
    resident = {k: 0 if t is None else t.numel() * t.element_size()
                for k, t in (("params", state.params),
                             ("batch_stats", state.stats),
                             ("ema_params", state.ema))}
    resident["opt_state"] = opt_bytes
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    s.update(world_size=world, grid=[grid.data, grid.model],
             resident_bytes=(all_gather_objects(resident) if world > 1
                             else [resident]),
             peak_memory_bytes=(all_gather_objects(peak) if world > 1
                                else [peak]),
             device=str(device),
             launches={"fused_sgd": fused_sgd_.launches - launches0},
             opt_state_bytes=(all_gather_objects(opt_bytes)
                              if world > 1 else [opt_bytes]),
             static_comm_bytes=(None if plan is None else
                                zero_mod.static_comm_bytes(plan)),
             images_per_sec=rate, images_per_sec_per_card=per_card,
             steady_step_s=(sum(t for t, _ in steady)
                            / sum(n for _, n in steady)) if steady else None)
    if primary:
        graftscope.export_from_args(args)
    if health is not None:
        health.to_dead("run complete")
    telemetry.stop_stats(stats_server)
    dist.destroy_process_group()
    return s


def _orbax_resume(args, state, primary: bool) -> int:
    """``--resume auto|EPOCH`` from the sharded checkpoints (JAX
    ``main.py:338-373``): the state restored before any sharding or
    placement; returns the epoch to start at."""
    from .train.orbax_ckpt import OrbaxCheckpointer

    ck = OrbaxCheckpointer(args.save_path)
    if args.resume == 'auto':
        epoch = ck.latest_epoch()  # the primary's verdict, for every rank
    else:
        try:
            epoch = int(args.resume)
        except ValueError:
            raise SystemExit(
                f"--ckpt_backend orbax: --resume must be 'auto' or an "
                f"epoch number (orbax checkpoints are epoch-keyed "
                f"directories under {{save_path}}/orbax/), got "
                f"{args.resume!r}")
    if epoch is None:
        if primary:
            print(f"--resume auto: no orbax checkpoint under "
                  f"{args.save_path}; starting fresh", flush=True)
        return 1
    ck.restore(state, epoch)
    if primary:
        print(f"Resumed from {ck.directory}/{epoch} (continuing at epoch "
              f"{state.epoch + 1})", flush=True)
    return state.epoch + 1


def supervised_run(args) -> dict:
    """:func:`run`, under :class:`.runtime.heal.Supervisor` when
    ``--max_restarts`` is set (JAX ``main.py:522-556``): a named fatal
    tears the process group down, backs off, and runs again with
    ``--resume auto``, so the run resumes from the newest digest-valid
    checkpoint. The summary counts the ``restarts``."""
    if not args.max_restarts:
        return run(args)

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


def _rank_main(argv: List[str]) -> dict:
    """One rank started by :func:`main`'s spawn."""
    return supervised_run(build_parser().parse_args(argv))


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``). Returns the
    primary rank's summary: per-epoch train losses and test accuracies,
    the first printed loss, steps, images/s and the steady step time
    (host clock, synced at the print boundaries), the fused kernel's
    launches, the grid and each rank's resident bytes of params, stats,
    moments and EMA, and its peak device memory (None on the CPU)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    os.makedirs(args.save_path, exist_ok=True)
    shutil.copy(__file__, os.path.join(args.save_path, 'main.py'))
    ranks = args.world_size * args.model_parallel
    if ranks == 1 or os.environ.get("PMDT_MASTER_ADDR"):
        return supervised_run(args)
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise SystemExit(
            f"--world_size {args.world_size} x --model_parallel "
            f"{args.model_parallel} needs {ranks} CUDA devices, this "
            f"machine has {torch.cuda.device_count()} (one rank per card; "
            "pass --device cpu for gloo ranks on the CPU)")
    return dist.spawn_ranks(_rank_main, ranks, argv)


if __name__ == "__main__":
    main()
