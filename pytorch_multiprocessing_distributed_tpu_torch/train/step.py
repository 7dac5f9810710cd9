"""The image data-parallel train and eval steps, and the helpers every
step shares (the port of the JAX package's ``train/step.py``:
``make_train_step``, ``make_eval_step``, ``finite_grads``,
``guard_nonfinite`` and ``strided_microbatches``).

The JAX step is one ``shard_map`` program over a ``data`` mesh; here each
process is one data-parallel rank holding its rows of the global batch,
and the step is eager PyTorch on the flat buffers of
:class:`.state.TrainState`:

- forward in train mode, the BatchNorm statistics synchronized across
  ranks inside the forward (:mod:`..ops.batch_norm`);
- backward of the local mean loss scaled by ``1 / world``, then ONE
  all-reduce of the flat gradient buffer, whose two metric slots carry
  the loss and the correct count along — the gradients and the loss
  come out as JAX's ``pmean``, the count as its ``psum``;
- the NaN guard: the all-finite predicate of the summed gradients stays
  on the device; the optimizer (plain or fused) writes nothing where it
  is False, and the BN running stats are put back;
- the update: SGD, plain or fused (``SGD.fused``), or LAMB
  (:mod:`.lamb`).

The JAX step's transforms, in its order:

- ``grad_accum``: the rank's rows split into STRIDED microbatches (row
  ``i`` to microbatch ``i % grad_accum``), each backward accumulating
  into the flat gradient buffer, the sum then divided by
  ``grad_accum``; the loss is the mean of the microbatch means, the
  correct count their sum, and BatchNorm's running stats take one
  momentum update a microbatch, as JAX's scan does;
- ``remat``: the loss function (forward and criterion) under
  ``torch.utils.checkpoint`` (non-reentrant), the JAX ``jax.checkpoint``
  scope; the backward recomputes the forward, so the BN statistics of
  the first forward are kept and the recompute's second momentum update
  undone (the recompute's all-reduces run on every rank, as JAX's do);
- the NaN guard's predicate off the reduced gradients, BEFORE clipping;
- ``clip_grad_norm``: the f32 global norm of the averaged gradients,
  scaled by ``min(1, C / (norm + 1e-6))`` before the optimizer (the
  fused kernel reads clipped gradients);
- the update; then ``ema_decay``: ``ema = d * ema + (1 - d) * params``,
  kept where the guard skips.

Under ``--zero`` (a state sharded by :func:`..parallel.zero.
zeroify_state`) the all-reduce becomes the bucketed reduce-scatter, the
guard's predicate and the clip's squared norm are summed from the
shards, and the update is :func:`..parallel.zero.apply_sharded_update`;
the metric slots then ride a small all-reduce of their own with those
two partial sums.

The eval step runs the model in eval mode (running stats) and sums the
masked loss, correct and top-5 counts over ranks in one all-reduce, so
the sampler's wraparound duplicates count nowhere.

The GSPMD steps (``--zero1``, ``--fsdp``, ``--model_parallel``) are
:mod:`.gspmd`'s, on a state placed by :mod:`.placement`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.losses import cross_entropy_loss, cross_entropy_per_sample
from ..parallel import get_rank, get_world_size, psum_
from ..parallel import zero as zero_mod
from ..runtime import hbm
from ..utils.metrics import correct_count, topk_accuracy
from .state import TrainState

# the image step's metric slots after the gradients in TrainState.grads
IMAGE_SLOTS = 2  # [loss / world, correct]


def finite_grads(grads: torch.Tensor) -> torch.Tensor:
    """On-device all-finite predicate (bool scalar) over the flat,
    already summed gradients."""
    return torch.isfinite(grads).all()


def guard_nonfinite(finite: torch.Tensor, new: torch.Tensor,
                    old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``finite``, else ``old`` (a skipped step carries
    its state through unchanged)."""
    return torch.where(finite, new, old)


def strided_microbatches(x: torch.Tensor, accum: int) -> torch.Tensor:
    """``[b, ...] -> [accum, b // accum, ...]``, STRIDED: sample ``i`` goes
    to microbatch ``i % accum`` (the JAX convention)."""
    b = x.shape[0]
    return x.reshape(b // accum, accum, *x.shape[1:]).transpose(0, 1)


def create_train_state(model, optimizer=None, ema: bool = False,
                       plan=None) -> TrainState:
    """The image train state over ``model``'s current weights (load
    them first: :func:`..models.init_model` or ``load_state_dict`` of a
    carried JAX tree): params and BN stats moved into flat buffers, zero
    momenta (and LAMB's zero second moment where ``optimizer`` keeps
    one), with ``ema`` an EMA seeded from the params, epoch 1. ``plan``
    (a :class:`..parallel.zero.ZeroPlan`) lays the buffers out for
    ``--zero``; shard the moments with
    :func:`..parallel.zero.zeroify_state` after any resume."""
    layout = ({} if plan is None else
              {"offsets": plan.offsets(), "size": plan.size})
    return TrainState.bind(
        model, extra=IMAGE_SLOTS,
        second_moment=getattr(optimizer, "second_moment", False), ema=ema,
        **layout)


def register_state_hbm(state: TrainState, prefix: str = "train") -> None:
    """A state's resident bytes on the armed device-memory ledger (JAX
    ``train/step.py:627-653``; one global read when disarmed): params,
    the optimizer state (moments, ``count``, and SGD's ``initialized``:
    JAX's ``OptState`` leaves; LAMB's state has no flag), the BatchNorm
    statistics and the EMA, each its own entry. A sharded state's
    buffers hold this rank's slices, so the bytes are this rank's."""
    if hbm.active_ledger() is None:
        return
    hbm.register(f"{prefix}.params", hbm.shard_nbytes(state.params),
                 category="params")
    opt = [state.momentum, state.nu, state.count]
    if state.nu is None:
        opt.append(state.initialized)
    hbm.register(f"{prefix}.opt_state", hbm.tree_shard_nbytes(opt),
                 category="opt_state")
    if state.stats is not None and state.stats.numel():
        hbm.register(f"{prefix}.batch_stats", hbm.shard_nbytes(state.stats),
                     category="params")
    if state.ema is not None:
        hbm.register(f"{prefix}.ema_params", hbm.shard_nbytes(state.ema),
                     category="params")


def _check_transforms(grad_accum, clip_grad_norm, ema_decay) -> None:
    """The JAX step's argument checks, with its messages."""
    if grad_accum < 1:
        raise ValueError(
            f"grad_accum must be >= 1, got {grad_accum} (1 = no "
            "accumulation; 0/negative would silently disable it)")
    if clip_grad_norm is not None and not clip_grad_norm > 0:
        raise ValueError(
            f"clip_grad_norm must be > 0, got {clip_grad_norm} (a "
            "negative bound would NEGATE gradients; pass None to disable)")
    if ema_decay is not None and not 0.0 < ema_decay < 1.0:
        raise ValueError(
            f"ema_decay must be in (0, 1), got {ema_decay} (>= 1 "
            "diverges exponentially; pass None to disable)")


def make_train_step(model, optimizer,
                    loss_fn: Callable = cross_entropy_loss, *,
                    remat: bool = False, grad_accum: int = 1,
                    clip_grad_norm: Optional[float] = None,
                    ema_decay: Optional[float] = None):
    """Build ``step(state, images, labels) -> (state, metrics)``.

    ``state`` comes from :func:`create_train_state` (zero-sharded for
    ``--zero``); ``images`` are this rank's ``[b, H, W, 3]`` f32 rows and
    ``labels`` its ``[b]`` int labels, on the model's device. ``metrics``
    are device tensors, already reduced over ranks: ``loss`` (the mean of
    the ranks' mean losses), ``correct`` and ``count`` (global sums),
    ``prec1`` (percent) and ``skipped`` (1 when the NaN guard kept the
    old state). ``remat``, ``grad_accum``, ``clip_grad_norm`` and
    ``ema_decay`` are the JAX step's transforms (see the module note).
    """
    _check_transforms(grad_accum, clip_grad_norm, ema_decay)

    def loss_and_logits(images, labels):
        logits = model(images)
        return loss_fn(logits, labels), logits

    def backward(state, images, labels, world):
        """One forward and backward into the gradient buffer; returns
        the (unscaled) loss and the correct count."""
        if remat:
            loss, logits = checkpoint(loss_and_logits, images, labels,
                                      use_reentrant=False)
            stats = state.stats.clone()  # the first forward's statistics
        else:
            loss, logits = loss_and_logits(images, labels)
        (loss / world if world > 1 else loss).backward()
        if remat:
            with torch.no_grad():
                state.stats.copy_(stats)
        return loss.detach(), correct_count(logits, labels)

    def step(state: TrainState, images: torch.Tensor,
             labels: torch.Tensor):
        model.train()
        n, world = state.n, get_world_size()
        stats_before = state.stats.clone()
        state.grads.zero_()
        if grad_accum > 1:
            b = images.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"per-device batch {b} is not divisible by "
                    f"grad_accum={grad_accum} (per-device batch {b} as "
                    "seen by this rank; the global batch is b x "
                    "world_size)")
            xs = strided_microbatches(images, grad_accum)
            ys = strided_microbatches(labels, grad_accum)
            loss = correct = None
            for k in range(grad_accum):
                lk, ck = backward(state, xs[k].contiguous(),
                                  ys[k].contiguous(), world)
                loss = lk if loss is None else loss + lk
                correct = ck if correct is None else correct + ck
            with torch.no_grad():
                state.grads[:n].div_(grad_accum)
                loss = loss / grad_accum
        else:
            loss, correct = backward(state, images, labels, world)
        with torch.no_grad():
            g = state.grads[:n]
            loss_slot = loss / world if world > 1 else loss
            if state.zero is not None:
                shards = zero_mod.reduce_scatter_grads(g, state.zero,
                                                       state.grad_shards)
                side = torch.stack([
                    loss_slot, correct.to(loss.dtype),
                    zero_mod.finite_shards(shards),
                    torch.sum(torch.square(shards)) if clip_grad_norm
                    else torch.zeros_like(loss)])
                psum_(side)
                finite = side[2] == 0
                if clip_grad_norm:
                    zero_mod.clip_shards_by_global_norm(shards, side[3],
                                                        clip_grad_norm)
                zero_mod.apply_sharded_update(optimizer, state, shards,
                                              finite, get_rank())
                loss_sum, correct_sum = side[0], side[1]
            else:
                slots = state.grads[n:]
                slots[0] = loss_slot
                slots[1] = correct
                psum_(state.grads)
                finite = finite_grads(g)
                if clip_grad_norm:
                    gnorm = torch.sqrt(torch.sum(torch.square(g)))
                    g.mul_(torch.clamp(clip_grad_norm / (gnorm + 1e-6),
                                       max=1.0))
                optimizer.update_(state, g, finite)
                loss_sum, correct_sum = slots[0], slots[1]
            if ema_decay and state.ema is not None:
                new_ema = (ema_decay * state.ema
                           + (1.0 - ema_decay) * state.params)
                state.ema.copy_(guard_nonfinite(finite, new_ema,
                                                state.ema))
            state.stats.copy_(guard_nonfinite(finite, state.stats,
                                              stats_before))
            count = torch.tensor(float(labels.shape[0] * world),
                                 device=loss.device)
            metrics = {"loss": loss_sum.clone(),
                       "correct": correct_sum.clone(), "count": count,
                       "prec1": 100.0 * correct_sum / count,
                       "skipped": (~finite).to(torch.int32)}
        return state, metrics

    return step


def make_eval_step(model, loss_fn: Callable = cross_entropy_loss):
    """Build ``eval_step(state, images, labels, valid) -> metrics``: the
    model in eval mode (BN running stats), the per-sample criterion of
    the train loss (``loss_fn.per_sample``, plain CE otherwise) and the
    correct and top-5 counts, each summed over the rows where ``valid``
    is True and over ranks. ``metrics`` are device tensors: ``loss_sum``,
    ``correct``, ``correct5``, ``count``, ``loss``, ``prec1``,
    ``prec5``."""
    per_sample = getattr(loss_fn, "per_sample", cross_entropy_per_sample)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        logits = model(images)
        w = valid.float()
        hit = (logits.argmax(dim=-1) == labels).float()
        _, correct = topk_accuracy(logits, labels,
                                   topk=(min(5, logits.shape[-1]),))
        top5 = correct.any(dim=0).float()
        sums = torch.stack([(per_sample(logits, labels) * w).sum(),
                            (hit * w).sum(), (top5 * w).sum(), w.sum()])
        psum_(sums)
        safe = sums[3].clamp(min=1.0)
        return {"loss_sum": sums[0], "correct": sums[1],
                "correct5": sums[2], "count": sums[3],
                "loss": sums[0] / safe, "prec1": 100.0 * sums[1] / safe,
                "prec5": 100.0 * sums[2] / safe}

    return eval_step
