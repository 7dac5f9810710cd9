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

The eval step runs the model in eval mode (running stats) and sums the
masked loss, correct and top-5 counts over ranks in one all-reduce, so
the sampler's wraparound duplicates count nowhere.

Not in this slice: ``grad_accum``, ``clip_grad_norm``, EMA, ``remat``,
ZeRO and the GSPMD (tensor-parallel) steps (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..ops.losses import cross_entropy_loss, cross_entropy_per_sample
from ..parallel import get_world_size, psum_
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


def create_train_state(model, optimizer=None) -> TrainState:
    """The image train state over ``model``'s current weights (load
    them first: :func:`..models.init_model` or ``load_state_dict`` of a
    carried JAX tree): params and BN stats moved into flat buffers, zero
    momenta (and LAMB's zero second moment where ``optimizer`` keeps
    one), epoch 1."""
    return TrainState.bind(
        model, extra=IMAGE_SLOTS,
        second_moment=getattr(optimizer, "second_moment", False))


def make_train_step(model, optimizer,
                    loss_fn: Callable = cross_entropy_loss):
    """Build ``step(state, images, labels) -> (state, metrics)``.

    ``state`` comes from :func:`create_train_state`; ``images`` are this rank's ``[b, 32, 32, 3]`` f32 rows and ``labels``
    its ``[b]`` int labels, on the model's device. ``metrics`` are
    device tensors, already reduced over ranks: ``loss`` (the mean of
    the ranks' mean losses), ``correct`` and ``count`` (global sums),
    ``prec1`` (percent) and ``skipped`` (1 when the NaN guard kept the
    old state).
    """

    def step(state: TrainState, images: torch.Tensor,
             labels: torch.Tensor):
        model.train()
        n, world = state.n, get_world_size()
        stats_before = state.stats.clone()
        state.grads.zero_()
        logits = model(images)
        loss = loss_fn(logits, labels)
        (loss / world if world > 1 else loss).backward()
        with torch.no_grad():
            slots = state.grads[n:]
            slots[0] = loss / world if world > 1 else loss
            slots[1] = correct_count(logits, labels)
            psum_(state.grads)
            finite = finite_grads(state.grads[:n])
            optimizer.update_(state, state.grads[:n], finite)
            state.stats.copy_(guard_nonfinite(finite, state.stats,
                                              stats_before))
            count = torch.tensor(float(labels.shape[0] * world),
                                 device=logits.device)
            metrics = {"loss": slots[0].clone(), "correct": slots[1].clone(),
                       "count": count,
                       "prec1": 100.0 * slots[1] / count,
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
