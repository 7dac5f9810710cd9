"""The GSPMD image train and eval steps on a ``(data, model)`` grid of
ranks (the port of the JAX package's ``make_train_step_tp`` and
``make_eval_step_tp``, with the ``_train_body`` they share at
``axis_name=None``), for ``--zero1``, ``--fsdp`` and
``--model_parallel``.

The JAX step has global semantics: the loss is the mean over the global
batch and BatchNorm's statistics are taken over it; the placements
(:mod:`.placement`) say where each leaf lives and GSPMD inserts the
collectives. Here each rank holds its slices of the state
(:class:`.placement.PlacedState`) and the rows of its data index (the
``M`` ranks of a data replica see one batch, JAX's ``P(data)`` input):

- forward in train mode: a module's weights are all-gathered from their
  slices when it reads them, BatchNorm sums over the data group;
- backward of the local mean loss over ``1 / dp``: each weight's full
  gradient is reduced over ``data`` into this rank's moment slice (a
  reduce-scatter where ``--zero1``/``--fsdp`` shard the moments over
  ``data``, an all-reduce where they do not);
- the NaN guard's non-finite count, the clip's per-leaf squared norms,
  the loss and the correct count in ONE all-reduce over the grid; a
  leaf held whole by several ranks counts once (its sum over the grid
  is divided by the number of ranks holding each of its elements);
- the update on the moment slices: SGD elementwise, LAMB's trust ratios
  from per-leaf norms summed the same way; where the params are placed
  more coarsely than the moments (``--zero1``), the updated slices are
  all-gathered over ``data`` back into the params' slices;
- the EMA (placed like the params) and the guard's selects, as in the
  data-parallel step (:mod:`.step`).

The transforms compose as in JAX: ``grad_accum`` (strided microbatches
of the replica's rows), ``clip_grad_norm`` (the global norm over every
slice, each element once), ``ema_decay`` and ``remat``. On a 1 x 1 grid
every slice is the whole leaf and the step runs the data-parallel step's
ops on the same buffers: bit-equal to it.

The M ranks of a replica compute the same forward and backward on the
whole weights (JAX's placements, not GSPMD's split of the compute: the
footprint of the state per card falls by the grid, the compute per card
does not).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as tdist
from torch.nn.utils import parametrize
from torch.utils.checkpoint import checkpoint

from ..ops.losses import cross_entropy_loss, cross_entropy_per_sample
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..utils.metrics import correct_count, topk_accuracy
from .lamb import Lamb
from .placement import PlacedState, assemble
from .step import _check_transforms, guard_nonfinite, strided_microbatches


def _replicas(state: PlacedState) -> torch.Tensor:
    """Per leaf of the moments: how many ranks of the grid hold each of
    its elements (the grid's size over the pieces it is cut into)."""
    grid = state.grid
    out = []
    for leaf in state.placement.opt:
        pieces = ((grid.data if DATA_AXIS in leaf.spec else 1)
                  * (grid.model if MODEL_AXIS in leaf.spec else 1))
        out.append(grid.size // pieces)
    return torch.tensor(out, dtype=torch.float32,
                        device=state.params.device)


def _psum_grid(state: PlacedState, x: torch.Tensor) -> torch.Tensor:
    if state.grid.size > 1:
        tdist.all_reduce(x)
    return x


def _opt_sizes(state: PlacedState) -> torch.Tensor:
    """Per leaf: the elements of this rank's moment slice."""
    pl = state.placement
    return torch.tensor([leaf.local_shape(pl.dp, pl.tp).numel()
                         for leaf in pl.opt], device=state.params.device)


@torch.no_grad()
def _leaf_norms(state: PlacedState, flat: torch.Tensor,
                replicas: torch.Tensor) -> torch.Tensor:
    """The whole norm of each leaf of the local ``opt`` buffer ``flat``:
    the norm of a leaf this rank holds whole, else the root of its
    squared slice norms summed over the grid (each element once). The
    local norms are taken of fresh copies, as LAMB's are."""
    views = state.leaf_views(flat, "opt")
    local = torch.stack(torch._foreach_norm(torch._foreach_mul(views, 1.0)))
    whole = replicas == state.grid.size
    if bool(whole.all()):
        return local
    total = _psum_grid(state, local.square()) / replicas
    return torch.where(whole, local, torch.sqrt(total))


@torch.no_grad()
def _update(optimizer, state: PlacedState, keep: torch.Tensor,
            replicas: torch.Tensor, sizes: torch.Tensor) -> None:
    """The update on this rank's moment slices (see the module note)."""
    if getattr(optimizer, "fused", False):
        raise ValueError(
            "the GSPMD step updates slices; the fused whole-update kernel "
            "cannot run on them — use --optimizer sgd")
    pl, grid = state.placement, state.grid
    d = grid.data_index
    coarse = [p.spec != o.spec for p, o in zip(pl.params, pl.opt)]
    if any(coarse):
        # the params' slices are wider than the moments' (--zero1):
        # this rank's moment slice of each
        p = torch.cat([
            o.slice(v, d, 0, grid.data, 1).reshape(-1) if c
            else v.reshape(-1)
            for v, o, c in zip(state.leaf_views(state.params, "params"),
                               pl.opt, coarse)])
    else:
        p = state.params
    g = state.grads
    if isinstance(optimizer, Lamb):
        u = optimizer.direction_(state, g, p, state.momentum, state.nu,
                                 keep)
        p_norm = _leaf_norms(state, p, replicas)
        u_norm = _leaf_norms(state, u, replicas)
        ones = torch.ones_like(p_norm)
        r = torch.where(p_norm > 0,
                        torch.where(u_norm > 0, p_norm / u_norm, ones), ones)
        scale = torch.repeat_interleave(-optimizer.lr(state.epoch) * r,
                                        sizes, output_size=p.numel())
        p.copy_(torch.where(keep, p + scale * u, p))
        state.count.copy_(torch.where(keep, state.count + 1, state.count))
    else:
        optimizer.apply_(p, g, state.momentum, state.initialized,
                         state.count, keep, lr_step=state.epoch)
    if any(coarse):
        every = p.new_empty(grid.data * p.numel())
        if grid.data > 1:
            tdist.all_gather_into_tensor(every, p, group=grid.data_group)
        else:
            every.copy_(p)
        every = every.view(grid.data, -1)
        for v, o, c, off in zip(state.leaf_views(state.params, "params"),
                                pl.opt, coarse, pl.offsets("opt")):
            n = v.numel() // (grid.data if c else 1)
            piece = every[:, off:off + n]
            if c:
                v.copy_(assemble(piece.reshape(grid.data, 1, *(
                    o.slice(v, 0, 0, grid.data, 1).shape)), o, v.shape,
                    model=False))
            else:
                v.copy_(p[off:off + n].view(v.shape))


def make_train_step_tp(model, optimizer,
                       loss_fn: Callable = cross_entropy_loss, *,
                       remat: bool = False, grad_accum: int = 1,
                       clip_grad_norm: Optional[float] = None,
                       ema_decay: Optional[float] = None):
    """Build ``step(state, images, labels) -> (state, metrics)`` for a
    :class:`.placement.PlacedState` (JAX ``make_train_step_tp``).
    ``images``/``labels`` are the rows of this rank's data index.
    ``metrics`` are device tensors reduced over the grid, as the
    data-parallel step's (:func:`.step.make_train_step`)."""
    _check_transforms(grad_accum, clip_grad_norm, ema_decay)
    cache = {}

    def loss_and_logits(images, labels):
        logits = model(images)
        return loss_fn(logits, labels), logits

    def backward(state, images, labels, dp, full_stats):
        with parametrize.cached():
            if remat:
                loss, logits = checkpoint(loss_and_logits, images, labels,
                                          use_reentrant=False)
                stats = full_stats.clone()
            else:
                loss, logits = loss_and_logits(images, labels)
            (loss / dp if dp > 1 else loss).backward()
        if remat:
            with torch.no_grad():
                full_stats.copy_(stats)
        return loss.detach(), correct_count(logits, labels)

    def step(state: PlacedState, images: torch.Tensor,
             labels: torch.Tensor):
        if "sizes" not in cache:
            cache.update(sizes=_opt_sizes(state),
                         replicas=_replicas(state))
        grid = state.grid
        dp, tp = grid.data, grid.model
        model.train()
        stats_before = state.stats.clone()
        state.grads.zero_()
        with state.stats_in_use(keep=True) as full_stats:
            if grad_accum > 1:
                b = images.shape[0]
                if b % grad_accum:
                    raise ValueError(
                        f"per-device batch {b} is not divisible by "
                        f"grad_accum={grad_accum} (global batch "
                        f"{b * dp}, data-parallel degree {dp})")
                xs = strided_microbatches(images, grad_accum)
                ys = strided_microbatches(labels, grad_accum)
                loss = correct = None
                for k in range(grad_accum):
                    lk, ck = backward(state, xs[k].contiguous(),
                                      ys[k].contiguous(), dp, full_stats)
                    loss = lk if loss is None else loss + lk
                    correct = ck if correct is None else correct + ck
                with torch.no_grad():
                    state.grads.div_(grad_accum)
                    loss = loss / grad_accum
            else:
                loss, correct = backward(state, images, labels, dp,
                                         full_stats)
        with torch.no_grad():
            g = state.grads
            replicas = cache["replicas"]
            # one all-reduce: loss, correct, the non-finite count and,
            # with clipping, each leaf's squared norm; the model ranks of
            # a replica repeat its loss and count, a whole leaf's held
            # slices repeat it: each divided out
            parts = [(loss / dp if dp > 1 else loss).reshape(1),
                     correct.to(loss.dtype).reshape(1),
                     (~torch.isfinite(g)).sum().to(loss.dtype).reshape(1)]
            if clip_grad_norm:
                parts.append(torch.segment_reduce(
                    g.square(), "sum", lengths=cache["sizes"]))
            side = _psum_grid(state, torch.cat(parts))
            loss_sum, correct_sum = side[0] / tp, side[1] / tp
            finite = side[2] == 0
            if clip_grad_norm:
                gnorm = torch.sqrt(torch.sum(side[3:] / replicas))
                g.mul_(torch.clamp(clip_grad_norm / (gnorm + 1e-6),
                                   max=1.0))
            _update(optimizer, state, finite, replicas, cache["sizes"])
            if ema_decay and state.ema is not None:
                new_ema = (ema_decay * state.ema
                           + (1.0 - ema_decay) * state.params)
                state.ema.copy_(guard_nonfinite(finite, new_ema,
                                                state.ema))
            state.stats.copy_(guard_nonfinite(finite, state.stats,
                                              stats_before))
            count = torch.tensor(float(labels.shape[0] * dp),
                                 device=loss.device)
            metrics = {"loss": loss_sum, "correct": correct_sum,
                       "count": count,
                       "prec1": 100.0 * correct_sum / count,
                       "skipped": (~finite).to(torch.int32)}
        return state, metrics

    return step


def make_eval_step_tp(model, loss_fn: Callable = cross_entropy_loss):
    """Build ``eval_step(state, images, labels, valid) -> metrics`` for a
    :class:`.placement.PlacedState` (JAX ``make_eval_step_tp``): the
    data-parallel eval step's masked sums (:func:`.step.make_eval_step`)
    over the rows of this rank's data index, summed over the data
    group."""
    per_sample = getattr(loss_fn, "per_sample", cross_entropy_per_sample)

    @torch.no_grad()
    def eval_step(state: PlacedState, images: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        with state.stats_in_use(keep=False), parametrize.cached():
            logits = model(images)
        w = valid.float()
        hit = (logits.argmax(dim=-1) == labels).float()
        _, correct = topk_accuracy(logits, labels,
                                   topk=(min(5, logits.shape[-1]),))
        top5 = correct.any(dim=0).float()
        sums = torch.stack([(per_sample(logits, labels) * w).sum(),
                            (hit * w).sum(), (top5 * w).sum(), w.sum()])
        grid = state.grid
        if grid.data > 1:
            tdist.all_reduce(sums, group=grid.data_group)
        safe = sums[3].clamp(min=1.0)
        return {"loss_sum": sums[0], "correct": sums[1],
                "correct5": sums[2], "count": sums[3],
                "loss": sums[0] / safe, "prec1": 100.0 * sums[1] / safe,
                "prec5": 100.0 * sums[2] / safe}

    return eval_step
