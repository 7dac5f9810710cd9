"""Language-model train and eval steps, data parallel (the port of the
JAX package's ``train/lm.py``, DP subset).

The JAX step runs under ``shard_map`` over a ``data`` mesh; here each
process is one data-parallel rank and gets its contiguous rows of the
global batch (:func:`local_rows`, the ``P("data")`` split). The
normalisation is the JAX one: each rank differentiates its LOCAL CE sum
divided by the GLOBAL predictable-token count, and the gradients are
then SUMMED across ranks (one all-reduce of the flat gradient buffer,
which also carries the CE sums) — a mean over ranks would be wrong by
the world size whenever shards differ.

Not in this slice: sequence parallelism (``seq_axis``), MoE aux losses,
chunked CE (``vocab_chunks``), ``remat`` and ``zero`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.losses import cross_entropy_per_sample
from ..parallel import get_rank, get_world_size, psum_
from .optim import SGD
from .state import TrainState
from .step import finite_grads, strided_microbatches


def _next_token_targets(tokens: torch.Tensor):
    """(targets, valid): ``targets[:, j]`` is the token after position
    ``j``; ``valid`` masks the final position, which has none."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
    valid = torch.cat([torch.ones((b, s - 1), dtype=torch.bool,
                                  device=tokens.device),
                       torch.zeros((b, 1), dtype=torch.bool,
                                   device=tokens.device)], dim=1)
    return targets, valid


def _ce_sum(model, tokens, targets, w):
    logits = model(tokens)
    ce = cross_entropy_per_sample(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))
    return (ce.reshape(targets.shape) * w).sum()


def local_rows(batch: np.ndarray, rank: Optional[int] = None,
               world: Optional[int] = None) -> np.ndarray:
    """This rank's contiguous rows of the global ``[B, S]`` batch."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    b = batch.shape[0]
    if b % world:
        raise ValueError(
            f"global batch {b} must divide by the data-parallel size "
            f"{world}")
    per = b // world
    return batch[rank * per:(rank + 1) * per]


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host tokens -> ``device`` with one pinned, non-blocking copy (a
    plain tensor on the CPU)."""
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def make_lm_train_step(model, optimizer: SGD, *, grad_accum: int = 1):
    """Build ``step(state, tokens) -> (state, metrics)``.

    ``tokens`` are this rank's ``[b, S]`` rows on the model's device
    (:func:`local_rows`). ``grad_accum`` splits them into strided
    microbatches whose gradients accumulate before the one all-reduce
    (the same update as one shot). ``metrics`` are device tensors:
    ``loss`` (mean next-token CE over every predictable position of the
    global batch), ``count`` and ``skipped`` (1 when the NaN guard kept
    the old state).
    """
    if grad_accum < 1:
        raise ValueError(
            f"grad_accum must be >= 1, got {grad_accum} (1 = no "
            "accumulation)")

    def step(state: TrainState, tokens: torch.Tensor):
        b, s = tokens.shape
        if b % grad_accum:
            raise ValueError(
                f"per-rank batch {b} is not divisible by grad_accum="
                f"{grad_accum}")
        targets, valid = _next_token_targets(tokens)
        w = valid.float()
        # the global predictable count: every rank holds b rows with s-1
        # predictable positions each (the JAX psum of the local counts)
        count = float(b * get_world_size() * (s - 1))
        state.grads.zero_()
        for tok, tgt, ww in zip(strided_microbatches(tokens, grad_accum),
                                strided_microbatches(targets, grad_accum),
                                strided_microbatches(w, grad_accum)):
            ce_sum = _ce_sum(state.model, tok, tgt, ww)
            (ce_sum / count).backward()
            state.grads[state.n:].add_(ce_sum.detach())
        psum_(state.grads)
        finite = finite_grads(state.grads[:state.n])
        optimizer.apply_(state.params, state.grads[:state.n],
                         state.momentum, state.initialized, state.count,
                         finite, lr_step=state.epoch)
        metrics = {"loss": state.grads[state.n] / count,
                   "count": torch.tensor(count),
                   "skipped": (~finite).to(torch.int32)}
        return state, metrics

    return step


def make_lm_eval_step(model):
    """Forward-only next-token CE: ``eval_step(state, tokens) -> {loss,
    count}``, the exact masked mean over the global batch (one
    all-reduce of ``[ce_sum, count]``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        targets, valid = _next_token_targets(tokens)
        w = valid.float()
        sums = torch.stack([_ce_sum(state.model, tokens, targets, w),
                            w.sum()])
        psum_(sums)
        return {"loss": sums[0] / sums[1], "count": sums[1]}

    return eval_step


def create_lm_train_state(model, params: Dict[str, torch.Tensor]
                          ) -> TrainState:
    """Bind ``params`` (a ``state_dict``-keyed dict on the target device:
    :func:`..serving.params.init_params` or ``from_jax_params``) into the
    model and return the :class:`TrainState` over them: parameters as
    trainable leaf views of one flat buffer, zero momenta, epoch 1."""
    model.load_state_dict(params, assign=True)
    return TrainState.bind(model)
