"""Language-model train and eval steps, data and sequence parallel
(the port of the JAX package's ``train/lm.py``).

The JAX step runs under ``shard_map`` over a ``data`` mesh, or a
``(data, seq)`` mesh under sequence parallelism; here each process is
one rank of that grid (:func:`..parallel.mesh.make_grid`, rank ``r`` at
data index ``r // degree`` and seq index ``r % degree``). A rank takes
its data index's contiguous rows of the global batch (:func:`local_rows`,
the ``P("data")`` split) and hands the step those rows at the full
sequence length; under ``seq_axis`` the step keeps its seq index's
columns (:func:`seq_columns`, after the zigzag permutation under
``sp_mode="zigzag"``), with next-token targets formed on the whole rows
first, so a shard's last target is the next shard's first token. The
normalisation is the JAX one: each rank differentiates its LOCAL CE sum
divided by the GLOBAL predictable-token count ``B * (S - 1)``, and the
gradients are then SUMMED over every rank of the grid (one all-reduce
of the flat gradient buffer, which also carries the CE sums).

``vocab_chunks > 1`` streams the head and the CE over vocab slices
(:func:`..ops.losses.chunked_lm_ce`). Not in this slice: MoE aux
losses, ``remat`` and ``zero`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.losses import chunked_lm_ce, cross_entropy_per_sample
from ..parallel import get_rank, get_world_size, psum_
from ..parallel.mesh import axis as grid_axis
from ..parallel.mesh import data_size
from ..parallel.ring_attention import zigzag_indices
from .optim import SGD
from .state import TrainState
from .step import finite_grads, strided_microbatches


def _next_token_targets(tokens: torch.Tensor, columns=None):
    """(targets, valid) of whole rows ``tokens [b, S]``: ``targets[:, j]``
    is the token after position ``j``; ``valid`` masks the final
    position, which has none. ``columns`` (:func:`seq_columns`) keeps a
    sequence shard's positions of both."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
    valid = torch.cat([torch.ones((b, s - 1), dtype=torch.bool,
                                  device=tokens.device),
                       torch.zeros((b, 1), dtype=torch.bool,
                                   device=tokens.device)], dim=1)
    if columns is None:
        return targets, valid
    return targets[:, columns], valid[:, columns]


def seq_columns(seq_len: int, n: int, index: int,
                zigzag: bool = False) -> np.ndarray:
    """The global positions sequence shard ``index`` of ``n`` holds, in
    its order: a contiguous block, or chunks ``index`` and ``2n-1-index``
    under zigzag. Raises, with the JAX step's words, where the length
    does not split."""
    if seq_len % n:
        raise ValueError(
            f"seq_len {seq_len} is not divisible by the sequence-axis "
            f"size {n} (mesh axis 'seq')")
    if zigzag:
        return zigzag_indices(seq_len, n)[index]
    s = seq_len // n
    return np.arange(index * s, (index + 1) * s)


def _shard(rows: torch.Tensor, seq_axis: Optional[str], zigzag: bool):
    """(tokens, targets, valid) of this rank from its whole rows."""
    if seq_axis is None:
        return (rows, *_next_token_targets(rows))
    ax = grid_axis(seq_axis)
    cols = torch.from_numpy(seq_columns(rows.shape[1], ax.size, ax.index,
                                        zigzag)).to(rows.device)
    return (rows[:, cols], *_next_token_targets(rows, cols))


def _ce_sum(model, tokens, targets, w, vocab_chunks=0):
    if vocab_chunks > 1:
        hidden = model(tokens, return_hidden=True)
        return chunked_lm_ce(hidden, model.head.kernel, model.head.bias,
                             targets, w, vocab_chunks)
    logits = model(tokens)
    ce = cross_entropy_per_sample(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))
    return (ce.reshape(targets.shape) * w).sum()


def _zigzag(model, seq_axis) -> bool:
    return seq_axis is not None and getattr(model, "sp_mode",
                                            "ring") == "zigzag"


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


def make_lm_train_step(model, optimizer: SGD, *, grad_accum: int = 1,
                       seq_axis: Optional[str] = None,
                       vocab_chunks: int = 0):
    """Build ``step(state, rows) -> (state, metrics)``.

    ``rows`` are this rank's ``[b, S]`` rows of the global batch on the
    model's device (:func:`local_rows`), at the full sequence length.
    ``seq_axis`` (the model built with the same one) splits them over the
    grid's sequence axis. ``grad_accum`` splits the rows into strided
    microbatches whose gradients accumulate before the one all-reduce
    (the same update as one shot); ``vocab_chunks > 1`` streams the head
    and CE over that many vocab slices. ``metrics`` are device tensors:
    ``loss`` (mean next-token CE over every predictable position of the
    global batch), ``count`` and ``skipped`` (1 when the NaN guard kept
    the old state).
    """
    if grad_accum < 1:
        raise ValueError(
            f"grad_accum must be >= 1, got {grad_accum} (1 = no "
            "accumulation)")
    zigzag = _zigzag(model, seq_axis)

    def step(state: TrainState, rows: torch.Tensor):
        b, s = rows.shape
        if b % grad_accum:
            raise ValueError(
                f"per-rank batch {b} is not divisible by grad_accum="
                f"{grad_accum}")
        tokens, targets, valid = _shard(rows, seq_axis, zigzag)
        w = valid.float()
        # the global predictable count B * (S - 1): every data replica
        # holds b whole rows (the JAX psum of the local counts)
        count = float(b * data_size() * (s - 1))
        state.grads.zero_()
        for tok, tgt, ww in zip(strided_microbatches(tokens, grad_accum),
                                strided_microbatches(targets, grad_accum),
                                strided_microbatches(w, grad_accum)):
            ce_sum = _ce_sum(state.model, tok, tgt, ww, vocab_chunks)
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


def make_lm_eval_step(model, *, seq_axis: Optional[str] = None,
                      vocab_chunks: int = 0):
    """Forward-only next-token CE: ``eval_step(state, rows) -> {loss,
    count}``, the exact masked mean over the global batch (one
    all-reduce of ``[ce_sum, count]``); ``rows``, ``seq_axis`` and
    ``vocab_chunks`` as in :func:`make_lm_train_step`."""
    zigzag = _zigzag(model, seq_axis)

    @torch.no_grad()
    def eval_step(state: TrainState, rows: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        tokens, targets, valid = _shard(rows, seq_axis, zigzag)
        w = valid.float()
        sums = torch.stack([_ce_sum(state.model, tokens, targets, w,
                                    vocab_chunks), w.sum()])
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
