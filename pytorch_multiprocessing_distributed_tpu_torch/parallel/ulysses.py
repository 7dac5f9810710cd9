"""Ulysses sequence parallelism: an all-to-all re-partition from
sequence to heads (the port of the JAX package's
``parallel/ulysses.py``).

Inputs arrive ``[b, s_local, h, d]`` (the sequence split over the
``seq`` axis). One ``all_to_all_single`` of the stacked q/k/v hands
each rank ``h / N`` heads over the FULL sequence, the flash kernels
(:func:`..ops.flash_attention.flash_attention`) run locally, causal or
not, and a second all-to-all restores ``[b, s_local, h, d]``. The
backward of each exchange is the inverse exchange. Needs ``heads %
N == 0``; the ring has no such limit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from ..ops.flash_attention import flash_attention
from .mesh import SEQ_AXIS, Axis
from .mesh import axis as grid_axis


def _check_heads(h: int, axis_size: int) -> None:
    if h % axis_size:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"sequence-axis size ({axis_size}); use ring_attention for "
            "head counts that do not divide")


def _all_to_all(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Chunk ``j`` of ``x``'s dim 0 to the axis's rank ``j``; the result's
    chunk ``j`` came from rank ``j``."""
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=ax.group)
    return out


def _seq_to_heads(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[3, b, s, h, d]`` -> ``[3, b, N*s, h/N, d]``."""
    t, b, s, h, d = x.shape
    n = ax.size
    x = x.reshape(t, b, s, n, h // n, d).permute(3, 0, 1, 2, 4, 5)
    y = _all_to_all(x.contiguous(), ax)  # [N (seq chunk), t, b, s, h/N, d]
    return y.permute(1, 2, 0, 3, 4, 5).reshape(t, b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[..., b, N*s, h/N, d]`` -> ``[..., b, s, h, d]`` (leading dims
    kept), the inverse of :func:`_seq_to_heads`."""
    *lead, b, ns, hn, d = x.shape
    n = ax.size
    k = len(lead)
    x = x.reshape(*lead, b, n, ns // n, hn, d)
    # the seq chunk to the front: [N, *lead, b, s, h/N, d]
    x = x.permute(k + 1, *range(k + 1), *range(k + 2, k + 5))
    y = _all_to_all(x.contiguous(), ax)  # [N (head group), ...]
    # the head group beside the heads: [*lead, b, s, N, h/N, d]
    y = y.permute(*range(1, k + 3), 0, k + 3, k + 4)
    return y.reshape(*lead, b, ns // n, n * hn, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _seq_to_heads(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.ax), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _heads_to_seq(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous()[None], ctx.ax)[0], None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str = SEQ_AXIS,
                      scale: Optional[float] = None,
                      causal: bool = False) -> torch.Tensor:
    """Exact attention with the sequence split over the grid axis
    ``axis_name`` (the layout of :func:`.ring_attention.ring_attention`,
    contiguous): this rank's ``[batch, seq_local, heads, head_dim]``
    slice of full attention, differentiable."""
    ax = grid_axis(axis_name)
    _check_heads(q.shape[2], ax.size)
    if ax.size == 1:
        return flash_attention(q, k, v, scale=scale, causal=causal)
    qh, kh, vh = _SeqToHeads.apply(torch.stack((q, k, v)), ax)
    out = flash_attention(qh, kh, vh, scale=scale, causal=causal)
    return _HeadsToSeq.apply(out, ax)
