"""Ring attention: exact attention with the sequence split over the
``seq`` axis of the grid (the port of the JAX package's
``parallel/ring_attention.py``).

Q stays on its rank; K/V blocks travel around the ring of the axis's
ranks, one ``torch.distributed`` point-to-point exchange a hop (NCCL on
the cards, gloo on the CPU). Each hop runs the flash forward
(:func:`..ops.flash_attention.flash_fwd`: the CUDA kernel on the card)
on the resident Q and the visiting block, and the hop's ``(out_j,
lse_j)`` is folded into the running result with the streaming
log-sum-exp, in f32, so the result is exact attention over the global
sequence. The next hop's exchange is posted before the hop's kernels
run, into a second buffer, so the transfer overlaps the compute.

Causal, contiguous layout (rank ``i`` holds positions ``[i*s, (i+1)*s)``):
a block from rank ``src`` is fully visible (``src < i``), diagonal
(``src == i``, the causal kernel) or fully masked (``src > i``: nothing
folds and nothing launches). ``zigzag=True`` is the balanced layout:
rank ``i`` holds chunks ``i`` and ``2N-1-i`` of the ``2N``-chunked
sequence (:func:`zigzag_indices`), and each hop folds up to three
half-blocks (:func:`hop_schedule`), ``2N + 1`` a rank over a ring.

The backward (one autograd Function, as JAX's custom VJP) saves only
``(q, k, v, out, global lse)``. It forms ``dterm = rowsum(dO * O)`` once
and re-rotates K/V with their f32 gradient accumulators; each hop calls
the flash backward pair (:func:`..ops.flash_attention.flash_pair_grads`)
with the GLOBAL lse, which makes each block's gradient exact against
the full softmax. One last rotation brings the accumulators home.
Layouts are the flash API's: q/k/v ``[B, S, H, Dh]``, lse and dterm
``[B, H, S]`` f32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..ops.flash_attention import (NEG_INF, flash_dterm, flash_fwd,
                                   flash_pair_grads)
from .mesh import SEQ_AXIS, Axis
from .mesh import axis as grid_axis

# a quadrant of one hop: (rows of Q, columns of the visiting K/V, causal
# kernel?) with rows/columns "all" (contiguous layout) or the zigzag
# halves "a"/"b" (this rank's early/late chunk) and "c"/"d" (the visiting
# block's early/late chunk)
Quad = Tuple[str, str, bool]


def zigzag_indices(seq_len: int, n_shards: int) -> np.ndarray:
    """``[n_shards, seq_len // n_shards]`` global positions per shard:
    shard ``i`` holds chunks ``i`` and ``2 * n_shards - 1 - i`` of the
    ``2 * n_shards``-chunked sequence, concatenated."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zigzag needs seq_len divisible by 2 x n_shards "
            f"({seq_len} vs 2 x {n_shards})")
    c = seq_len // (2 * n_shards)
    idx = np.arange(seq_len).reshape(2 * n_shards, c)
    return np.stack([
        np.concatenate([idx[i], idx[2 * n_shards - 1 - i]])
        for i in range(n_shards)])


def hop_cases(src: int, my: int, causal: bool) -> Tuple[bool, bool]:
    """(fold anything, causal kernel) for a block from ``src`` on rank
    ``my`` in the contiguous layout."""
    if not causal:
        return True, False
    return src <= my, src == my


def hop_schedule(n: int, my: int, causal: bool = True,
                 zigzag: bool = False) -> List[Tuple[int, List[Quad]]]:
    """Per hop ``0..n-1``: the rank the visiting block comes from
    (``(my - hop) % n``: blocks move to the next rank each hop) and the
    quadrants rank ``my`` folds, in fold order. Zigzag: A (early rows x
    early columns) on the ``src <= my`` triangle, B (late rows x early
    columns) always and never masked, C (late rows x late columns) on
    the mirrored triangle; early rows never see late columns."""
    hops = []
    for hop in range(n):
        src = (my - hop) % n
        if zigzag:
            quads = [("a", "c", src == my)] if src <= my else []
            quads.append(("b", "c", False))
            if src >= my:
                quads.append(("b", "d", src == my))
        else:
            fold, diag = hop_cases(src, my, causal)
            quads = [("all", "all", diag)] if fold else []
        hops.append((src, quads))
    return hops


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, S]`` -> ``[B, S, H, 1]``, to scale ``[B, S, H, Dh]``."""
    return x.transpose(1, 2)[..., None]


def _lse_fold(state, out_j, lse_j):
    """Streaming log-sum-exp combine of one partial ``(out, lse)``."""
    o, m, z = state
    m_new = torch.maximum(m, lse_j)
    corr = torch.exp(m - m_new)
    w = torch.exp(lse_j - m_new)
    o = o * _rows(corr) + out_j.float() * _rows(w)
    return o, m_new, z * corr + w


class _Ring:
    """The exchange of one hop: send to the next rank of the axis,
    receive from the previous one, batched (``batch_isend_irecv``)."""

    def __init__(self, ax: Axis):
        self.group = ax.group
        self.to = ax.ranks[(ax.index + 1) % ax.size]
        self.frm = ax.ranks[(ax.index - 1) % ax.size]

    def start(self, send: torch.Tensor, recv: torch.Tensor, tag: int = 0):
        return tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, self.to, self.group, tag),
            tdist.P2POp(tdist.irecv, recv, self.frm, self.group, tag)])


def _wait(reqs) -> None:
    for req in reqs or ():
        req.wait()


def _parts(s: int, zigzag: bool):
    """Row/column slices by quadrant name."""
    if not zigzag:
        return {"all": slice(0, s)}
    hs = s // 2
    return {"a": slice(0, hs), "b": slice(hs, s), "c": slice(0, hs),
            "d": slice(hs, s)}


def _row_parts(zigzag: bool):
    """This rank's row pieces, in order."""
    return ("a", "b") if zigzag else ("all",)


def _ring_fwd(q, k, v, scale, causal, zigzag, ax):
    """``(out [B, S, H, Dh] in q's dtype, global lse [B, H, S] f32)``."""
    n, my = ax.size, ax.index
    b, s, h, d = q.shape
    part = _parts(s, zigzag)
    ring = _Ring(ax) if n > 1 else None
    kv = torch.stack((k, v))  # one contiguous buffer travels a hop
    spare = torch.empty_like(kv) if n > 1 else None
    states = {}
    for hop, (_, quads) in enumerate(hop_schedule(n, my, causal, zigzag)):
        reqs = ring.start(kv, spare) if hop < n - 1 else None
        for rows, cols, diag in quads:
            r, c = part[rows], part[cols]
            out_j, lse_j = flash_fwd(q[:, r], kv[0][:, c], kv[1][:, c],
                                     scale=scale, causal=diag)
            if rows not in states:
                rs = r.stop - r.start
                states[rows] = (
                    torch.zeros((b, rs, h, d), dtype=torch.float32,
                                device=q.device),
                    torch.full((b, h, rs), NEG_INF, dtype=torch.float32,
                               device=q.device),
                    torch.zeros((b, h, rs), dtype=torch.float32,
                                device=q.device))
            states[rows] = _lse_fold(states[rows], out_j, lse_j)
        if reqs is not None:
            _wait(reqs)  # the send of kv is done: it may take the next block
            kv, spare = spare, kv
    outs, lses = [], []
    for rows in _row_parts(zigzag):
        o, m, z = states[rows]
        z = z.clamp_min(1e-30)
        outs.append((o / _rows(z)).to(q.dtype))
        lses.append(m + torch.log(z))
    if len(outs) == 1:
        return outs[0], lses[0]
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _ring_bwd(q, k, v, out, lse, do, scale, causal, zigzag, ax):
    n, my = ax.size, ax.index
    part = _parts(q.shape[1], zigzag)
    ring = _Ring(ax) if n > 1 else None
    do_c = do.to(q.dtype).contiguous()
    dterm = flash_dterm(do, out)
    lse_of = {n_: lse[:, :, part[n_]].contiguous()
              for n_ in _row_parts(zigzag)}
    dt_of = {n_: dterm[:, :, part[n_]].contiguous()
             for n_ in _row_parts(zigzag)}
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    spare_kv = torch.empty_like(kv) if n > 1 else None
    spare_dkv = torch.empty_like(dkv) if n > 1 else None
    for hop, (_, quads) in enumerate(hop_schedule(n, my, causal, zigzag)):
        reqs = ring.start(kv, spare_kv) if hop < n - 1 else None
        for rows, cols, diag in quads:
            r, c = part[rows], part[cols]
            dq_p, dk_p, dv_p = flash_pair_grads(
                q[:, r], kv[0][:, c], kv[1][:, c], do_c[:, r], lse_of[rows],
                dt_of[rows], scale=scale, causal=diag)
            dq[:, r] += dq_p.float()
            dkv[0][:, c] += dk_p.float()
            dkv[1][:, c] += dv_p.float()
        if ring is not None:
            # the accumulators travel with their block; after the last hop
            # this rotation brings them home
            dreqs = ring.start(dkv, spare_dkv, tag=1)
            _wait(reqs)
            _wait(dreqs)
            dkv, spare_dkv = spare_dkv, dkv
            if reqs is not None:
                kv, spare_kv = spare_kv, kv
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The JAX ``_ring`` custom VJP: saves ``(q, k, v, out, lse)``, no
    per-hop residuals."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, zigzag, ax):
        out, lse = _ring_fwd(q, k, v, scale, causal, zigzag, ax)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, zigzag, ax)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = SEQ_AXIS, scale: Optional[float] = None,
                   causal: bool = False,
                   zigzag: bool = False) -> torch.Tensor:
    """Exact attention with K/V rotating over the grid axis ``axis_name``.

    Args:
      q, k, v: this rank's ``[batch, seq_local, heads, head_dim]``; the
        global sequence is split contiguously over the axis, or with
        ``zigzag=True`` in the :func:`zigzag_indices` layout (needs
        ``causal`` and an even ``seq_local``).
      scale: logit scale, default ``head_dim ** -0.5``.
      causal: causal mask over GLOBAL positions.

    Returns this rank's ``[batch, seq_local, heads, head_dim]`` slice of
    full attention, differentiable.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_loc = q.shape[1]
    if zigzag:
        if not causal:
            raise ValueError(
                "zigzag layout only applies to causal attention (there "
                "is no load imbalance to fix without causality)")
        if s_loc % 2:
            raise ValueError(
                f"zigzag needs an even per-shard sequence, got {s_loc}")
    return _RingAttention.apply(q, k, v, float(scale), bool(causal),
                                bool(zigzag), grid_axis(axis_name))
