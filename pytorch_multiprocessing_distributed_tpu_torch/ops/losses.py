"""Loss functions (the port of the JAX package's ``ops/losses.py``):
softmax cross-entropy from integer targets, in f32, its label-smoothed
form, and the LM head fused with the next-token CE and streamed over
vocab slices (:func:`chunked_lm_ce`, ``--vocab_chunks``).
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_per_sample(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """``[batch]`` per-sample CE: ``logsumexp(logits) - logits[target]``
    in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return logz - label


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy: ``logits [batch, classes]``,
    ``targets [batch]`` int labels."""
    return cross_entropy_per_sample(logits, targets).mean()


cross_entropy_loss.per_sample = cross_entropy_per_sample


def smooth_cross_entropy_loss(label_smoothing: float):
    """Mean cross-entropy with label smoothing ``eps`` — torch
    ``CrossEntropyLoss(label_smoothing=eps)``: ``(1 - eps) * CE(label) +
    eps * mean_c(-log p_c)``; ``eps = 0`` is :func:`cross_entropy_loss`
    itself. The returned loss carries its ``per_sample`` companion (the
    eval step's criterion)."""
    eps = float(label_smoothing)
    if not 0.0 <= eps < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got {eps}")
    if eps == 0.0:
        return cross_entropy_loss

    def per_sample_fn(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        label = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
        # mean over classes of -log p_c == logz - mean_c(logit_c)
        uniform = logz - logits.mean(dim=-1)
        return (1.0 - eps) * (logz - label) + eps * uniform

    def loss_fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return per_sample_fn(logits, targets).mean()

    loss_fn.per_sample = per_sample_fn
    return loss_fn


def _chunk_views(kernel, bias, n_chunks):
    """``(kernel chunks [n, D, Vc], bias chunks [n, Vc], Vc)`` in f32,
    the vocab padded to a multiple of ``n_chunks``: padded slots get bias
    -inf (no softmax mass) and kernel 0."""
    d, v = kernel.shape
    vc = -(-v // n_chunks)
    pad = n_chunks * vc - v
    kernel = torch.nn.functional.pad(kernel.float(), (0, pad))
    if bias is None:
        bias = kernel.new_zeros(v)
    bias = torch.nn.functional.pad(bias.float(), (0, pad),
                                   value=float("-inf"))
    return (kernel.reshape(d, n_chunks, vc).permute(1, 0, 2),
            bias.reshape(n_chunks, vc), vc)


def _in_chunk(tgt, c, vc):
    """(this chunk's column of each target, clamped; is it here?)."""
    idx = tgt - c * vc
    return idx.clamp(0, vc - 1), (idx >= 0) & (idx < vc)


class _ChunkedCE(torch.autograd.Function):
    """The JAX ``_chunked_ce`` custom VJP: the forward folds a streaming
    max and sum of exponentials over the vocab chunks, the backward
    recomputes each chunk's logits from the saved per-row lse."""

    @staticmethod
    def forward(ctx, h, kernel, bias, targets, weights, n_chunks):
        hf = h.reshape(-1, h.shape[-1])
        tgt = targets.reshape(-1).long()
        k_chunks, b_chunks, vc = _chunk_views(kernel, bias, n_chunks)
        n = hf.shape[0]
        m = hf.new_full((n,), float("-inf"))
        sse = hf.new_zeros(n)
        tlog = hf.new_zeros(n)
        for c in range(n_chunks):
            logits = hf @ k_chunks[c] + b_chunks[c]  # [N, Vc] f32
            m_new = torch.maximum(m, logits.max(dim=-1).values)
            sse = sse * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            idx, mine = _in_chunk(tgt, c, vc)
            picked = logits.gather(1, idx[:, None])[:, 0]
            tlog = tlog + torch.where(mine, picked, 0.0)
            m = m_new
        lse = torch.log(sse) + m
        ce_pos = lse - tlog
        ctx.save_for_backward(h, kernel, bias, targets, weights, lse,
                              ce_pos)
        ctx.n_chunks = n_chunks
        return (ce_pos * weights.reshape(-1)).sum()

    @staticmethod
    def backward(ctx, g):
        h, kernel, bias, targets, weights, lse, ce_pos = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        hf = h.reshape(-1, h.shape[-1])
        tgt = targets.reshape(-1).long()
        gw = (g * weights.reshape(-1)).float()
        k_chunks, b_chunks, vc = _chunk_views(kernel, bias, n_chunks)
        dh = torch.zeros_like(hf)
        dks, dbs = [], []
        rows = torch.arange(hf.shape[0], device=hf.device)
        for c in range(n_chunks):
            logits = hf @ k_chunks[c] + b_chunks[c]  # recomputed
            p = torch.exp(logits - lse[:, None])
            idx, mine = _in_chunk(tgt, c, vc)
            p[rows, idx] -= mine.float()  # p - onehot
            dl = gw[:, None] * p
            dh = dh + dl @ k_chunks[c].T
            dks.append(hf.T @ dl)
            dbs.append(dl.sum(dim=0))
        v = kernel.shape[1]
        dkernel = torch.cat(dks, dim=1)[:, :v]
        dbias = None if bias is None else torch.cat(dbs)[:v]
        dweights = (g * ce_pos).reshape(weights.shape).to(weights.dtype)
        return (dh.reshape(h.shape).to(h.dtype), dkernel, dbias, None,
                dweights, None)


def chunked_lm_ce(h: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor], targets: torch.Tensor,
                  weights: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Next-token CE fused with the LM head, streamed over ``n_chunks``
    vocab slices: ``sum(weights * CE)``, the dense value, while the
    ``[B, S, V]`` logits never exist in either pass (live memory
    ``O(B*S*V / n_chunks)``).

    Args:
      h: ``[B, S, D]`` final hidden states (after the final LayerNorm).
      kernel: ``[D, V]`` head weights; bias ``[V]`` or None.
      targets: ``[B, S]`` int next-token labels; weights ``[B, S]`` f32.
      n_chunks: vocab slices (V padded up to a multiple).
    """
    return _ChunkedCE.apply(h.float(), kernel, bias, targets, weights,
                            int(n_chunks))
