"""Mixture-of-Experts feed-forward (the port of the JAX package's
``ops/moe.py`` ``MoEMlp``, without its expert-axis sharding).

Routing, as in JAX (Switch top-1 by default; ``top_k >= 2`` is GShard's
renormalized top-k with choice-priority capacity):

  gates  = softmax(x @ gate)                 [B, S, E], f32 always
  expert = top_k(gates) choices              [B, S, K], ties to the
           lower expert (``jax.lax.top_k``'s order)
  slot   = position of each (token, choice) within its expert's
           capacity C = max(1, ceil(S * K * capacity_factor / E)),
           choice j claiming slots only after every choice < j;
           assignments past capacity are DROPPED (output 0)
  y[b, s] = sum_j weight_j * expert_mlp_{expert_j}(x[b, s])
           (weight = the raw top probability for K = 1, the top-K
           probabilities renormalized else)

The dispatch and the combine are JAX's dense one-hot einsums over
``[B, S, E, C]`` masks (deterministic, and exact for top-1: each
``(expert, row, slot)`` holds at most one token); the experts are one
batched ReLU MLP per expert in the model dtype. The layer also returns
the Switch load-balancing loss ``E * <f, p>`` (``f`` the share of tokens
whose primary choice is each expert, ``p`` the mean router probability)
and the ST-MoE router z-loss (mean squared logsumexp of the router
logits): the two values JAX sows into its ``losses`` collection.

:meth:`MoEMlp.dropless` is the decode path's layer (JAX
``inference/generate.py`` ``_moe_ffn``): every expert runs on every
token and the combine masks all but the chosen ones, so no token drops.

The expert products stay PyTorch matmuls, as XLA computed them for
JAX: the layer reaches no Pallas kernel there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"),
                        requires_grad=False)


def capacity(seq_len: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """JAX's per-expert capacity ``max(1, ceil(S * K * factor / E))``,
    with its float floor division."""
    return max(1, int(-(-seq_len * top_k * capacity_factor // n_experts)))


def top_k_lower_first(gates: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of the last
    dim, equal values in the order of their index (``jax.lax.top_k``);
    a stable descending sort gives that order on every device."""
    values, indices = torch.sort(gates, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def route(gate: torch.Tensor, x32: torch.Tensor, top_k: int):
    """The router on f32 inputs ``x32`` ``[B, S, D]``: ``(logits, gates,
    weights [B, S, K], experts [B, S, K])``."""
    logits = x32.float() @ gate
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k_lower_first(gates, top_k)
    weights = topv if top_k == 1 else topv / topv.sum(-1, keepdim=True)
    return logits, gates, weights, topi


def dispatch_masks(onehots: torch.Tensor, cap: int):
    """Per-choice dispatch masks ``[B, S, E, C]`` (f32) from the choices'
    one-hots ``[B, S, K, E]``: choice ``j``'s tokens take an expert's
    slots in sequence order after every choice ``< j``; a slot past
    ``cap`` drops. Returns ``(masks, slots [B, S, K] int64, kept [B, S,
    K] bool)``."""
    b, _, k, e = onehots.shape
    offset = onehots.new_zeros((b, 1, e))
    masks, slots, kept = [], [], []
    for j in range(k):
        oh = onehots[:, :, j]                                # [B, S, E]
        pos = (oh.cumsum(1) + offset) * oh                   # 1-based
        slot = (pos.sum(-1) - 1.0).to(torch.int64)
        offset = offset + oh.sum(1, keepdim=True)
        keep = slot < cap
        masks.append(oh[..., None]
                     * F.one_hot(slot.clamp(0, cap - 1), cap).float()[
                         :, :, None, :]
                     * keep[..., None, None].float())
        slots.append(slot)
        kept.append(keep)
    return masks, torch.stack(slots, -1), torch.stack(kept, -1)


class MoEMlp(nn.Module):
    """The MoE feed-forward's parameters, in JAX's names and ``[in,
    out]`` layouts: ``gate [D, E]``, ``w1 [E, D, H]``, ``b1 [E, H]``,
    ``w2 [E, H, D]``, ``b2 [E, D]`` (on the ``meta`` device until bound,
    as the GPT's)."""

    def __init__(self, d: int, n_experts: int, d_hidden: int,
                 capacity_factor: float = 1.0, top_k: int = 1):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(
                f"top_k must be in [1, n_experts={n_experts}], got {top_k}")
        self.n_experts = n_experts
        self.d_hidden = d_hidden
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.gate = _meta(d, n_experts)
        self.w1 = _meta(n_experts, d, d_hidden)
        self.b1 = _meta(n_experts, d_hidden)
        self.w2 = _meta(n_experts, d_hidden, d)
        self.b2 = _meta(n_experts, d)

    def capacity(self, seq_len: int) -> int:
        return capacity(seq_len, self.top_k, self.capacity_factor,
                        self.n_experts)

    def _experts(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """Expert ``e``'s ReLU MLP on ``x[e]`` ``[E, N, D]`` in
        ``dtype``."""
        h = torch.relu(torch.bmm(x, self.w1.to(dtype))
                       + self.b1.to(dtype)[:, None, :])
        return torch.bmm(h, self.w2.to(dtype)) + self.b2.to(dtype)[:, None, :]

    def forward(self, x: torch.Tensor, dtype=None,
                stats_group: Optional[Tuple[object, int]] = None):
        """The training layer on ``x`` ``[B, S, D]`` (the f32 LN output):
        ``(y, aux, z)`` with ``y`` in ``x``'s dtype, experts in
        ``dtype`` (default ``x``'s).

        ``stats_group`` ``(group, n)``, ``n > 1``: the layer runs on one
        of ``n`` equal row shards of a batch whose statistics are global
        (JAX's GSPMD step): ``f`` is averaged over the group, and ``aux``
        and ``z`` come back as this shard's share (their sums over the
        group are the global values)."""
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        cap = self.capacity(s)
        dtype = dtype or x.dtype
        logits, gates, weights, topi = route(self.gate, x, k)
        onehots = F.one_hot(topi, e).float()                 # [B, S, K, E]
        f = onehots[:, :, 0].reshape(-1, e).mean(0)
        p = gates.reshape(-1, e).mean(0)
        z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        if stats_group is not None:
            group, n = stats_group
            f = f.detach().clone()
            tdist.all_reduce(f, group=group)
            f, p, z = f / n, p / n, z / n
        aux = e * (f * p).sum()
        masks, _, _ = dispatch_masks(onehots, cap)
        # a token's choices go to different experts: the masks are
        # disjoint and their sum stays one-hot
        dispatch = sum(masks)
        xin = x.to(dtype)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), xin)
        h = self._experts(expert_in.reshape(e, b * cap, d), dtype)
        combine = sum(masks[j] * weights[:, :, j, None, None]
                      for j in range(k))
        y = torch.einsum("bsec,ebcd->bsd", combine.to(dtype),
                         h.reshape(e, b, cap, d))
        return y.to(x.dtype), aux, z

    def dropless(self, x32: torch.Tensor, dtype) -> torch.Tensor:
        """The decode layer on the f32 LN output ``x32`` ``[B, S, D]``:
        every expert on every token, the combine keeping each token's
        top-k with the training layer's weights; f32 out. The training
        layer's result wherever its capacity does not bind."""
        b, s, d = x32.shape
        e = self.n_experts
        _, _, weights, topi = route(self.gate, x32, self.top_k)
        xin = x32.to(dtype).reshape(1, b * s, d).expand(e, b * s, d)
        ys = self._experts(xin, dtype).reshape(e, b, s, d)
        onehots = F.one_hot(topi, e).float()                 # [B, S, K, E]
        combine = torch.einsum("bske,bsk->bse", onehots, weights)
        y = torch.einsum("bse,ebsd->bsd", combine.to(dtype), ys)
        return y.float()
