"""Loss functions (the port of the JAX package's ``ops/losses.py``,
dense subset): softmax cross-entropy from integer targets, in f32.

The streamed head + CE (``chunked_lm_ce``, ``--vocab_chunks``) is not
in this slice (ROADMAP.md).
"""

from __future__ import annotations

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
