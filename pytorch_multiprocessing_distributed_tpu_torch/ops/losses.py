"""Loss functions (the port of the JAX package's ``ops/losses.py``,
dense subset): softmax cross-entropy from integer targets, in f32, and
its label-smoothed form.

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
