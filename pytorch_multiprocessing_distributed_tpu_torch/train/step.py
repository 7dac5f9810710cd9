"""Train-step helpers shared by the steps (the port of the JAX package's
``train/step.py``: ``finite_grads``, ``guard_nonfinite`` and
``strided_microbatches``).

The NaN/inf guard stays on the device: the all-finite predicate is a
bool tensor, the update selects between new and old values with
``torch.where``, and the skip rides the metrics dict (``skipped``) to
the trainer's print boundary — no host sync per step.
"""

from __future__ import annotations

import torch


def finite_grads(grads: torch.Tensor) -> torch.Tensor:
    """On-device all-finite predicate (bool scalar) over the flat,
    already summed gradients."""
    return torch.isfinite(grads).all()


def guard_nonfinite(finite: torch.Tensor, new: torch.Tensor,
                    old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``finite``, else ``old`` (a skipped step carries
    params and momenta through unchanged)."""
    return torch.where(finite, new, old)


def strided_microbatches(x: torch.Tensor, accum: int) -> torch.Tensor:
    """``[b, ...] -> [accum, b // accum, ...]``, STRIDED: sample ``i`` goes
    to microbatch ``i % accum`` (the JAX convention)."""
    b = x.shape[0]
    return x.reshape(b // accum, accum, *x.shape[1:]).transpose(0, 1)
