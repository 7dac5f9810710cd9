"""SGD and LR schedules (the port of the JAX package's ``train/optim.py``,
``sgd``/``cosine_lr`` subset).

torch-exact SGD(momentum, weight decay, Nesterov), the rule the JAX
``sgd`` transform pins against ``torch.optim.SGD``:

    g   = grad + wd * param
    buf = momentum * buf + g          (first step: buf = g)
    d   = g + momentum * buf          (nesterov)  |  d = buf
    param -= lr * d

The port runs it on the flat f32 buffers of
:class:`..train.state.TrainState` (a handful of whole-buffer ops, no
loop over leaves) and selects the old values back where the step's
gradients were not finite — on the device, with no host sync. The LR is
a float or a schedule of the epoch, evaluated on the host (the epoch is
a host integer), in f32 like the JAX schedule.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from .step import guard_nonfinite

Schedule = Callable[[int], float]


def cosine_lr(base_lr: float, total_epochs: int, warmup_epochs: int = 0,
              min_lr: float = 0.0) -> Schedule:
    """Cosine decay with linear warmup, epoch-indexed from 1 (the JAX
    ``cosine_lr``: the first post-warmup epoch trains at ``base_lr``, the
    last just above ``min_lr``)."""
    if total_epochs < 1:
        raise ValueError(f"total_epochs must be >= 1, got {total_epochs}")
    if not 0 <= warmup_epochs < total_epochs:
        raise ValueError(
            f"warmup_epochs must be in [0, total_epochs), got "
            f"{warmup_epochs} of {total_epochs}")
    f32 = np.float32

    def schedule(epoch: int) -> float:
        e = f32(epoch)
        if e <= warmup_epochs:
            return float(f32(base_lr) * e / f32(max(warmup_epochs, 1)))
        span = f32(max(total_epochs - warmup_epochs, 1))
        t = np.clip((e - f32(warmup_epochs) - f32(1)) / span, f32(0),
                    f32(1))
        cos = f32(1) + np.cos(f32(np.pi) * t, dtype=f32)
        return float(f32(min_lr) + (f32(base_lr) - f32(min_lr))
                     * f32(0.5) * cos)

    return schedule


class SGD:
    """Nesterov SGD with weight decay on flat f32 buffers."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.1,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = True):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def lr(self, lr_step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(lr_step))
        return float(np.float32(self.learning_rate))

    @torch.no_grad()
    def apply_(self, params: torch.Tensor, grads: torch.Tensor,
               buf: torch.Tensor, initialized: torch.Tensor,
               count: torch.Tensor, keep: torch.Tensor,
               lr_step: int) -> None:
        """One update of ``params`` and ``buf`` in place from ``grads``
        (all flat f32 of one length), then ``initialized`` set and
        ``count`` advanced. Where the device bool ``keep`` is False all
        four keep their old values (the NaN guard's skip)."""
        lr = self.lr(lr_step)
        g = grads + self.weight_decay * params
        new_buf = torch.where(initialized, self.momentum * buf + g, g)
        d = g + self.momentum * new_buf if self.nesterov else new_buf
        new_params = params - lr * d
        params.copy_(guard_nonfinite(keep, new_params, params))
        buf.copy_(guard_nonfinite(keep, new_buf, buf))
        initialized.logical_or_(keep)
        count.add_(keep.to(count.dtype))


def sgd(learning_rate: Union[float, Schedule] = 0.1, momentum: float = 0.9,
        weight_decay: float = 1e-4, nesterov: bool = True) -> SGD:
    """The JAX ``sgd`` transform's defaults (the reference's optimizer)."""
    return SGD(learning_rate, momentum, weight_decay, nesterov)
