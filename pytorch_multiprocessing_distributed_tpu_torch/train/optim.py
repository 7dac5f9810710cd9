"""SGD and LR schedules (the port of the JAX package's ``train/optim.py``:
``sgd``, the fused ``sgd_pallas`` seam, ``multistep_lr`` and
``cosine_lr``).

torch-exact SGD(momentum, weight decay, Nesterov), the rule the JAX
``sgd`` transform pins against ``torch.optim.SGD``:

    g   = grad + wd * param
    buf = momentum * buf + g          (first step: buf = g)
    d   = g + momentum * buf          (nesterov)  |  d = buf
    param -= lr * d

The port runs it on the flat f32 buffers of
:class:`..train.state.TrainState` and keeps the old values where the
step's gradients were not finite — on the device, with no host sync.
``fused=False`` (``--optimizer sgd``) runs a handful of whole-buffer
torch ops (:func:`..ops.fused_update.torch_fused_sgd_`); ``fused=True``
(``--optimizer sgd_fused``, the JAX ``Transform.apply`` seam) runs the
single-pass kernel :func:`..ops.fused_update.fused_sgd_` on the card
and the same plain ops on the CPU. Under ``--zero`` the update runs in the
JAX ``shard_update``/``shard_finish`` phases instead
(:meth:`SGD.direction_` on this rank's shards, :meth:`SGD.finish_` on
the gathered direction), the plain version's own ops: bit-identical to
it. The LR is a float or a schedule of
the epoch, evaluated on the host (the epoch is a host integer), in f32
like the JAX schedule.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from ..ops.fused_update import fused_sgd_, sgd_direction, torch_fused_sgd_

Schedule = Callable[[int], float]


def multistep_lr(base_lr: float, milestones: Sequence[int] = (60, 80),
                 gamma: float = 0.1) -> Schedule:
    """torch ``MultiStepLR``: ``base * gamma ** (#milestones <= epoch)``
    (the JAX ``multistep_lr``: the drop takes effect at the milestone
    epoch itself), in f32."""
    ms = sorted(int(m) for m in milestones)
    f32 = np.float32

    def schedule(epoch: int) -> float:
        n_passed = sum(1 for m in ms if epoch >= m)
        return float(f32(base_lr) * np.power(f32(gamma), f32(n_passed),
                                             dtype=f32))

    return schedule


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
    """Nesterov SGD with weight decay on flat f32 buffers; ``fused``
    selects the single-pass kernel (``--optimizer sgd_fused``)."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.1,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = True, fused: bool = False):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.fused = fused

    def lr(self, lr_step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(lr_step))
        return float(np.float32(self.learning_rate))

    def update_(self, state, grads: torch.Tensor,
                keep: torch.Tensor) -> None:
        """One update of ``state`` (a :class:`.state.TrainState`) from
        the flat ``grads``, at the state's epoch (see :meth:`apply_`)."""
        self.apply_(state.params, grads, state.momentum, state.initialized,
                    state.count, keep, lr_step=state.epoch)

    @torch.no_grad()
    def apply_(self, params: torch.Tensor, grads: torch.Tensor,
               buf: torch.Tensor, initialized: torch.Tensor,
               count: torch.Tensor, keep: torch.Tensor,
               lr_step: int) -> None:
        """One update of ``params`` and ``buf`` in place from ``grads``
        (all flat f32 of one length), then ``initialized`` set and
        ``count`` advanced. Where the device bool ``keep`` is False all
        four keep their old values (the NaN guard's skip)."""
        update = fused_sgd_ if self.fused else torch_fused_sgd_
        update(params, grads, buf, initialized, count, keep,
               lr=self.lr(lr_step), momentum=self.momentum,
               weight_decay=self.weight_decay, nesterov=self.nesterov)

    @torch.no_grad()
    def direction_(self, state, grads: torch.Tensor, params: torch.Tensor,
                   momentum: torch.Tensor, nu, keep: torch.Tensor
                   ) -> torch.Tensor:
        """The elementwise phase (the JAX ``shard_update``) on flat
        buffers of one length: returns the direction ``d`` (no LR) and
        writes the new momentum where ``keep``."""
        d, new_buf = sgd_direction(params, grads, momentum,
                                   state.initialized,
                                   momentum=self.momentum,
                                   weight_decay=self.weight_decay,
                                   nesterov=self.nesterov)
        momentum.copy_(torch.where(keep, new_buf, momentum))
        return d

    @torch.no_grad()
    def finish_(self, state, d: torch.Tensor, keep: torch.Tensor) -> None:
        """The JAX ``shard_finish`` on the full direction: ``params -=
        lr * d``, ``initialized`` set and ``count`` advanced, where
        ``keep``."""
        p = state.params
        p.copy_(torch.where(keep, p - self.lr(state.epoch) * d, p))
        state.initialized.logical_or_(keep)
        state.count.add_(keep.to(state.count.dtype))


def sgd(learning_rate: Union[float, Schedule] = 0.1, momentum: float = 0.9,
        weight_decay: float = 1e-4, nesterov: bool = True) -> SGD:
    """The JAX ``sgd`` transform's defaults (the reference's optimizer)."""
    return SGD(learning_rate, momentum, weight_decay, nesterov)


def sgd_fused(learning_rate: Union[float, Schedule] = 0.1,
              momentum: float = 0.9, weight_decay: float = 1e-4,
              nesterov: bool = True) -> SGD:
    """The JAX ``sgd_pallas``: the same trajectory as :func:`sgd`, with
    the update in the fused kernel on the card."""
    return SGD(learning_rate, momentum, weight_decay, nesterov, fused=True)
