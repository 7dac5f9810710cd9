"""LAMB (the port of the JAX package's ``train/lamb.py``; BASELINE config
#5 trains ConvNeXt under it), on the flat f32 buffers of
:class:`.state.TrainState`.

You, Li et al., "Large Batch Optimization for Deep Learning: Training
BERT in 76 minutes". Per leaf (a parameter of ``TrainState.layout``):

    m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p
    r = ||p|| / ||u||  (1 where either norm is 0)
    p <- p - lr * r * u

with ``t`` the update count after this step. The moments are the state's
``momentum`` (``mu``) and ``nu`` buffers, the count its ``count``. Where
the step's gradients are not finite the NaN guard keeps ``p``, ``mu``,
``nu`` and ``count`` as they were. The JAX package computes LAMB in XLA,
not in a Pallas kernel, so the port runs it as whole-buffer torch ops,
with the per-leaf norms in one multi-tensor call, in the JAX
``shard_update``/``shard_finish`` phases: :meth:`Lamb.direction_` (the
moments and ``u``, elementwise: on one rank's shards under ``--zero``)
and :meth:`Lamb.finish_` (the trust ratios and the LR on full leaves).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .optim import Schedule
from .state import TrainState


class Lamb:
    """LAMB with decoupled weight decay on flat f32 buffers."""

    second_moment = True  # the train state carries ``nu``

    def __init__(self, learning_rate: Union[float, Schedule] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def lr(self, lr_step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(lr_step))
        return float(np.float32(self.learning_rate))

    @torch.no_grad()
    def update_(self, state: TrainState, grads: torch.Tensor,
                keep: torch.Tensor) -> None:
        """One update of ``state.params``, its moments and count from the
        flat ``grads``; where the device bool ``keep`` is False all of
        them keep their old values."""
        u = self.direction_(state, grads, state.params, state.momentum,
                            state.nu, keep)
        self.finish_(state, u, keep)

    @torch.no_grad()
    def direction_(self, state: TrainState, grads: torch.Tensor,
                   params: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
        """The elementwise phase on flat buffers of one length: returns
        ``u`` (before the trust ratio) and writes the moments where
        ``keep``."""
        b1, b2 = self.b1, self.b2
        t = (state.count + 1).float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=params.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=params.device), t)
        new_mu = b1 * mu + (1 - b1) * grads
        new_nu = b2 * nu + (1 - b2) * grads.square()
        u = (new_mu / c1) / (torch.sqrt(new_nu / c2) + self.eps)
        u = u + self.weight_decay * params
        mu.copy_(torch.where(keep, new_mu, mu))
        nu.copy_(torch.where(keep, new_nu, nu))
        return u

    @torch.no_grad()
    def finish_(self, state: TrainState, u: torch.Tensor,
                keep: torch.Tensor) -> None:
        """The per-leaf phase on the full ``u``: trust ratios, broadcast
        back over each leaf's elements, and the LR; params and count
        where ``keep``. The norms are taken of exact copies (``x * 1.0``,
        each freshly allocated): on the card ``_foreach_norm`` sums a
        tensor in an order that follows its alignment, and ``--zero``
        lays the leaves at other offsets than the model order."""
        p = state.params
        p_norm, u_norm = (torch.stack(torch._foreach_norm(
            torch._foreach_mul(list(state.views(t).values()), 1.0)))
            for t in (p, u))
        ones = torch.ones_like(p_norm)
        r = torch.where(p_norm > 0,
                        torch.where(u_norm > 0, p_norm / u_norm, ones), ones)
        new_p = p + state.spread(-self.lr(state.epoch) * r) * u
        p.copy_(torch.where(keep, new_p, p))
        state.count.copy_(torch.where(keep, state.count + 1, state.count))


def lamb(learning_rate: Union[float, Schedule] = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0) -> Lamb:
    """The JAX ``lamb`` transform's defaults."""
    return Lamb(learning_rate, b1, b2, eps, weight_decay)
