"""Cross-rank synchronized batch normalization (the port of the JAX
package's ``ops/batch_norm.py``; torch ``SyncBatchNorm`` semantics, as
the reference gets them from ``convert_sync_batchnorm``).

- statistics in f32 whatever the compute dtype;
- the biased batch variance ``E[x^2] - E[x]^2`` over the GLOBAL batch
  normalizes;
- running stats ``(1 - momentum) * running + momentum * stat`` with
  momentum 0.1, the running variance from the unbiased estimate
  ``var * n / (n - 1)`` over the global count ``n``;
- eval mode normalizes with the running stats.

Across ranks the statistics are ONE all-reduce of ``(sum, sum of
squares)`` per layer, through :class:`_SumOverRanks`, whose backward
all-reduces the cotangents: each rank's input gradient flows through the
global mean and so depends on every rank's activations, as the gradient
through ``lax.pmean`` does under ``shard_map``. One process does no
collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist
from torch import nn

from ..parallel.mesh import data_group, data_size

MOMENTUM = 0.1  # torch convention: the new statistic's weight
EPS = 1e-5      # torch's BatchNorm epsilon


class _SumOverRanks(torch.autograd.Function):
    """``psum`` over the data group, differentiable: the backward is
    the ``psum`` of the cotangents (the transpose of a sum that every
    rank reads)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        tdist.all_reduce(grad, op=tdist.ReduceOp.SUM, group=data_group())
        return grad


class SyncBatchNorm(nn.Module):
    """BatchNorm over (batch, spatial) of an NCHW tensor (any memory
    format), synchronized over the data-parallel group (the grid's data
    group under ``--model_parallel``: the model ranks of one replica see
    one batch).

    Args:
      num_features: channels.
      dtype: output dtype (the model's compute dtype); None keeps the
        input's. Statistics and the affine math are f32.
    """

    def __init__(self, num_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_features = num_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1, 1, 1)
        if self.training:
            c = self.num_features
            dims = (0, 2, 3)
            sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims)])
            n = x.numel() // c
            world = data_size()
            if world > 1:
                sums = _SumOverRanks.apply(sums)
                n *= world
            mean, mean_sq = sums[:c] / n, sums[c:] / n
            var = mean_sq - mean * mean  # biased: normalizes
            with torch.no_grad():
                m = MOMENTUM
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(self.dtype or x.dtype)
