"""DenseNet-BC (the port of the JAX package's ``models/densenet.py``;
the reference CLI's ``--model dense``).

A 3x3 stem of ``2 * growth`` channels; dense blocks of bottleneck layers
(BN-ReLU-1x1 conv to ``4 * growth`` -> BN-ReLU-3x3 conv to ``growth``,
concatenated onto the input's channels); transitions between blocks
(BN-ReLU-1x1 conv to ``reduction`` of the channels, 2x2 average pool);
a final BN-ReLU, a global average pool and a linear head. Convs have no
bias and draw He-normal over the fan-out; every BN is the port's
:class:`..ops.batch_norm.SyncBatchNorm`. Module names are the flax ones
(``stem``, ``block{i}_layer{j}.{bn1,conv1,bn2,conv2}``,
``transition{i}.{bn,conv}``, ``bn_final``, ``linear``), so
:func:`load_jax_densenet` carries a JAX tree across.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import SyncBatchNorm
from .init import carry_jax_variables
from .registry import register
from .resnet import Conv2d


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, dtype: torch.dtype):
        super().__init__()
        self.bn1 = SyncBatchNorm(cin, dtype=dtype)
        self.conv1 = Conv2d(cin, 4 * growth_rate, 1)
        self.bn2 = SyncBatchNorm(4 * growth_rate, dtype=dtype)
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3)

    def forward(self, x):
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([x, h], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.bn = SyncBatchNorm(cin, dtype=dtype)
        self.conv = Conv2d(cin, features, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2)


class DenseNet(nn.Module):
    """Input ``[batch, H, W, 3]`` NHWC, output ``[batch, num_classes]``
    f32 logits; ``dtype`` is the compute dtype."""

    conv_init = "he_fan_out"

    def __init__(self, block_sizes: Sequence[int], growth_rate: int = 12,
                 reduction: float = 0.5, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layout = []  # module names in forward order
        ch = 2 * growth_rate
        self.stem = Conv2d(3, ch, 3)
        for i, n_layers in enumerate(block_sizes):
            for j in range(n_layers):
                name = f"block{i}_layer{j}"
                self.add_module(name, DenseLayer(ch, growth_rate, dtype))
                self.layout.append(name)
                ch += growth_rate
            if i != len(block_sizes) - 1:
                features = int(ch * reduction)
                name = f"transition{i}"
                self.add_module(name, Transition(ch, features, dtype))
                self.layout.append(name)
                ch = features
        self.bn_final = SyncBatchNorm(ch, dtype=dtype)
        self.linear = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        for name in self.layout:
            out = getattr(self, name)(out)
        out = F.relu(self.bn_final(out)).mean(dim=(2, 3))
        return F.linear(out, self.linear.weight.to(self.dtype),
                        self.linear.bias.to(self.dtype)).float()


def DenseNet121(**kw) -> DenseNet:
    return DenseNet((6, 12, 24, 16), growth_rate=32, **kw)


def DenseNetBC100(**kw) -> DenseNet:
    """DenseNet-BC(L=100, k=12): 3 blocks of 16 bottleneck layers."""
    return DenseNet((16, 16, 16), growth_rate=12, **kw)


register("dense")(DenseNet121)  # the reference CLI name
register("densenet121")(DenseNet121)
register("densenet_bc100")(DenseNetBC100)


def load_jax_densenet(params, batch_stats):
    """A JAX DenseNet's ``(params, batch_stats)`` as the port's
    ``state_dict`` (:func:`.init.carry_jax_variables`)."""
    return carry_jax_variables(params, batch_stats)
