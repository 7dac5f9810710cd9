"""The VGG family with BatchNorm (the port of the JAX package's
``models/vgg.py``; the reference CLI's ``--model vgg``).

Stacks of 3x3 conv (no bias) + sync BN + ReLU with 2x2 max-pools between
stages, then a linear head on the flattened features: 1x1x512 after five
pools at 32x32, 7x7x512 at 224. Module names are the flax ones
(``conv{i}``, ``bn{i}``, ``linear``), so :func:`load_jax_vgg` carries a
JAX tree across; the head's input is flattened in NHWC order, as flax
flattens it. ``image_size`` sizes the head (flax infers it from the first
input). Convs draw He-normal over the fan-out (``conv_kernel_init``).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import SyncBatchNorm
from .init import carry_jax_variables
from .registry import register
from .resnet import Conv2d

# stage configs: ints are conv widths, 'M' is a 2x2 max-pool
CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """Input ``[batch, image_size, image_size, 3]`` NHWC, output
    ``[batch, num_classes]`` f32 logits; ``dtype`` is the compute dtype
    (params and BN statistics stay f32)."""

    conv_init = "he_fan_out"

    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, image_size: int = 32):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dtype = dtype
        cin, side, i = 3, image_size, 0
        for item in self.cfg:
            if item == "M":
                side //= 2
                continue
            self.add_module(f"conv{i}", Conv2d(cin, item, 3))
            self.add_module(f"bn{i}", SyncBatchNorm(item, dtype=dtype))
            cin, i = item, i + 1
        self.linear = nn.Linear(side * side * cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
        i = 0
        for item in self.cfg:
            if item == "M":
                out = F.max_pool2d(out, 2)
            else:
                conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
                out = F.relu(bn(conv(out)))
                i += 1
        out = out.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC order
        return F.linear(out, self.linear.weight.to(self.dtype),
                        self.linear.bias.to(self.dtype)).float()


def _ctor(depth: int):
    def make(**kw) -> VGG:
        return VGG(CFGS[depth], **kw)

    make.__name__ = f"VGG{depth}"
    return make


VGG11 = _ctor(11)
VGG13 = _ctor(13)
VGG16 = _ctor(16)
VGG19 = _ctor(19)

register("vgg")(VGG16)  # the reference CLI name
for _d in (11, 13, 16, 19):
    register(f"vgg{_d}")(_ctor(_d))


def load_jax_vgg(params, batch_stats):
    """A JAX VGG's ``(params, batch_stats)`` as the port's
    ``state_dict`` (:func:`.init.carry_jax_variables`)."""
    return carry_jax_variables(params, batch_stats)
