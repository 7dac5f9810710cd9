"""ConvNeXt (the port of the JAX package's ``models/convnext.py``;
BASELINE config #5 trains ConvNeXt under LAMB).

A patchify stem (a ``patchify_stride`` conv with bias) and its
LayerNorm; four stages, each after the first opened by a LayerNorm and a
2x2 stride-2 conv; blocks of a depthwise 7x7 conv (``groups=dim``), a
channels-last LayerNorm, the 4x pointwise MLP (Dense, GELU, Dense) and
the layer-scale ``gamma`` on the residual branch; a global average pool,
a LayerNorm and an f32 head. As in flax: LayerNorm eps 1e-6 in f32, GELU
the tanh approximation, stochastic depth omitted. Activations stay NHWC
(channels-last), convs read them as NCHW views.

Module names are the flax ones (``stem``, ``stem_norm``,
``down_norm{i}``, ``down{i}``, ``stage{i}_block{j}.{dwconv,norm,pw1,pw2,
gamma}``, ``head_norm``, ``head``), so :func:`load_jax_convnext` carries
a JAX tree across (a depthwise kernel ``[7, 7, 1, dim]`` becomes
``[dim, 1, 7, 7]``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .init import carry_jax_variables
from .registry import register
from .vit import LN_EPS, dense, gelu, layer_norm


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Conv`` on NHWC ``x`` in ``x``'s dtype, NHWC out (an NCHW
    view of channels-last memory on the way)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), conv.stride, conv.padding, 1,
                 conv.groups)
    return y.permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        h = layer_norm(self.norm, conv_nhwc(self.dwconv, x)).to(x.dtype)
        h = dense(self.pw2, gelu(dense(self.pw1, h)))
        return x + h * self.gamma.to(x.dtype)


class ConvNeXt(nn.Module):
    """Input ``[batch, H, W, 3]`` NHWC, output ``[batch, num_classes]``
    f32 logits; ``dtype`` is the compute dtype."""

    layer_scale_init = 1e-6

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 10, patchify_stride: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        s = patchify_stride
        self.stem = nn.Conv2d(3, dims[0], s, stride=s)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LN_EPS)
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i > 0:
                self.add_module(f"down_norm{i}",
                                nn.LayerNorm(dims[i - 1], eps=LN_EPS))
                self.add_module(f"down{i}",
                                nn.Conv2d(dims[i - 1], dim, 2, stride=2))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}",
                                ConvNeXtBlock(dim, self.layer_scale_init))
        self.head_norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(self.stem, x.to(self.dtype))
        x = layer_norm(self.stem_norm, x).to(self.dtype)
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = layer_norm(getattr(self, f"down_norm{i}"), x)
                x = conv_nhwc(getattr(self, f"down{i}"), x.to(self.dtype))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        x = layer_norm(self.head_norm, x.mean(dim=(1, 2)))
        return F.linear(x, self.head.weight, self.head.bias)


def ConvNeXt_T(**kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768), **kw)


def ConvNeXt_S(**kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 27, 3), (96, 192, 384, 768), **kw)


def ConvNeXt_B(**kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 27, 3), (128, 256, 512, 1024), **kw)


def ConvNeXt_L(**kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 27, 3), (192, 384, 768, 1536), **kw)


register("convnext_t")(ConvNeXt_T)
register("convnext_s")(ConvNeXt_S)
register("convnext_b")(ConvNeXt_B)
register("convnext_l")(ConvNeXt_L)


def load_jax_convnext(params, batch_stats=None):
    """A JAX ConvNeXt's ``params`` as the port's ``state_dict``
    (:func:`.init.carry_jax_variables`)."""
    return carry_jax_variables(params, batch_stats)
