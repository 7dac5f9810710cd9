"""Fresh weights and carried JAX weights for the image zoo.

:func:`init_model` draws every family's weights from the distributions
of the flax initialisers the JAX package uses, from a CPU
``torch.Generator`` seeded with ``seed`` (the same values on any
device):

- ``Conv``/``Dense`` kernels: flax's default ``lecun_normal`` (a normal
  truncated at two standard deviations, fan-in) and zero biases; the
  families built on ``conv_kernel_init`` (ResNet, VGG, DenseNet; JAX
  ``models/resnet.py:40-41``) draw their convolutions He-normal over the
  fan-out instead;
- LayerNorm and BatchNorm scale 1 and bias 0, running mean 0 and
  variance 1;
- ViT's class token 0 and ``pos_embed`` ``normal(0.02)``; ConvNeXt's
  layer scale ``gamma`` 1e-6.

:func:`carry_jax_variables` turns a flax ``(params, batch_stats)`` tree
of the zoo (VGG, DenseNet, ViT, ConvNeXt, whose port modules carry the
flax module names) into the port's ``state_dict``: conv kernels HWIO ->
OIHW (a depthwise ``[7, 7, 1, dim]`` becomes ``[dim, 1, 7, 7]``),
Dense kernels ``[in, out]`` -> ``[out, in]``, norm ``scale`` ->
``weight``, BN ``mean``/``var`` -> ``running_mean``/``running_var``,
other leaves (``cls``, ``pos_embed``, ``gamma``) as they are.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.batch_norm import SyncBatchNorm

# flax lecun_normal: a truncated normal, its std corrected for the cut at
# two standard deviations
_TRUNC_STD = .87962566103423978


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    w.copy_(t)


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights for any image model of the port (see the module
    note), drawn module by module in the model's order."""
    gen = torch.Generator().manual_seed(int(seed))
    he = getattr(model, "conv_init", "lecun") == "he_fan_out"
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            o, i, kh, kw = module.weight.shape
            if he:
                std = math.sqrt(2.0 / (o * kh * kw))
                module.weight.copy_(torch.empty(module.weight.shape).normal_(
                    0.0, std, generator=gen))
            else:
                _lecun_(module.weight, i * kh * kw, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Linear):
            _lecun_(module.weight, module.in_features, gen)
            module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, SyncBatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, SyncBatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "cls":
            p.zero_()
        elif leaf == "pos_embed":
            p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=gen))
        elif leaf == "gamma":
            p.fill_(getattr(model, "layer_scale_init", 1e-6))
    return model


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def jax_param_path(name: str, shape) -> Tuple[str, ...]:
    """The flax path of the port parameter ``name`` of ``shape`` in a
    zoo model that carries the flax module names (the inverse of
    :func:`carry_jax_variables`): a ``weight`` is a conv or Dense
    ``kernel`` (2-D and up) or a norm's ``scale`` (1-D)."""
    *owner, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if len(shape) >= 2 else "scale"
    return tuple(owner) + (leaf,)


def carry_jax_variables(params: Mapping, batch_stats: Mapping = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``(params, batch_stats)`` tree (numpy leaves, or anything
    ``np.asarray`` reads) of a zoo model as the port's ``state_dict``
    (see the module note), all f32 CPU tensors. Load it with
    ``model.load_state_dict(sd)``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(path, name, value):
        key = ".".join(path + (name,))
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    for path, leaf in _leaves(params):
        *owner, name = path
        owner = tuple(owner)
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel" and a.ndim == 4:  # conv: HWIO -> OIHW
            put(owner, "weight", np.transpose(a, (3, 2, 0, 1)))
        elif name == "kernel":  # Dense: [in, out] -> [out, in]
            put(owner, "weight", a.T)
        elif name == "scale":
            put(owner, "weight", a)
        else:
            put(owner, name, a)
    for path, leaf in _leaves(batch_stats or {}):
        *owner, name = path
        put(tuple(owner), {"mean": "running_mean",
                           "var": "running_var"}[name], leaf)
    return sd
