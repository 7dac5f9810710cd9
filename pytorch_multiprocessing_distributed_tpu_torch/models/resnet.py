"""ResNet family (the port of the JAX package's ``models/resnet.py``).

Architecture as in JAX (and the reference ``model/resnet.py``): a stem,
four stages of 64/128/256/512 channels (stride 2 from stage 2, a 1x1
conv + BN shortcut where the shape changes), ``BasicBlock`` (expansion
1) or ``Bottleneck`` (expansion 4) with a post-add ReLU, a pool and a
linear head. ``stem="cifar"`` (the default, the reference's): a 3x3
stride-1 64-channel conv with no max-pool, and a window-4 average pool
(global at 32x32). ``stem="imagenet"`` (the torchvision stem): a 7x7
stride-2 conv (padding 3), BN, ReLU and a 3x3 stride-2 max-pool (padding
1), and a global average pool (any input size).
``ResNet18`` keeps the reference's non-standard ``[1, 1, 1, 1]`` blocks
(4,903,242 parameters); 34/50/101/152 use the standard counts. Every
BatchNorm is a :class:`..ops.batch_norm.SyncBatchNorm`.

Modules carry the reference's torch names (``conv1``/``bn1`` stem,
``layer{s}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``shortcut.{0,1}``,
``linear``) and torch layouts (conv weights OIHW, linear ``[out, in]``),
so ``state_dict()`` is the reference's artifact of record;
:func:`load_jax_resnet` carries a JAX tree across. The input keeps the
JAX package's NHWC layout: the model reads it as an NCHW view in
channels-last memory (no copy), the format cuDNN prefers. ``dtype`` is
the compute dtype of the convolutions and the head; parameters, BN
statistics and the logits stay f32.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Sequence, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import SyncBatchNorm
from .init import init_model
from .registry import register


class Conv2d(nn.Conv2d):
    """Bias-free square conv with ``k // 2`` padding that computes in
    its input's dtype (the weight is cast, as flax casts its f32 params
    to the module's dtype)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


def ConvBN(cin: int, cout: int, k: int, stride: int,
           dtype: torch.dtype) -> nn.Sequential:
    """Conv (no bias) then sync BN — the JAX ``ConvBN``; as a projection
    shortcut its children are the reference's ``shortcut.0``/``.1``."""
    return nn.Sequential(Conv2d(cin, cout, k, stride),
                         SyncBatchNorm(cout, dtype=dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convs with an identity or projection shortcut."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 3, stride)
        self.bn1 = SyncBatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1)
        self.bn2 = SyncBatchNorm(planes, dtype=dtype)
        self.shortcut = (ConvBN(cin, out, 1, stride, dtype)
                         if stride != 1 or cin != out else nn.Sequential())

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, expansion 4."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, 1)
        self.bn1 = SyncBatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride)
        self.bn2 = SyncBatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, out, 1, 1)
        self.bn3 = SyncBatchNorm(out, dtype=dtype)
        self.shortcut = (ConvBN(cin, out, 1, stride, dtype)
                         if stride != 1 or cin != out else nn.Sequential())

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))


STEMS = ("cifar", "imagenet")


class ResNet(nn.Module):
    """ResNet with a selectable stem: input ``[batch, H, W, 3]`` NHWC
    (32x32 for the CIFAR stem), output ``[batch, num_classes]`` f32
    logits."""

    conv_init = "he_fan_out"  # the JAX conv_kernel_init

    def __init__(self, block: Type[nn.Module], num_blocks: Sequence[int],
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 stem: str = "cifar"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem must be one of {STEMS}, got {stem!r}")
        self.dtype = dtype
        self.stem = stem
        self.conv1 = (Conv2d(3, 64, 7, 2) if stem == "imagenet"
                      else Conv2d(3, 64, 3, 1))
        self.bn1 = SyncBatchNorm(64, dtype=dtype)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                num_blocks)):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(cin, planes, stride, dtype))
                cin = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.linear = nn.Linear(cin, num_classes)

    @staticmethod
    def jax_param_path(name: str, shape=None) -> Tuple[str, ...]:
        """The flax path of the parameter ``name`` (the inverse of
        :func:`load_jax_resnet`'s naming): ``conv1``/``bn1`` are the
        ``stem``, ``layer{s}.{i}.conv{k}``/``bn{k}`` are ``layer{s}_{i}``'s
        ``cb{k}``, ``shortcut.0``/``.1`` its ``shortcut``, ``linear`` the
        head."""
        parts = name.split(".")
        leaf = parts[-1]
        if parts[0] == "linear":
            return ("linear", "kernel" if leaf == "weight" else leaf)
        if parts[0].startswith("layer"):
            owner = (f"{parts[0]}_{parts[1]}",)
            mod = parts[2:-1]
        else:
            owner, mod = ("stem",), parts[:-1]
        if mod[0] == "shortcut":
            cb, kind = "shortcut", ("conv", "bn")[int(mod[1])]
        else:
            cb, kind = "cb" + mod[0][-1], mod[0][:-1]
        if kind == "conv":
            return owner + (() if owner == ("stem",) else (cb,)) + (
                "conv", "kernel")
        return owner + (() if owner == ("stem",) else (cb,)) + (
            "bn", "scale" if leaf == "weight" else leaf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels-last memory (no copy)
        out = x.to(self.dtype).permute(0, 3, 1, 2)
        out = F.relu(self.bn1(self.conv1(out)))
        if self.stem == "imagenet":
            out = F.max_pool2d(out, 3, stride=2, padding=1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            out = stage(out)
        if self.stem == "imagenet":
            out = out.mean(dim=(2, 3))  # global average pool
        else:
            # the reference's window-4 pool (global for the 32x32 stem)
            out = F.avg_pool2d(out, 4).flatten(1)
        w = self.linear.weight.to(self.dtype)
        b = self.linear.bias.to(self.dtype)
        return F.linear(out, w, b).float()


def ResNet18(**kw) -> ResNet:
    """The reference's non-standard ``[1, 1, 1, 1]`` ResNet-18."""
    return ResNet(BasicBlock, (1, 1, 1, 1), **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)


# the reference CLI's name 'res' is ResNet-18
for _name, _ctor in (("res", ResNet18), ("resnet18", ResNet18),
                     ("resnet34", ResNet34), ("resnet50", ResNet50),
                     ("resnet101", ResNet101), ("resnet152", ResNet152)):
    register(_name)(_ctor)


def init_resnet(model: ResNet, seed: int = 0) -> ResNet:
    """Fresh weights with the JAX package's initialisers, drawn from a
    CPU ``torch.Generator`` seeded with ``seed`` (the same values on any
    device): convs He-normal over fan-out, the head LeCun truncated
    normal (|z| <= 2) with a zero bias, BN scale 1 and bias 0, running
    mean 0 and variance 1 (:func:`.init.init_model`)."""
    return init_model(model, seed)


# flax ConvBN child -> (torch conv, torch bn) inside a block (the JAX
# package's utils/torch_interop mapping)
_CB_TO_TORCH = {"cb1": ("conv1", "bn1"), "cb2": ("conv2", "bn2"),
                "cb3": ("conv3", "bn3"),
                "shortcut": ("shortcut.0", "shortcut.1")}


def _convbn_paths(params: Mapping) -> Tuple[Tuple[Tuple[str, ...], str,
                                                  str], ...]:
    """``((flax path), torch conv name, torch bn name)`` in the torch
    module's order: the stem, then blocks by (stage, index)."""
    out = [(("stem",), "conv1", "bn1")]
    blocks = []
    for name in params:
        if name.startswith("layer") and "_" in name:
            stage, idx = name[len("layer"):].split("_")
            blocks.append((int(stage), int(idx), name))
    for stage, idx, name in sorted(blocks):
        for cb in ("cb1", "cb2", "cb3", "shortcut"):
            if cb in params[name]:
                conv, bn = _CB_TO_TORCH[cb]
                out.append(((name, cb), f"layer{stage}.{idx}.{conv}",
                            f"layer{stage}.{idx}.{bn}"))
    return tuple(out)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def load_jax_resnet(params: Mapping, batch_stats: Mapping
                    ) -> "OrderedDict[str, torch.Tensor]":
    """A JAX ResNet's ``(params, batch_stats)`` trees (numpy leaves, or
    anything ``np.asarray`` reads) as the port's ``state_dict``: conv
    kernels HWIO -> OIHW, the Dense kernel ``[in, out]`` -> ``[out,
    in]``, BN ``scale``/``bias`` -> ``weight``/``bias`` and the running
    ``mean``/``var`` carried, all f32 CPU tensors. Load it with
    ``model.load_state_dict(sd)``."""
    def f32(x):
        return np.asarray(x, dtype=np.float32)

    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for path, conv, bn in _convbn_paths(params):
        node, stats = _get(params, path), _get(batch_stats, path)
        sd[f"{conv}.weight"] = np.transpose(f32(node["conv"]["kernel"]),
                                            (3, 2, 0, 1))
        sd[f"{bn}.weight"] = f32(node["bn"]["scale"])
        sd[f"{bn}.bias"] = f32(node["bn"]["bias"])
        sd[f"{bn}.running_mean"] = f32(stats["bn"]["mean"])
        sd[f"{bn}.running_var"] = f32(stats["bn"]["var"])
    sd["linear.weight"] = np.transpose(f32(params["linear"]["kernel"]),
                                       (1, 0))
    sd["linear.bias"] = f32(params["linear"]["bias"])
    return OrderedDict((k, torch.from_numpy(np.array(v)))  # own copies
                       for k, v in sd.items())

