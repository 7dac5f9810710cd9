"""The reference's ``state_dict`` artifact for the ResNet family (the
port of the JAX package's ``utils/torch_interop.py``, export side, and
its reader for the port's own models).

The reference saves ``model_{epoch}.pth`` as a torch ``state_dict`` with
the module names of its ``model/resnet.py``: ``conv1``/``bn1`` stem,
``layer{s}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``shortcut.{0,1}`` blocks,
``linear`` head, conv weights OIHW, the head ``[out, in]``. The port's
ResNet carries those names and layouts already, so its ``state_dict``
is that artifact up to one buffer the port's BatchNorm does not keep:
``num_batches_tracked``, written as 0 after each BatchNorm's
``running_var`` as the JAX export writes it. ``--torch_export`` writes
the file (:func:`save_torch_checkpoint`): an ``OrderedDict`` of CPU
tensors in the JAX export's key order, which the JAX package's
``load_torch_checkpoint`` reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Union

import torch
from torch import nn


def is_resnet_name(model_name: str) -> bool:
    """True for the ``--model`` names the export covers (the JAX CLI's
    test: ``res`` or ``resnet*``)."""
    return model_name == "res" or model_name.startswith("resnet")


def to_torch_state_dict(model: Union[nn.Module, Mapping[str, torch.Tensor]]
                        ) -> "OrderedDict[str, torch.Tensor]":
    """``model``'s params and BN running stats (or its ``state_dict``,
    as a placed state gathers it) as the reference's ``state_dict``: f32
    CPU copies (``num_batches_tracked`` an int64 0 after each
    BatchNorm's ``running_var``), in the module order."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    items = model.items() if isinstance(model, Mapping) else (
        model.state_dict().items())
    for key, value in items:
        sd[key] = value.detach().to("cpu", torch.float32, copy=True)
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.int64))
    return sd


def from_torch_state_dict(state_dict: Mapping[str, torch.Tensor]
                          ) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``state_dict`` (DDP's ``module.`` prefix allowed) as
    the port's: ``num_batches_tracked`` dropped. Load it with
    ``model.load_state_dict``, which names any key that does not fit."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if not key.endswith("num_batches_tracked"):
            out[key] = value
    return out


def save_torch_checkpoint(path: str, model: Union[
        nn.Module, Mapping[str, torch.Tensor]]) -> str:
    """Write ``model``'s reference ``state_dict`` to ``path``."""
    torch.save(to_torch_state_dict(model), path)
    return path


def load_torch_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Read a reference ``.pth`` into ``model`` (its params and BN
    running stats)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(from_torch_state_dict(sd))
    return model
