"""Serving params: random init, weights carried from JAX (a dense tree,
or one stage of JAX's stacked pipeline tree), ``.npz`` files.

Params are a flat ``{name: tensor}`` dict keyed like the model's
``state_dict()`` (``block_0.attn.wqkv.kernel``); bind them with
``model.load_state_dict(params, assign=True)``. All three sources give
f32 tensors in the JAX package's layouts (Dense kernels ``[in, out]``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ..device import resolve_device

Params = Dict[str, torch.Tensor]


def init_params(model, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Fresh random params with the JAX package's initialisers: normal
    (sigma 0.02) embeddings and Dense kernels, zero biases, unit
    LayerNorm scales. Drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same values on any device), then moved to
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    out: Params = {}
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            t = torch.ones(p.shape)
        elif name.endswith(".bias"):
            t = torch.zeros(p.shape)
        else:
            t = torch.empty(p.shape).normal_(0.0, 0.02, generator=gen)
        out[name] = t.to(dev)
    return out


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def from_jax_params(tree) -> Params:
    """Carry a JAX param tree across: a nested mapping of array leaves
    (numpy, or anything ``np.asarray`` reads) -> CPU f32 tensors under
    the port's names (``block_0/attn/wqkv/kernel`` ->
    ``block_0.attn.wqkv.kernel``). Layouts are kept as they are (flax
    Dense kernels are ``[in, out]``, which is what the port's ``_dense``
    reads)."""
    return {path.replace("/", "."):
            torch.from_numpy(np.array(leaf, dtype=np.float32))
            for path, leaf in _flatten(tree)}


def from_jax_pipeline_params(tree, stage: int) -> Params:
    """Carry JAX's stacked pipeline tree (``stack_pipeline_params``'s
    output: ``embed`` ``[N, Vs, D]``, ``blocks/...`` ``[N, L/N, ...]``,
    ...) across as stage ``stage``'s params, under the names of its
    :func:`..parallel.gpt_pipeline.stage_model`. Back to a whole GPT:
    :func:`..parallel.gpt_pipeline.unstack_pipeline_params` of
    ``from_jax_params(tree)``."""
    from ..parallel.gpt_pipeline import stage_params

    return stage_params(from_jax_params(tree), stage)


def load_params(path: str) -> Params:
    """Params from an ``.npz`` of the flattened JAX tree (keys like
    ``"block_0/attn/wqkv/kernel"``) — the port's counterpart of the JAX
    CLI's ``--ckpt``. Write one with ``np.savez(path, **{"/".join(k):
    v ...})`` over the JAX tree's leaves."""
    with np.load(path) as f:
        return {key.replace("/", "."):
                torch.from_numpy(np.array(f[key], dtype=np.float32))
                for key in f.files}
