"""Serving params: random init, weights carried from JAX (a dense tree,
or one stage of JAX's stacked pipeline tree), ``.npz`` files, and the
port's own training checkpoints (:func:`load_params`).

Params are a flat ``{name: tensor}`` dict keyed like the model's
``state_dict()`` (``block_0.attn.wqkv.kernel``); bind them with
``model.load_state_dict(params, assign=True)``. All three sources give
f32 tensors in the JAX package's layouts (Dense kernels ``[in, out]``).
"""

from __future__ import annotations

import io
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

Params = Dict[str, torch.Tensor]


# flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = .87962566103423978


def _lecun_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated to two deviations of
    ``sqrt(1 / fan_in)``, ``fan_in`` the second-to-last dim times every
    dim before it (flax's receptive field: ``E * D`` for ``w1 [E, D,
    H]``)."""
    fan_in = 1
    for n in shape[:-1]:
        fan_in *= n
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def init_params(model, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Fresh random params with the JAX package's initialisers: normal
    (sigma 0.02) embeddings and Dense kernels, zero biases, unit
    LayerNorm scales, and in an MoE block (``moe.*``) ``lecun_normal``
    router and expert kernels beside zero expert biases. Drawn from a
    CPU ``torch.Generator`` seeded with ``seed`` (the same values on any
    device), then moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    out: Params = {}
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "scale":
            t = torch.ones(p.shape)
        elif leaf in ("bias", "b1", "b2"):
            t = torch.zeros(p.shape)
        elif leaf in ("gate", "w1", "w2"):
            t = _lecun_normal(tuple(p.shape), gen)
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
    ``block_0.attn.wqkv.kernel``, ``block_0/moe/w1`` ->
    ``block_0.moe.w1``). Layouts are kept as they are (flax Dense
    kernels are ``[in, out]``, which is what the port's ``_dense``
    reads; the MoE leaves are JAX's ``[D, E]``, ``[E, D, H]``, ...)."""
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


def _load_npz(path: str) -> Params:
    with np.load(path) as f:
        return {key.replace("/", "."):
                torch.from_numpy(np.array(f[key], dtype=np.float32))
                for key in f.files}


def _params_subtree(payload, path: str) -> Params:
    """The ``params/`` leaves of a training payload under the port's
    names (``params/block_0/attn/wqkv/kernel`` ->
    ``block_0.attn.wqkv.kernel``)."""
    out = {key[len("params/"):].replace("/", "."): t.float()
           for key, t in payload.items() if key.startswith("params/")}
    if not out:
        raise ValueError(f"{path} has no 'params' subtree — not a "
                         "training checkpoint of the port")
    return out


def _orbax_root(path: str) -> str:
    """The ``orbax/`` directory of a run's ``save_path``, or ``path``
    itself when it holds none (``orbax/`` was passed)."""
    inner = os.path.join(path, "orbax")
    return inner if os.path.isdir(inner) else path


def load_params(model, path: str, backend: str = "auto",
                epoch: Optional[int] = None) -> Params:
    """The param dict for ``model`` from a file the port reads: the JAX
    package's ``load_params(model, path, backend, epoch)``.

    Args:
      model: the registry GPT the params are for (names and shapes are
        checked against it; a pipelined run's stacked tree is unstacked
        with its vocab).
      path: an ``.npz`` of the flattened JAX tree (keys like
        ``"block_0/attn/wqkv/kernel"``); msgpack: the port's
        ``model_<epoch>.pth`` (``train_lm --ckpt_backend msgpack``, the
        flat ``TrainState`` dict of ``torch.save`` with its
        ``.sha256`` sidecar, checked first: a mismatch raises
        :class:`..train.checkpoint.CheckpointCorruptError`; unpickled
        with ``weights_only=True``); orbax: the run's ``save_path``
        (parent of ``orbax/``) or ``orbax/`` itself, written through
        DCP by ``train_lm --ckpt_backend orbax``.
      backend: ``"auto"`` (a directory is orbax, an ``.npz`` file the
        flattened tree, another file msgpack), ``"msgpack"`` or
        ``"orbax"``.
      epoch: orbax only: the epoch to serve (default the latest
        committed one).

    Only the ``params/`` subtree is read; the optimizer state is never
    loaded. A pipelined run (``--parallel pp``) saves JAX's stacked
    tree, turned back into the dense GPT's names here
    (:func:`..parallel.gpt_pipeline.unstack_pipeline_params`). A JAX
    msgpack file (``flax.serialization`` bytes) cannot be read: the port
    has neither ``flax`` nor ``msgpack``, so the ``msgpack`` name means
    the port's own ``model_<epoch>.pth``, as in ``train_lm
    --ckpt_backend msgpack`` (ROADMAP.md, "Port: serving features still
    to port")."""
    if backend not in ("auto", "msgpack", "orbax"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        backend = "orbax" if os.path.isdir(path) else "msgpack"
    if epoch is not None and backend != "orbax":
        raise ValueError("epoch selects an orbax checkpoint's epoch; a "
                         f"{backend} file holds one")
    if backend == "orbax":
        from ..train.orbax_ckpt import OrbaxCheckpointer

        root = _orbax_root(path)
        ckpt = OrbaxCheckpointer(os.path.dirname(os.path.abspath(root)))
        if epoch is None:
            found = ckpt.committed_epochs()
            if not found:
                raise FileNotFoundError(f"no orbax checkpoint under {root}")
            epoch = found[-1]
        params = _params_subtree(ckpt.load_payload(epoch, "params/"), path)
    elif path.endswith(".npz"):
        params = _load_npz(path)
    else:
        from ..train.checkpoint import verify_checkpoint

        with open(path, "rb") as f:
            payload = f.read()
        verify_checkpoint(path, payload)
        params = _params_subtree(torch.load(
            io.BytesIO(payload), map_location="cpu", weights_only=True),
            path)
    if "head_k" in params:
        from ..parallel.gpt_pipeline import unstack_pipeline_params

        params = {k: t.contiguous() for k, t in unstack_pipeline_params(
            params, model.vocab_size).items()}
    want = {name: tuple(p.shape) for name, p in model.named_parameters()}
    got = {name: tuple(t.shape) for name, t in params.items()}
    if want != got:
        diff = sorted(set(want).symmetric_difference(got)) or sorted(
            n for n in want if want[n] != got[n])
        raise ValueError(
            f"{path} does not hold this model's params (first "
            f"differences: {diff[:4]})")
    return params
