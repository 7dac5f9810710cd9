"""Tensor-parallel decode: a rank's shard of a GPT and the gathers that
join its columns (the port of the JAX package's
``inference/generate.py`` ``shard_params_for_tp_decode`` and
``_make_cs``).

JAX places every leaf by ``tp_param_spec`` (the trailing dim over the
``model`` axis when it divides, else replicated) and lets GSPMD insert
the collectives. The port has no GSPMD, so a rank of a ``(1, M)`` grid
(:func:`..parallel.mesh.make_grid`) holds its share as plain tensors and
the decode helpers (:mod:`.generate`, :mod:`..models.gpt`) gather where
the next op needs every channel:

- **The weights.** Every leaf JAX shards holds the same ``1/M`` bytes
  here. ``wo``, ``fc1``, ``fc2``, the embeddings and the MoE leaves
  (``gate``, ``w1``/``b1``, ``w2``/``b2``) hold JAX's trailing-dim
  slice. ``wqkv`` is the exception: ``[D, 3D]`` lays q, k and v side by
  side, so JAX's contiguous slice would give rank 0 of 2 all of q and
  half of k. A rank here holds the q, k and v columns of its own
  ``H/M`` heads (``[r D/M, (r+1) D/M)`` inside each third): the same
  bytes, other columns. The LayerNorm scales and biases
  (:data:`SMALL_LEAVES`) are held whole (JAX splits them; they are
  counted apart in :attr:`TPShard.resident_bytes`). The head ``[D, V]``
  is whole on every registered model, as in JAX: no M > 1 divides
  50257 or 257.
- **The compute.** Column-parallel with all-gathers and no cross-rank
  sum: each Dense computes the output columns its rank holds and
  :meth:`TPShard.gather` joins them in rank order where the next op
  needs every channel (the embedding sum, attention's output before
  ``wo``, ``wo``'s output before the residual, ``fc1``'s after the
  GELU, ``fc2``'s): one GEMM over the full K makes each output element
  on one rank, so the tokens are the single-shard ones. Attention runs
  on the rank's heads against its head shard of the KV caches.
- **The rest is replicated**: the hiddens, the f32 logits (a whole head
  gives every rank the same logits, and one seeded generator the same
  draw), the engine's host state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as tdist
from torch import nn

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Grid
from ..train.placement import tp_param_spec

__all__ = ["TPShard", "SMALL_LEAVES", "check_mesh", "local_heads",
           "shard_params_for_tp_decode"]

# the leaves a rank holds whole though JAX splits them (LayerNorm scales
# and biases: D floats each, 0.1% of gpt_small's bytes)
SMALL_LEAVES = ("ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias",
                "ln_final.scale", "ln_final.bias")


class TPShard:
    """One rank's place on the ``model`` axis: ``size`` ranks, this one
    at ``index``, the axis's process ``group`` (None: the whole group).
    ``gathers`` counts the all-gathers this rank launched (the decode
    step's collectives); ``resident_bytes`` is filled by
    :func:`shard_params_for_tp_decode`."""

    def __init__(self, size: int, index: int, group=None):
        self.size = int(size)
        self.index = int(index)
        self.group = group
        self.gathers = 0
        self.resident_bytes: Dict[str, object] = {}

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined along the LAST dim in rank order
        (one ``all_gather_into_tensor``: NCCL on the cards, gloo on the
        CPU)."""
        self.gathers += 1
        t = t.contiguous()
        # ranks end to end on dim 0 (the layout gloo and NCCL both take)
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        tdist.all_gather_into_tensor(out, t, group=self.group)
        return out.view(self.size, *t.shape).movedim(0, -2).reshape(
            *t.shape[:-1], self.size * t.shape[-1])


def check_mesh(mesh: Grid, num_heads: int, what: str) -> None:
    """JAX's checks of a TP mesh, in its words (``what``: "TP decode"
    for ``generate``, "TP serving" for the engine): a ``model`` axis
    whose size divides the heads. The port's grid for TP is ``(1, M)``:
    JAX's data axis holds copies of the same computation and no state
    of its own, so the port does not run it."""
    names = (DATA_AXIS, mesh.axis)
    if mesh.axis != MODEL_AXIS:
        raise ValueError(
            f"{what} needs a 'model' mesh axis, got {names}")
    if num_heads % mesh.model:
        raise ValueError(
            f"num_heads={num_heads} not divisible by the model axis size "
            f"{mesh.model}")
    if mesh.data != 1:
        raise ValueError(
            f"{what} runs on a (1, M) grid (every rank on the model "
            f"axis), got data={mesh.data}: JAX's data axis only copies "
            "the computation, and the port does not")


def local_heads(model) -> int:
    """Attention heads this rank computes: ``H / M`` on a shard, all of
    them otherwise."""
    tp = getattr(model, "tp", None)
    return model.num_heads // (tp.size if tp is not None else 1)


def _qkv_columns(d: int, m: int, r: int) -> torch.Tensor:
    """``wqkv``'s columns of rank ``r``'s heads: ``[r w, (r+1) w)`` of
    q, of k and of v (``w = D / M``)."""
    w = d // m
    return torch.cat([torch.arange(j * d + r * w, j * d + (r + 1) * w)
                      for j in range(3)])


def _small(name: str) -> bool:
    return name.endswith(SMALL_LEAVES)


def _shard_leaf(name: str, t: torch.Tensor, d: int, m: int, r: int
                ) -> Tuple[torch.Tensor, int]:
    """Rank ``r``'s tensor of leaf ``name`` and JAX's bytes a device of
    it (``tp_param_spec``'s share)."""
    split = MODEL_AXIS in tp_param_spec(t.shape, m)
    jax_bytes = t.numel() * t.element_size() // (m if split else 1)
    if not split or _small(name):
        return t, jax_bytes
    if name.endswith("attn.wqkv.kernel") or name.endswith("attn.wqkv.bias"):
        cols = _qkv_columns(d, m, r).to(t.device)
        return t.index_select(-1, cols).contiguous(), jax_bytes
    n = t.shape[-1] // m
    return t[..., r * n:(r + 1) * n].contiguous(), jax_bytes


def shard_params_for_tp_decode(model, grid: Grid):
    """This rank's shard of a bound (whole) GPT on the ``(1, M)`` grid
    ``grid``: a GPT of the same geometry whose leaves are this rank's
    tensors (see the module docstring), with ``tp`` set to its
    :class:`TPShard`. A model already sharded for this place is
    returned as it is (JAX's ``device_put`` of placed params).

    The shard's ``tp.resident_bytes``: ``params`` (bytes this rank
    holds), ``jax_params`` (JAX's per-device bytes under
    ``tp_param_spec``), ``small_leaves`` (each of :data:`SMALL_LEAVES`'s
    leaves held whole, and its bytes) and ``small_jax`` (JAX's bytes of
    them): ``params - sum(small_leaves) == jax_params - small_jax``."""
    check_mesh(grid, model.num_heads, "TP decode")
    m, r = grid.model, grid.model_index
    done: Optional[TPShard] = getattr(model, "tp", None)
    if done is not None:
        if (done.size, done.index) != (m, r):
            raise ValueError(
                f"model is already rank {done.index}'s shard of a model "
                f"axis of {done.size}, not rank {r} of {m}")
        return model
    if model.device.type == "meta":
        raise ValueError(
            "model has no params: bind them first with "
            "model.load_state_dict(params, assign=True)")
    shard = model.clone()
    held = jax_total = small_jax = 0
    small: Dict[str, int] = {}
    for name, t in model.state_dict().items():
        local, jax_bytes = _shard_leaf(name, t, model.hidden_size, m, r)
        mod_name, _, leaf = name.rpartition(".")
        setattr(shard.get_submodule(mod_name) if mod_name else shard, leaf,
                nn.Parameter(local, requires_grad=False))
        nbytes = local.numel() * local.element_size()
        held += nbytes
        jax_total += jax_bytes
        if _small(name) and m > 1:
            small[name] = nbytes
            small_jax += jax_bytes
    shard.tp = TPShard(m, r, grid.model_group)
    shard.tp.resident_bytes = {"params": held, "jax_params": jax_total,
                               "small_leaves": small,
                               "small_jax": small_jax}
    return shard
