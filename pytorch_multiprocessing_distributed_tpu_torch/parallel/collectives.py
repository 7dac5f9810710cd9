"""Collectives of the data-parallel step (the port of the JAX package's
``parallel/collectives.py``, the gradient ``psum`` subset, and the
``psum_scatter``/``all_gather`` pair of ``--zero``).

The train step keeps every gradient as a view of ONE flat f32 buffer
(:class:`..train.state.TrainState`), so the ``lax.psum`` over the
gradient tree becomes one ``all_reduce`` of that buffer: NCCL on the
card, gloo on the CPU, no call per leaf. Under ``--zero``
(:mod:`.zero`) a bucket of that buffer is reduce-scattered and its
shards all-gathered instead.

The all-reduce is a collective boundary of the fleet monitor
(:mod:`..runtime.fleet`): an armed monitor stamps this rank's arrival
with the operand's bytes (tensor metadata), and the scope bus gets a
``collective.all_reduce`` instant (an instant, not a span: the call
only enqueues the reduction on a card), as JAX's ``all_reduce`` does.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from ..runtime import fleet as graftfleet
from ..runtime import scope as graftscope
from .dist import get_world_size


def psum_(flat: torch.Tensor) -> torch.Tensor:
    """Sum ``flat`` over the data-parallel group in place; a no-op for
    one process. Returns ``flat``."""
    if get_world_size() > 1:
        nbytes = flat.numel() * flat.element_size()
        graftfleet.note_arrival("all_reduce@data", axis="data",
                                nbytes=nbytes)
        graftscope.emit("collective.all_reduce", cat="collective",
                        axis="data", op="sum", nbytes=nbytes)
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    return flat


def reduce_scatter_(out: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """This rank's ``out.numel()`` slice of ``flat`` summed over the
    group (``lax.psum_scatter(..., tiled=True)``); ``flat`` holds
    ``world * out.numel()`` elements. One process copies its slice.
    Returns ``out``."""
    if get_world_size() > 1:
        tdist.reduce_scatter_tensor(out, flat, op=tdist.ReduceOp.SUM)
    else:
        out.copy_(flat)
    return out


def all_gather_(out: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """Every rank's ``shard`` laid end to end in rank order into ``out``
    (``lax.all_gather(..., tiled=True)``). Returns ``out``."""
    if get_world_size() > 1:
        tdist.all_gather_into_tensor(out, shard)
    else:
        out.copy_(shard)
    return out


def all_gather_objects(obj, group=None) -> list:
    """Every rank's ``obj`` (picklable), indexed by group rank (host
    control plane: the ring's CUDA IPC handles)."""
    out = [None] * tdist.get_world_size(group)
    tdist.all_gather_object(out, obj, group=group)
    return out


def broadcast_int(value: int, src: int = 0) -> int:
    """``value`` as ``src`` holds it, on every rank (host control plane:
    ``--resume auto`` agrees on the primary's epoch)."""
    if get_world_size() == 1:
        return int(value)
    box = [int(value)]
    tdist.broadcast_object_list(box, src=src)
    return int(box[0])
