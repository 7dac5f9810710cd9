"""graftzero: the cross-replica sharded weight update (the port of the
JAX package's ``parallel/zero.py``; arXiv:2004.13336).

The replicated data-parallel step all-reduces the gradients and runs the
whole optimizer update on every rank. Under ``--zero`` that becomes

    reduce-scatter(grads) -> sharded optimizer update -> all-gather

so each rank stores and updates ``1/N`` of every moment buffer, and the
two collectives move the bytes of the one all-reduce.

The port holds params and grads as flat f32 buffers
(:class:`..train.state.TrainState`), so a bucket is a range of that
buffer: :func:`plan_buckets` lays the parameters out in the JAX tree's
leaf order (``jax.tree.leaves`` of the flax tree: keys sorted at every
level), cuts that order into buckets of at most ``bucket_bytes`` (a leaf
is never split; an oversized leaf gets a bucket of its own) and pads
each bucket to a multiple of the world size. A state bound to the plan
(``TrainState.bind(offsets=plan.offsets(), size=plan.size)``) then holds
bucket ``b`` at ``[start, start + padded)`` of its params and grads,
zeros in the pad, and a bucket's reduce-scatter reads that range in
place: JAX's buckets, leaves and padded sizes, leaf by leaf and byte by
byte.

The update runs in the optimizers' two phases (``direction_`` and
``finish_``, :mod:`..train.optim` and :mod:`..train.lamb`): the
elementwise direction on this rank's shard, an all-gather of the
direction, then the LR (and LAMB's per-leaf trust ratio) on full leaves,
the replicated update's own ops on the same values: bit-identical to it.
Params stay replicated (ZeRO-1). The momenta (LAMB's ``mu`` and ``nu``)
are per-bucket shards ``[shard]`` laid end to end, allocated by
:func:`zeroify_state` from the replicated buffers a fresh init or a
resumed checkpoint fills, and gathered back by :func:`gather_opt_state`
when a checkpoint is written, so checkpoints keep the replicated format.

Collectives are ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
(:mod:`.collectives`): NCCL on the cards, gloo on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..runtime import fleet as graftfleet
from ..runtime import scope as graftscope
from .collectives import all_gather_, reduce_scatter_

# the JAX package's bucket granularity
DEFAULT_BUCKET_MB = 32.0
_ITEMSIZE = 4  # the port's params are f32: one dtype group


@dataclass(frozen=True)
class Bucket:
    """One bucket: its leaves (port parameter names, in JAX tree order),
    where each starts inside the bucket, the pad and shard geometry over
    the plan's ``num_shards``, and where the bucket starts in the flat
    buffer (``start``) and in the flat shard buffer (``shard_start``)."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    padded: int
    shard: int
    start: int
    shard_start: int


@dataclass(frozen=True)
class ZeroPlan:
    """The static bucket layout of one (model, num_shards) pair."""

    num_shards: int
    buckets: Tuple[Bucket, ...]

    @property
    def size(self) -> int:
        """Length of the flat buffer the plan lays out (pads included)."""
        return sum(b.padded for b in self.buckets)

    @property
    def padded_bytes(self) -> int:
        """The reduce-scatter operand bytes a step."""
        return self.size * _ITEMSIZE

    @property
    def shard_bytes(self) -> int:
        """One moment buffer's bytes a rank, and the all-gather operand
        bytes a step."""
        return sum(b.shard for b in self.buckets) * _ITEMSIZE

    def offsets(self) -> Dict[str, int]:
        """``{parameter name: its first element in the flat buffer}``."""
        return {name: b.start + off for b in self.buckets
                for name, off in zip(b.names, b.offsets)}


def jax_leaf_order(model) -> List[Tuple[str, torch.Size]]:
    """``[(parameter name, shape)]`` of ``model`` in the JAX tree's leaf
    order: sorted by the flax path (``model.jax_param_path`` where the
    model names its parameters the torch way, as ResNet does; else the
    generic carry rule of :func:`..models.init.jax_param_path`)."""
    from ..models.init import jax_param_path

    path_of = getattr(model, "jax_param_path", jax_param_path)
    named = [(name, p.shape) for name, p in model.named_parameters()]
    return sorted(named, key=lambda ns: path_of(ns[0], ns[1]))


def plan_buckets(model, num_shards: int, *,
                 bucket_bytes: Optional[int] = None) -> ZeroPlan:
    """Lay ``model``'s parameters into flat buckets (see the module
    note): JAX tree order, a new bucket once the current one would pass
    ``bucket_bytes`` (default ``DEFAULT_BUCKET_MB`` MiB), each padded to
    a multiple of ``num_shards``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if bucket_bytes is None:
        bucket_bytes = int(DEFAULT_BUCKET_MB * 2 ** 20)
    leaves = jax_leaf_order(model)
    if not leaves:
        raise ValueError("plan_buckets: the model has no parameters")
    groups: List[List[Tuple[str, int]]] = []
    cur: List[Tuple[str, int]] = []
    cur_bytes = 0
    for name, shape in leaves:
        n = int(math.prod(shape))
        if cur and cur_bytes + n * _ITEMSIZE > bucket_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append((name, n))
        cur_bytes += n * _ITEMSIZE
    groups.append(cur)
    buckets, start, shard_start = [], 0, 0
    for group in groups:
        sizes = tuple(n for _, n in group)
        offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
        total = sum(sizes)
        padded = -(-total // num_shards) * num_shards
        shard = padded // num_shards
        buckets.append(Bucket(
            names=tuple(name for name, _ in group),
            sizes=sizes, offsets=offsets, total=total, padded=padded,
            shard=shard, start=start, shard_start=shard_start))
        start += padded
        shard_start += shard
    return ZeroPlan(num_shards=num_shards, buckets=tuple(buckets))


def static_comm_bytes(plan: ZeroPlan) -> Dict[str, int]:
    """A step's collective operand bytes, as the JAX package counts
    them: the reduce-scatter reads the padded buckets, the all-gather
    sends the shards."""
    return {"reduce_scatter": plan.padded_bytes,
            "all_gather": plan.shard_bytes}


def _bucket(flat: torch.Tensor, b: Bucket) -> torch.Tensor:
    return flat[b.start:b.start + b.padded]


def _shard(flat_shards: torch.Tensor, b: Bucket) -> torch.Tensor:
    return flat_shards[b.shard_start:b.shard_start + b.shard]


def reduce_scatter_grads(grads: torch.Tensor, plan: ZeroPlan,
                         out: torch.Tensor) -> torch.Tensor:
    """Each bucket of the flat ``grads`` (laid out by ``plan``) reduce-
    scattered over the group, bucket by bucket in order, into this
    rank's ``[shard]`` slices of the flat shard buffer ``out``: the sum
    over ranks (the step scales each rank's loss by ``1 / world``, so
    the sum is JAX's mean). Returns ``out``.

    Armed, the step's exchange is a ``train.grad_comm`` event and a
    fleet arrival with the plan's static bytes (JAX's zero step);
    disarmed, two global reads."""
    if (graftscope.active_scope() is not None
            or graftfleet.active_fleet() is not None):
        comm = static_comm_bytes(plan)
        nbytes = comm["reduce_scatter"] + comm["all_gather"]
        graftscope.emit("train.grad_comm", cat="train", nbytes=nbytes,
                        buckets=len(plan.buckets), axis="data",
                        bucket_bytes=[b.padded * grads.element_size()
                                      for b in plan.buckets])
        graftfleet.note_arrival("train.grad_comm", axis="data",
                                nbytes=nbytes)
    for b in plan.buckets:
        reduce_scatter_(_shard(out, b), _bucket(grads, b))
    return out


def all_gather_buckets(shards: torch.Tensor, plan: ZeroPlan,
                       out: torch.Tensor) -> torch.Tensor:
    """The inverse: every rank's ``[shard]`` slice of each bucket
    gathered into the bucket's range of the flat ``out``
    (``[plan.size]``). Returns ``out``."""
    for b in plan.buckets:
        all_gather_(_bucket(out, b), _shard(shards, b))
    return out


def shard_params(params: torch.Tensor, plan: ZeroPlan,
                 rank: int) -> torch.Tensor:
    """This rank's ``[shard]`` slice of each bucket of the flat
    ``params``, laid end to end (a local copy, no collective)."""
    return torch.cat([_bucket(params, b)[rank * b.shard:(rank + 1)
                                         * b.shard]
                      for b in plan.buckets])


def finite_shards(shards: torch.Tensor) -> torch.Tensor:
    """1.0 where this rank's reduced gradient shards hold a non-finite
    value, else 0.0 (f32 scalar): summed over ranks it is 0 exactly when
    every rank's shards are finite (the JAX ``finite_shards`` before its
    scalar psum; the step folds that psum into its metric all-reduce)."""
    return (~torch.isfinite(shards).all()).float()


def clip_shards_by_global_norm(shards: torch.Tensor, sq_sum: torch.Tensor,
                               max_norm: float) -> torch.Tensor:
    """Global-norm clipping on the scattered shards, in place: ``sq_sum``
    is the sum over ranks of each rank's ``sum(shards ** 2)``, the whole
    gradient's squared norm. Returns ``shards``."""
    gnorm = torch.sqrt(sq_sum)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return shards.mul_(scale)


def zeroify_state(state, plan: ZeroPlan, rank: int) -> None:
    """Shard ``state``'s moments in place: the replicated momentum (and
    LAMB's ``nu``), laid out by ``plan``, become this rank's ``[shard]``
    slices of each bucket, end to end; the state then holds
    the plan. Values carry over exactly, so a resumed state round-trips.
    """
    if state.zero is not None:
        raise ValueError("state is already zero-sharded")
    if state.n != plan.size:
        raise ValueError(
            f"state holds {state.n} elements, the plan lays out "
            f"{plan.size}: bind the state with the plan's offsets")
    state.momentum = shard_params(state.momentum, plan, rank)
    if state.nu is not None:
        state.nu = shard_params(state.nu, plan, rank)
    state.zero = plan
    state.grad_shards = torch.zeros_like(state.momentum)


def gather_opt_state(state) -> Dict[str, torch.Tensor]:
    """The replicated moments of a zero-sharded ``state``: ``{"momentum":
    [n]}`` (and ``"nu"``), each gathered from every rank's shards. A
    collective: every rank calls it (the gather-on-save of
    :func:`..train.checkpoint.save_checkpoint`)."""
    out = {"momentum": all_gather_buckets(
        state.momentum, state.zero, torch.zeros_like(state.params))}
    if state.nu is not None:
        out["nu"] = all_gather_buckets(state.nu, state.zero,
                                       torch.zeros_like(state.params))
    return out


def opt_state_bytes(state) -> int:
    """Bytes of ``state``'s optimizer moments held on this rank."""
    return sum(t.numel() * t.element_size()
               for t in (state.momentum, state.nu) if t is not None)


@torch.no_grad()
def apply_sharded_update(optimizer, state, grad_shards: torch.Tensor,
                         keep: torch.Tensor, rank: int) -> None:
    """The ZeRO-1 update of a zero-sharded ``state`` in place: the
    optimizer's elementwise phase on this rank's shards
    (``direction_``; it writes the moment shards where ``keep``), the
    direction all-gathered, then its finish phase on the full buffer
    (``finish_``: the LR, LAMB's trust ratios; params, count and
    ``initialized`` where ``keep``)."""
    if getattr(optimizer, "fused", False):
        raise ValueError(
            "zero mode shards the update through the optimizer's "
            "direction_/finish_ phases; the fused whole-update kernel "
            "cannot run on shards — use the unfused optimizer")
    plan = state.zero
    p_shards = shard_params(state.params, plan, rank)
    d_shards = optimizer.direction_(state, grad_shards, p_shards,
                                    state.momentum, state.nu, keep)
    full = all_gather_buckets(d_shards, plan,
                              torch.empty_like(state.params))
    optimizer.finish_(state, full, keep)


