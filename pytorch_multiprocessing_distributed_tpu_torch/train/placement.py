"""The GSPMD placements of the image and LM train states (the port of
the JAX package's ``train/step.py`` rules: ``tp_param_spec``,
``zero1_opt_spec``, ``state_shardings`` and ``shard_state``).

JAX decides every placement on ITS shapes: a conv kernel is ``(H, W,
Cin, Cout)`` there and ``(Cout, Cin, kh, kw)`` here, an image model's
Dense kernel ``(in, out)`` there and ``(out, in)`` here (the GPT keeps
``(in, out)`` and says so through its own ``jax_to_torch_dims``). So
the rules run on the JAX shape of each leaf (from the flax path the
port already maps, :func:`..models.init.jax_param_path`) and the chosen
dims are then mapped into the torch layout; deciding on torch shapes
would pick other dims wherever sizes tie.

- ``tp_param_spec``: the trailing JAX dim over ``model`` when it
  divides; else replicated.
- ``zero1_opt_spec``: that, plus the largest remaining divisible dim
  over ``data``.
- params, batch stats and the EMA take the first rule (the second under
  ``fsdp``); the moments take the second under ``zero1`` or ``fsdp``.

A rank at grid coordinate ``(d, m)`` holds the slice of every leaf that
JAX's ``NamedSharding`` leaves on the device at ``(d, m)``: the ``m``-th
of ``M`` even pieces along the ``model`` dim and the ``d``-th of ``W``
along the ``data`` dim. :class:`PlacedState` keeps the port's flat f32
buffers, each holding this rank's slices only, leaf by leaf in the
model's order. The module weights are gathered at use: every parameter
is a ``torch.nn.utils.parametrize`` view that all-gathers its slices
over the axes that shard it when a module reads it, and whose backward
reduces the full gradient over ``data`` into this rank's moment slice
(a reduce-scatter where the moments are sharded over ``data``). The BN
running stats are gathered for a step and this rank's slices kept
after it. Checkpoints gather the whole state first (a collective), so a
placed run writes the plain run's payload.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
from torch import nn
from torch.nn.utils import parametrize

from ..models.init import jax_param_path
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Grid
from .state import TrainState

Spec = Tuple[Optional[str], ...]


def tp_param_spec(shape: Sequence[int], tp: int) -> Spec:
    """JAX ``tp_param_spec`` on a JAX shape: the trailing dim over
    ``model`` when it divides evenly, else replicated."""
    spec: List[Optional[str]] = [None] * len(shape)
    if tp > 1 and len(shape) >= 1 and shape[-1] % tp == 0 \
            and shape[-1] >= tp:
        spec[-1] = MODEL_AXIS
    return tuple(spec)


def zero1_opt_spec(shape: Sequence[int], dp: int, tp: int) -> Spec:
    """JAX ``zero1_opt_spec`` on a JAX shape: the TP rule, then the
    LARGEST remaining divisible dim over ``data`` (the first of equals)."""
    spec = list(tp_param_spec(shape, tp))
    best, best_size = None, 0
    for i, n in enumerate(shape):
        if spec[i] is None and n % dp == 0 and n >= dp and n > best_size:
            best, best_size = i, n
    if best is not None:
        spec[best] = DATA_AXIS
    return tuple(spec)


def jax_to_torch_dims(model: nn.Module, name: str,
                      shape: Sequence[int]) -> Tuple[int, ...]:
    """``t`` with JAX dim ``j`` of the parameter ``name`` held in torch
    dim ``t[j]``: the model's own rule where it has one (a
    ``jax_to_torch_dims`` method: the GPT keeps flax's layouts), else
    the zoo's: conv kernels HWIO -> OIHW, Dense kernels transposed,
    every other leaf as it is."""
    own = getattr(model, "jax_to_torch_dims", None)
    if own is not None:
        return tuple(own(name, shape))
    path_of = getattr(model, "jax_param_path", jax_param_path)
    if path_of(name, shape)[-1] == "kernel":
        if len(shape) == 4:
            return (2, 3, 1, 0)
        if len(shape) == 2:
            return (1, 0)
    return tuple(range(len(shape)))


@dataclass(frozen=True)
class Leaf:
    """One leaf's placement: its torch ``shape`` and, per torch dim, the
    grid axis that splits it (or None)."""

    name: str
    shape: torch.Size
    spec: Spec

    def dim_of(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    def local_shape(self, dp: int, tp: int) -> torch.Size:
        return torch.Size(
            n // (dp if a == DATA_AXIS else tp if a == MODEL_AXIS else 1)
            for n, a in zip(self.shape, self.spec))

    def slice(self, full: torch.Tensor, d: int, m: int, dp: int,
              tp: int) -> torch.Tensor:
        """The piece of ``full`` (this leaf's torch shape) at ``(d, m)``:
        a view."""
        for axis, index, n in ((MODEL_AXIS, m, tp), (DATA_AXIS, d, dp)):
            dim = self.dim_of(axis)
            if dim is not None:
                size = full.shape[dim] // n
                full = full.narrow(dim, index * size, size)
        return full


def _on_jax_shape(leaf_spec: Spec, to_torch: Tuple[int, ...]) -> Spec:
    spec: List[Optional[str]] = [None] * len(to_torch)
    for j, axis in enumerate(leaf_spec):
        spec[to_torch[j]] = axis
    return tuple(spec)


@dataclass(frozen=True)
class Placement:
    """The placement of one model's state on a ``dp x tp`` grid
    (JAX ``state_shardings``): ``params`` (also the EMA's), ``opt`` (the
    moments') and ``stats``, each a :class:`Leaf` per leaf in the
    model's order."""

    dp: int
    tp: int
    params: Tuple[Leaf, ...]
    opt: Tuple[Leaf, ...]
    stats: Tuple[Leaf, ...]

    def leaves(self, kind: str) -> Tuple[Leaf, ...]:
        return getattr(self, kind)

    def local_numel(self, kind: str) -> int:
        return sum(leaf.local_shape(self.dp, self.tp).numel()
                   for leaf in self.leaves(kind))

    def offsets(self, kind: str) -> List[int]:
        """Each leaf's first element in a local flat buffer of ``kind``."""
        out, off = [], 0
        for leaf in self.leaves(kind):
            out.append(off)
            off += leaf.local_shape(self.dp, self.tp).numel()
        return out

    def shard(self, full: Sequence[torch.Tensor], kind: str, d: int,
              m: int) -> torch.Tensor:
        """The local flat buffer at ``(d, m)`` from the full leaves
        ``full`` (torch shapes, the model's order)."""
        pieces = [leaf.slice(t, d, m, self.dp, self.tp).reshape(-1)
                  for leaf, t in zip(self.leaves(kind), full)]
        return (torch.cat(pieces) if pieces else
                torch.zeros(0, dtype=torch.float32))

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes a rank holds of params, BN stats and one moment tree
        (f32; the same at every coordinate: the pieces are even)."""
        return {"params": 4 * self.local_numel("params"),
                "batch_stats": 4 * self.local_numel("stats"),
                "opt_state": 4 * self.local_numel("opt")}


def plan_placement(model: nn.Module, dp: int, tp: int = 1, *,
                   zero1: bool = False, fsdp: bool = False) -> Placement:
    """The placement of ``model``'s params, moments and float buffers
    (the BN running stats) on a ``dp x tp`` grid, decided on the JAX
    shapes (see the module note). Shapes only: no weights are read."""
    params, opt = [], []
    for name, p in model.named_parameters():
        to_torch = jax_to_torch_dims(model, name, p.shape)
        jshape = tuple(p.shape[t] for t in to_torch)
        tp_spec = _on_jax_shape(tp_param_spec(jshape, tp), to_torch)
        dp_spec = _on_jax_shape(zero1_opt_spec(jshape, dp, tp), to_torch)
        params.append(Leaf(name, p.shape, dp_spec if fsdp else tp_spec))
        opt.append(Leaf(name, p.shape,
                        dp_spec if (zero1 or fsdp) else tp_spec))
    stats = []
    for name, b in model.named_buffers():
        if b.is_floating_point():
            shape = tuple(b.shape)
            stats.append(Leaf(name, b.shape, zero1_opt_spec(shape, dp, tp)
                              if fsdp else tp_param_spec(shape, tp)))
    return Placement(dp, tp, tuple(params), tuple(opt), tuple(stats))


# ---------------------------------------------------------------- gathers


def assemble(pieces: torch.Tensor, leaf: Leaf, shape: torch.Size,
              data: bool = True, model: bool = True) -> torch.Tensor:
    """``pieces`` ``[dp', tp', *local]`` (the pieces of ``leaf`` along
    the named axes, size 1 along an axis not gathered) laid out as one
    tensor of ``shape``: each piece's index becomes the major part of
    its dim."""
    d_dim = leaf.dim_of(DATA_AXIS) if data else None
    m_dim = leaf.dim_of(MODEL_AXIS) if model else None
    if d_dim is None:
        pieces = pieces[:1]
    if m_dim is None:
        pieces = pieces[:, :1]
    order = ([0] if d_dim is None else []) + ([1] if m_dim is None else [])
    for i in range(pieces.dim() - 2):
        order += ([0] if i == d_dim else []) + ([1] if i == m_dim else [])
        order.append(2 + i)
    return pieces.permute(order).reshape(shape)


def _all_gather(local: torch.Tensor, size: int, group) -> torch.Tensor:
    """``[size * n]``: the group's ``local`` buffers end to end."""
    out = local.new_empty(size * local.numel())
    tdist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out


class _GatherLeaf(torch.autograd.Function):
    """A parameter's full value from this rank's slice (all-gathered
    over the axes that shard it). The backward reduces the full gradient
    over ``data`` into this rank's moment slice of the leaf and adds it
    to the state's gradient buffer; the slice itself takes no gradient
    through autograd."""

    @staticmethod
    def forward(ctx, local, placed, i):
        ctx.placed, ctx.i = placed, i
        return placed.gather_param(local, i)

    @staticmethod
    def backward(ctx, grad):
        ctx.placed.reduce_grad(grad, ctx.i)
        return None, None, None


class _AtUse(nn.Module):
    """The parametrization of leaf ``i``: its full value at use."""

    def __init__(self, placed: "PlacedState", i: int):
        super().__init__()
        # a plain attribute: the state is no submodule of the model
        object.__setattr__(self, "placed", placed)
        self.i = i

    def forward(self, local):
        return _GatherLeaf.apply(local, self.placed, self.i)


@dataclass
class PlacedState(TrainState):
    """A :class:`.state.TrainState` whose flat buffers hold this rank's
    slices (see the module note): ``params``/``ema`` and ``stats`` by the
    placement's ``params`` and ``stats`` leaves, ``momentum``/``nu`` and
    ``grads`` (the reduced gradients) by its ``opt`` leaves. ``layout``
    and ``stats_layout`` stay the model's whole layout (the gathered
    payload's)."""

    placement: Optional[Placement] = None
    grid: Optional[Grid] = None
    state_dict_keys: Tuple[str, ...] = ()
    opt_offsets: Tuple[int, ...] = ()

    def _local(self, kind: str, i: int) -> torch.Size:
        leaf = self.placement.leaves(kind)[i]
        return leaf.local_shape(self.placement.dp, self.placement.tp)

    def leaf_views(self, flat: torch.Tensor, kind: str
                   ) -> List[torch.Tensor]:
        """Views of the local flat ``flat`` (of ``kind``), one a leaf."""
        pl = self.placement
        return [flat[off:off + self._local(kind, i).numel()].view(
                    self._local(kind, i))
                for i, off in enumerate(pl.offsets(kind))]

    # --- the parameter at use, and its gradient
    def gather_param(self, local: torch.Tensor, i: int) -> torch.Tensor:
        leaf, grid = self.placement.params[i], self.grid
        data = leaf.dim_of(DATA_AXIS) is not None and grid.data > 1
        model = leaf.dim_of(MODEL_AXIS) is not None and grid.model > 1
        if not (data or model):
            return local.view(leaf.shape)
        size = (grid.data if data else 1) * (grid.model if model else 1)
        flat = _all_gather(local.reshape(-1), size,
                           grid.axis_group(data, model))
        return assemble(flat.view(grid.data if data else 1,
                                   grid.model if model else 1,
                                   *local.shape),
                         leaf, leaf.shape, data, model)

    def reduce_grad(self, grad: torch.Tensor, i: int) -> None:
        """This rank's moment slice of leaf ``i``'s gradient: its model
        piece of ``grad`` summed over the data group (reduce-scattered
        where the moments are sharded over ``data``), added into
        ``grads``."""
        leaf, grid = self.placement.opt[i], self.grid
        x = leaf.slice(grad, 0, grid.model_index, 1, grid.model)
        local = self._local("opt", i)
        off = self.opt_offsets[i]
        out = self.grads[off:off + local.numel()]
        d_dim = leaf.dim_of(DATA_AXIS)
        if grid.data == 1:
            out.add_(x.reshape(-1))
        elif d_dim is None:
            x = x.contiguous()
            tdist.all_reduce(x, group=grid.data_group)
            out.add_(x.reshape(-1))
        else:
            n = x.shape[d_dim] // grid.data
            chunks = x.unflatten(d_dim, (grid.data, n)).movedim(d_dim, 0)
            red = torch.empty(local.numel(), dtype=x.dtype, device=x.device)
            tdist.reduce_scatter_tensor(red, chunks.contiguous().reshape(-1),
                                        group=grid.data_group)
            out.add_(red)

    # --- whole buffers
    def gather_full(self, flat: torch.Tensor, kind: str) -> torch.Tensor:
        """The model's whole flat buffer (its order) from every rank's
        local ``flat`` of ``kind``: one all-gather over the grid, then
        the pieces laid out leaf by leaf. A collective."""
        pl, grid = self.placement, self.grid
        if not pl.leaves(kind):
            return flat.new_zeros(0)
        if grid.size > 1:
            every = _all_gather(flat, grid.size, None).view(grid.size, -1)
        else:
            every = flat.view(1, -1)
        pieces = []
        for i, (leaf, off) in enumerate(zip(pl.leaves(kind),
                                            pl.offsets(kind))):
            n = self._local(kind, i).numel()
            pieces.append(assemble(
                every[:, off:off + n].reshape(grid.data, grid.model,
                                              *self._local(kind, i)),
                leaf, leaf.shape).reshape(-1))
        return torch.cat(pieces)

    def gathered(self) -> TrainState:
        """The whole state as a plain :class:`.state.TrainState` (its
        model unbound): every rank's slices gathered. A collective: every
        rank calls it (JAX ``_gather_for_host``)."""
        def full(flat, kind):
            return None if flat is None else self.gather_full(flat, kind)

        return TrainState(
            model=None, params=full(self.params, "params"), grads=None,
            momentum=full(self.momentum, "opt"),
            initialized=self.initialized, count=self.count,
            stats=full(self.stats, "stats"), epoch=self.epoch,
            layout=self.layout, stats_layout=self.stats_layout,
            nu=full(self.nu, "opt"), ema=full(self.ema, "params"))

    def to_dict(self, momentum=None, nu=None) -> Dict[str, object]:
        """The plain run's payload (a collective, see :meth:`gathered`)."""
        return self.gathered().to_dict()

    def load_dict(self, d: Dict[str, object]) -> None:
        raise ValueError("load a checkpoint before shard_state (the plain "
                         "payload into the plain state, then place it)")

    def state_dict(self) -> "OrderedDict[str, torch.Tensor]":
        """The model's whole ``state_dict`` (the plain model's keys and
        order; a collective)."""
        full = self.gathered()
        named = {**full.views(full.params), **full.stat_views()}
        return OrderedDict((k, named[k]) for k in self.state_dict_keys)

    # --- the BN running stats of a step
    @contextlib.contextmanager
    def stats_in_use(self, keep: bool):
        """The BN modules read and write whole running stats inside the
        block (gathered; this rank's own buffer where nothing of them
        is sharded); with ``keep`` this rank's slices are taken from
        them after."""
        whole = self.grid.size == 1 or all(
            set(leaf.spec) <= {None} for leaf in self.placement.stats)
        full = self.stats if whole else self.gather_full(self.stats,
                                                         "stats")
        for name, off, shape in self.stats_layout:
            owner, _, attr = name.rpartition(".")
            setattr(self.model.get_submodule(owner), attr,
                    full[off:off + shape.numel()].view(shape))
        try:
            yield full
        finally:
            if keep and not whole:
                with torch.no_grad():
                    self.stats.copy_(_slices(self.placement, full,
                                             self.stats_layout, "stats",
                                             self.grid))


def _slices(placement: Placement, full: Optional[torch.Tensor],
            layout: Sequence[Tuple[str, int, torch.Size]], kind: str,
            grid: Grid) -> Optional[torch.Tensor]:
    """This rank's local flat buffer of ``kind`` from the whole flat
    ``full`` laid out by ``layout``."""
    if full is None:
        return None
    return placement.shard(
        [full[off:off + s.numel()].view(s) for _, off, s in layout], kind,
        grid.data_index, grid.model_index).to(full.device)


def shard_state(state: TrainState, placement: Placement,
                grid: Grid) -> PlacedState:
    """Place a plain state (a fresh init or a resumed checkpoint, bound
    to its model) on the grid, JAX ``shard_state``: this rank keeps its
    slices of params, stats, moments and EMA, and the model's parameters
    become views gathered at use (see the module note). Every rank calls
    it with the same state."""
    if state.zero is not None:
        raise ValueError("a --zero state cannot be placed on a grid")
    if (grid.data, grid.model) != (placement.dp, placement.tp):
        raise ValueError(
            f"placement for {placement.dp} x {placement.tp}, grid "
            f"{grid.data} x {grid.model}")
    model = state.model

    def mine(flat, kind, layout=state.layout):
        return _slices(placement, flat, layout, kind, grid)

    device = state.params.device
    opt_n = placement.local_numel("opt")
    placed = PlacedState(
        model=model, params=mine(state.params, "params"),
        grads=torch.zeros(opt_n, dtype=torch.float32, device=device),
        momentum=mine(state.momentum, "opt"),
        initialized=state.initialized, count=state.count,
        stats=mine(state.stats, "stats", state.stats_layout),
        epoch=state.epoch, layout=state.layout,
        stats_layout=state.stats_layout, nu=mine(state.nu, "opt"),
        ema=mine(state.ema, "params"), placement=placement, grid=grid,
        state_dict_keys=tuple(model.state_dict()),
        opt_offsets=tuple(placement.offsets("opt")))
    views = placed.leaf_views(placed.params, "params")
    for i, leaf in enumerate(placement.params):
        owner, _, attr = leaf.name.rpartition(".")
        module = model.get_submodule(owner)
        parametrize.register_parametrization(module, attr,
                                             _AtUse(placed, i), unsafe=True)
        original = module.parametrizations[attr].original
        original.data = views[i]
        original.requires_grad_(True)
    return placed
