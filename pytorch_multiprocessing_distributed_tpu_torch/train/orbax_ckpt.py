"""Sharded, optionally asynchronous checkpoints (the port of the JAX
package's ``train/orbax_ckpt.py``, ``--ckpt_backend orbax``), written
with ``torch.distributed.checkpoint`` (DCP).

The single-file backend (:mod:`.checkpoint`) gathers a placed state
onto every rank and writes it from the primary. This one writes, from
each rank, only the slices it holds: a placed state's
(:mod:`.placement`: ``--zero1``, ``--fsdp``, ``--model_parallel``,
``train_lm --parallel tp``) as DTensors on the ``(data, model)`` grid,
a pipelined state's (``train_lm --parallel pp``) as its stage's rows of
JAX's stacked tree on the ``(data, pipe)`` grid; a replicated leaf is
written once (DCP spreads replicated items over the ranks). Every leaf
keeps the single-file payload's key (:meth:`.state.TrainState.to_dict`),
so :meth:`OrbaxCheckpointer.restore` reads any save into any world
size, grid or mode: each rank reads the whole leaves from the files
(DCP's metadata maps every saved piece), with no collective gather,
and the state loads them as it loads the single-file payload, before
any placement.

Artifacts: ``{save_path}/orbax/<epoch>/`` (DCP's ``__<rank>_<i>.distcp``
files and ``.metadata``). An epoch exists once its ``.metadata`` is
written, which DCP does last, so a save that died midway is never a
resume candidate. ``async_=True`` saves through ``async_save``: the
state is copied to host memory before ``save`` returns and written in a
background thread while training goes on; :meth:`wait` makes it
durable. With more than one rank the checkpoint's own collectives run
on a gloo group of their own, beside the training's NCCL group.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as tdist

from ..parallel import broadcast_int, dist
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, get_grid
from ..runtime.faults import maybe_fault, register_site
from .state import TrainState

# a failed sharded save must surface as its error at the save call
_SITE_SAVE = register_site(
    "train.orbax_save", "orbax sharded checkpoint save/commit")

_META = ".metadata"  # DCP writes it last: the epoch's commit marker

# a leaf: (this rank's piece, the whole shape, the piece's dim along
# the grid's data axis and along its second axis, None = not split)
Piece = Tuple[torch.Tensor, torch.Size, Optional[int], Optional[int]]


def _key(prefix: str, name: str) -> str:
    return f"{prefix}/{name.replace('.', '/')}"


def _placed_pieces(state) -> Dict[str, Piece]:
    pl = state.placement
    moments = (("opt_state/momentum", state.momentum),) if state.nu is None \
        else (("opt_state/mu", state.momentum), ("opt_state/nu", state.nu))
    groups = (("params", state.params, "params"),
              ("batch_stats", state.stats, "stats"),
              *((p, t, "opt") for p, t in moments),
              ("ema_params", state.ema, "params"))
    out: Dict[str, Piece] = {}
    for prefix, flat, kind in groups:
        if flat is None:
            continue
        for leaf, local in zip(pl.leaves(kind),
                               state.leaf_views(flat, kind)):
            out[_key(prefix, leaf.name)] = (
                local, leaf.shape, leaf.dim_of(DATA_AXIS),
                leaf.dim_of(MODEL_AXIS))
    return out


def _pipelined_pieces(state) -> Dict[str, Piece]:
    """This stage's rows of the stacked tree: the stacked leaves split
    on their stage dim; ``pos`` and ``ln_f`` (stage 0's, as in the
    gathered payload) from stage 0 only."""
    from ..parallel.gpt_pipeline import stack_stages

    out: Dict[str, Piece] = {}
    for prefix, flat in (("params", state.params),
                         ("opt_state/momentum", state.momentum)):
        for name, t in stack_stages([state.views(flat)]).items():
            if name in ("pos",) or name.startswith("ln_f."):
                if state.stage == 0:
                    out[_key(prefix, name)] = (t, t.shape, None, None)
                continue
            out[_key(prefix, name)] = (
                t, torch.Size((state.n_stages, *t.shape[1:])), None, 0)
    return out


def _plain_pieces(state: TrainState) -> Dict[str, Piece]:
    if state.zero is not None:
        raise ValueError(
            "a --zero state checkpoints through the single-file "
            "gather-on-save path (--ckpt_backend msgpack)")
    return {_key(prefix, name): (t, t.shape, None, None)
            for prefix, views in state._groups()
            for name, t in views.items()}


def _state_pieces(state: TrainState) -> Dict[str, Piece]:
    """Every leaf this rank holds of ``state``, under the single-file
    payload's keys, with where it sits in the whole leaf."""
    from ..parallel.gpt_pipeline import PipelinedState
    from .placement import PlacedState

    if isinstance(state, PlacedState):
        out = _placed_pieces(state)
    elif isinstance(state, PipelinedState):
        out = _pipelined_pieces(state)
    else:
        out = _plain_pieces(state)
    for name in ("count", "initialized"):
        t = getattr(state, name)
        out[f"opt_state/{name}"] = (t, t.shape, None, None)
    epoch = torch.tensor(int(state.epoch), dtype=torch.int64)
    out["epoch"] = (epoch, epoch.shape, None, None)
    return out


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class OrbaxCheckpointer:
    """Epoch-keyed sharded checkpoints under ``{save_path}/orbax/``.

    Every rank calls :meth:`save`, :meth:`latest_epoch` and
    :meth:`close` (collectives); :meth:`restore` reads alone.

    Args:
      save_path: the experiment directory (``orbax/`` is made in it;
        shared by every rank).
      keep: retain only the newest K epochs (None/0 = all).
      async_: write in the background; :meth:`wait` (or :meth:`close`)
        blocks until the last save is durable.
    """

    def __init__(self, save_path: str, *, keep: Optional[int] = None,
                 async_: bool = False):
        self.directory = os.path.abspath(os.path.join(save_path, "orbax"))
        self.keep = keep or None
        self.async_ = async_
        self._pending = None  # (future, epoch) of an async save
        self._group = None    # the checkpoint's gloo group (world > 1)
        self._mesh = None     # the grid as a DeviceMesh, for DTensors

    # ------------------------------------------------------------ paths
    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, str(epoch))

    def _committed(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _META)))

    def has_epoch(self, epoch: int) -> bool:
        """True once ``epoch``'s save is durable (an async save in
        flight is not)."""
        return os.path.exists(os.path.join(self.epoch_path(epoch), _META))

    def latest_epoch(self) -> Optional[int]:
        """The newest durable epoch: the primary rank's verdict, for
        every rank (a collective with more than one rank)."""
        found = self._committed() if dist.is_primary() else []
        epoch = broadcast_int(found[-1] if found else -1)
        return None if epoch < 0 else epoch

    def bytes_by_rank(self, epoch: int) -> Dict[int, int]:
        """``{rank: bytes of its data files}`` of a saved epoch."""
        out: Dict[int, int] = {}
        path = self.epoch_path(epoch)
        for name in os.listdir(path):
            m = re.fullmatch(r"__(\d+)_\d+\.distcp", name)
            if m:
                r = int(m.group(1))
                out[r] = out.get(r, 0) + os.path.getsize(
                    os.path.join(path, name))
        return dict(sorted(out.items()))

    # ------------------------------------------------------------- save
    def _dist_kw(self) -> dict:
        if dist.get_world_size() == 1:
            return {"no_dist": True}
        if self._group is None:
            self._group = tdist.new_group(backend="gloo")
        return {"process_group": self._group}

    def _state_dict(self, state: TrainState) -> Dict[str, object]:
        shards = _state_pieces(state)
        alone = dist.get_world_size() == 1
        out: Dict[str, object] = {}
        for key, (local, shape, d_dim, m_dim) in shards.items():
            local = local.detach()  # the params' views take gradients
            if self.async_:
                # a host copy of its own: training goes on writing the
                # buffers this piece views
                local = local.to("cpu", copy=True)
            if alone or (d_dim is None and m_dim is None):
                out[key] = local  # whole here: DCP writes it once
                continue
            out[key] = self._dtensor(local, shape, d_dim, m_dim)
        return out

    def _dtensor(self, local, shape, d_dim, m_dim):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor import Shard

        if self._mesh is None:
            grid = get_grid()
            world = dist.get_world_size()
            rows, cols = ((grid.data, grid.model) if grid is not None
                          else (world, 1))
            second = grid.axis if grid is not None else MODEL_AXIS
            self._mesh = DeviceMesh(
                local.device.type, torch.arange(world).view(rows, cols),
                mesh_dim_names=(DATA_AXIS, second))
        placements = [Replicate() if d is None else Shard(d)
                      for d in (d_dim, m_dim)]
        return DTensor.from_local(local, self._mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    def save(self, state: TrainState, epoch: int) -> str:
        """Write ``state`` as ``epoch``; returns the epoch's directory
        (durable on return, or after :meth:`wait` when async). An
        existing epoch is overwritten, as the single-file backend
        overwrites ``model_<epoch>.pth``; an async save in flight is
        settled first."""
        import torch.distributed.checkpoint as dcp

        maybe_fault(_SITE_SAVE)
        self.wait()
        path = self.epoch_path(epoch)
        if dist.is_primary():
            os.makedirs(self.directory, exist_ok=True)
            if os.path.isdir(path):
                shutil.rmtree(path)
        dist.barrier()
        state_dict = self._state_dict(state)
        if self.async_:
            self._pending = (dcp.async_save(
                state_dict, checkpoint_id=path, **self._dist_kw()), epoch)
        else:
            dcp.save(state_dict, checkpoint_id=path, **self._dist_kw())
            self._retain()
        return path

    def _retain(self) -> None:
        """Delete all but the newest ``keep`` durable epochs (primary)."""
        if not self.keep or not dist.is_primary():
            return
        for epoch in self._committed()[:-self.keep]:
            shutil.rmtree(self.epoch_path(epoch), ignore_errors=True)

    def wait(self) -> None:
        """Block until an async save in flight is durable."""
        if self._pending is None:
            return
        future, _ = self._pending
        self._pending = None
        future.result()
        self._retain()

    # ---------------------------------------------------------- restore
    def load_payload(self, epoch: int) -> Dict[str, object]:
        """The whole saved payload of ``epoch`` on the CPU, under the
        single-file payload's keys (``epoch`` an int)."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata)

        path = self.epoch_path(epoch)
        if not self.has_epoch(epoch):
            raise FileNotFoundError(f"no orbax checkpoint at {path}")
        meta = dcp.FileSystemReader(path).read_metadata()
        payload = {key: torch.empty(md.size, dtype=md.properties.dtype)
                   for key, md in meta.state_dict_metadata.items()
                   if isinstance(md, TensorStorageMetadata)}
        dcp.load(payload, checkpoint_id=path, no_dist=True)
        payload["epoch"] = int(payload["epoch"])
        return payload

    def restore(self, state: TrainState,
                epoch: Optional[int] = None) -> TrainState:
        """Load ``epoch`` (default: the latest) into ``state`` (a plain
        or pipelined state, before any placement or ``--zero``
        sharding) and return it."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(
                    f"no orbax checkpoint under {self.directory}")
        state.load_dict(self.load_payload(epoch))
        return state

    def close(self) -> None:
        """Make the last save durable and let go of the checkpoint's
        group."""
        self.wait()
        if self._group is not None and tdist.is_initialized():
            tdist.destroy_process_group(self._group)
        self._group = None
        self._mesh = None

    def __enter__(self) -> "OrbaxCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
