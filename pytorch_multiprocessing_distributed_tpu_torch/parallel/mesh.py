"""The ``(data, model)`` grid of ranks (the port of the JAX package's
``parallel/mesh.py``: ``make_mesh``, ``DATA_AXIS``, ``MODEL_AXIS``,
``data_axis_size``).

The second axis takes the name its caller gives it, as ``make_mesh``'s
``axis_names`` does: ``model`` for the image trainer's placements and
``train_lm --parallel tp``, ``seq`` for ``train_lm --parallel sp``
(:func:`axis` hands the sequence axis to ring and Ulysses attention),
``pipe`` for ``train_lm --parallel pp`` (the stages of
:mod:`.gpt_pipeline`, JAX's ``gpt_pipeline.PIPE_AXIS``).

JAX lays ``world_size x model_parallel`` devices out as
``devices.reshape(world_size, model_parallel)``. The port runs one
process per rank, so the grid is the process group itself, read in the
same row-major order: rank ``r`` sits at data index ``r // M`` and model
index ``r % M``. :func:`make_grid` validates the factorisation eagerly,
as ``make_mesh`` does, and builds the two families of subgroups with
``torch.distributed.new_group``: the data group of a rank holds the
ranks of its model index (the replicas that reduce gradients and
BatchNorm sums), its model group the ranks of its data index (the ranks
that see one batch).

Without a grid (the plain data-parallel path) the data group is the
whole process group and :func:`data_size` its size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as tdist

from .dist import get_rank, get_world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class Grid:
    """A ``data x model`` grid of ranks and this rank's place on it.
    ``data_group``/``model_group`` are this rank's subgroups (None: the
    whole process group, or no collective at all when the axis has one
    rank). The group handles live here in the module, never in the grid,
    so nothing holds a process group past
    :func:`..parallel.dist.destroy_process_group`."""

    data: int
    model: int
    rank: int = 0
    axis: str = MODEL_AXIS  # the second axis's name

    @property
    def data_group(self):
        return _GROUPS.get("data")

    @property
    def model_group(self):
        """The second axis's group (``model``, ``seq`` or ``pipe``)."""
        return _GROUPS.get("second")

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis_group(self, data: bool, model: bool):
        """The group spanning the named axes at this rank: both (the
        whole group), one of them, or neither (None)."""
        if data and model:
            return None
        return self.data_group if data else (self.model_group if model
                                             else None)


@dataclass(frozen=True)
class Axis:
    """One rank's view of a named grid axis: its ``size``, this rank's
    ``index`` on it, the global ranks along it in axis order (``ranks``)
    and its ``group`` (None: the whole process group, or one rank)."""

    name: str
    size: int
    index: int
    ranks: tuple

    @property
    def group(self):
        return _GROUPS.get("data" if self.name == DATA_AXIS else "second")


_GRID: Optional[Grid] = None
_GROUPS: dict = {}  # this rank's "data" and second-axis subgroups


def make_grid(world_size: int, model_parallel: int = 1,
              axis: str = MODEL_AXIS) -> Grid:
    """The grid of this process group (one process: a 1 x 1 grid). The
    group must hold exactly ``world_size * model_parallel`` ranks. Every
    rank calls it (``new_group`` is collective). Sets the grid that
    :func:`data_group` and :func:`data_size` read; ``axis`` names the
    second axis (``model``, ``seq`` or ``pipe``)."""
    global _GRID
    reset_grid()
    if world_size < 1 or model_parallel < 1:
        raise ValueError(
            f"grid data={world_size} x model={model_parallel}: both must "
            "be >= 1")
    need, n = world_size * model_parallel, get_world_size()
    if need != n:
        raise ValueError(
            f"grid needs {need} ranks (data={world_size} x "
            f"model={model_parallel}) but the process group has {n}")
    rank = get_rank()
    if world_size > 1 and model_parallel > 1:
        # every rank creates every group, in one order (an axis of the
        # whole group or of one rank needs none)
        for m in range(model_parallel):
            g = tdist.new_group(list(range(m, n, model_parallel)))
            if rank % model_parallel == m:
                _GROUPS["data"] = g
        for d in range(world_size):
            g = tdist.new_group(list(range(d * model_parallel,
                                           (d + 1) * model_parallel)))
            if rank // model_parallel == d:
                _GROUPS["second"] = g
    _GRID = Grid(world_size, model_parallel, rank, axis)
    return _GRID


def get_grid() -> Optional[Grid]:
    return _GRID


def reset_grid() -> None:
    """Forget the grid and its subgroups (the process group is leaving,
    or a new grid replaces them), and which of them the pipeline
    warmed."""
    from .pipeline import forget_warm_groups

    global _GRID
    _GRID = None
    _GROUPS.clear()
    forget_warm_groups()


def data_group():
    """The group BatchNorm and the gradients reduce over: the grid's
    data group, else the whole process group (None)."""
    return None if _GRID is None else _GRID.data_group


def axis(name: str) -> Axis:
    """The grid axis ``name`` at this rank (``data`` or the grid's second
    axis). Without a grid the data axis is the whole process group and
    any other axis raises, as an unbound ``axis_name`` does in JAX."""
    if _GRID is None:
        if name == DATA_AXIS:
            n = get_world_size()
            return Axis(name, n, get_rank(), tuple(range(n)))
        raise ValueError(
            f"no grid axis {name!r}: build the grid with make_grid(dp, "
            f"degree, axis={name!r}) first")
    g = _GRID
    if name == DATA_AXIS:
        ranks = tuple(range(g.model_index, g.size, g.model))
        return Axis(name, g.data, g.data_index, ranks)
    if name != g.axis:
        raise ValueError(
            f"the grid's axes are {DATA_AXIS!r} and {g.axis!r}, not "
            f"{name!r}")
    first = g.data_index * g.model
    return Axis(name, g.model, g.model_index,
                tuple(range(first, first + g.model)))


def data_size() -> int:
    """The data-parallel degree (JAX ``data_axis_size``)."""
    return get_world_size() if _GRID is None else _GRID.data
