"""The port's GSPMD placements (``pytorch_multiprocessing_distributed_tpu_
torch/train/placement.py``) against the JAX package's ``tp_param_spec``,
``zero1_opt_spec``, ``state_shardings`` and ``shard_state``.

For ResNet-18, ResNet-50 (ImageNet stem), VGG-16, DenseNet-121, ViT-Tiny
and ConvNeXt-T, at grids (4, 1), (2, 2) and (1, 4), plain, with
``zero1`` and with ``fsdp``:

- shapes only (``jax.eval_shape``, no weights): every leaf's split dims,
  mapped back to JAX's axes, are the axes of JAX's ``NamedSharding`` for
  params, BN stats and moments; each rank's bytes of params, stats and
  moments are JAX's ``tree_shard_nbytes`` of that placement;
- with values (random numpy trees): the slices the port keeps at each
  grid coordinate, carried from JAX's replicated trees, are bit for bit
  the ``addressable_shards`` JAX's ``shard_state`` leaves on the device
  at that coordinate (in the torch layout).

The rules' own corner cases: a trailing dim that does not divide stays
whole (ResNet-18's 10-class head at 4 model ranks), the largest free dim
is the one split over ``data`` (and never a dim that does not divide,
such as a stem kernel's Cin of 3), ties go to the first JAX dim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.runtime import hbm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    carry_jax_variables, get_model, load_jax_resnet)
from pytorch_multiprocessing_distributed_tpu_torch.models.init import (
    jax_param_path)
from pytorch_multiprocessing_distributed_tpu_torch.train import placement

from zoo_carry import random_variables

# name -> (stem, image size)
MODELS = {"res": ("cifar", 32), "resnet50": ("imagenet", 64),
          "vgg": ("cifar", 32), "dense": ("cifar", 32),
          "vit_tiny": ("cifar", 32), "convnext_t": ("cifar", 32)}
GRIDS = [(4, 1), (2, 2), (1, 4)]
MODES = {"plain": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
STATS = {"running_mean": "mean", "running_var": "var"}


def _carry(name):
    return load_jax_resnet if name.startswith("res") else carry_jax_variables


@pytest.fixture(scope="module")
def zoo():
    """Per model: the JAX model, the port model and JAX's variable
    shapes."""
    cache = {}

    def get(name):
        if name not in cache:
            stem, size = MODELS[name]
            jmodel = jax_models.get_model(name, stem=stem)
            shapes = jax.eval_shape(
                lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32))
            port = get_model(name, stem=stem, image_size=size)
            cache[name] = (jmodel, port, shapes)
        return cache[name]

    return get


def _jax_path(model, name, shape, stat=False):
    path_of = getattr(model, "jax_param_path", jax_param_path)
    path = tuple(path_of(name, shape))
    return path[:-1] + (STATS[path[-1]],) if stat else path


def _by_path(tree):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_state(params, stats):
    return JaxTrainState(
        params=params, batch_stats=stats,
        opt_state=jax_optim.OptState(
            momentum=params, count=np.zeros((), np.int32),
            initialized=np.zeros((), np.bool_)),
        epoch=np.ones((), np.int32))


def _jax_spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _on_jax_dims(leaf, to_torch):
    return tuple(leaf.spec[t] for t in to_torch)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", list(MODELS))
def test_placement_matches_state_shardings(zoo, name, grid, mode):
    """Shapes only: each leaf's split axes on JAX's dims, and each
    rank's bytes of params, stats and moments, are JAX's."""
    jmodel, port, shapes = zoo(name)
    mesh = make_mesh(*grid, devices=jax.devices()[:grid[0] * grid[1]])
    state = _jax_state(shapes["params"], shapes.get("batch_stats", {}))
    sh = jax_step.state_shardings(state, mesh, **MODES[mode])
    ours = placement.plan_placement(port, *grid, **MODES[mode])
    groups = (("params", ours.params, sh.params, False),
              ("opt", ours.opt, sh.opt_state.momentum, False),
              ("stats", ours.stats, sh.batch_stats, True))
    for kind, leaves, tree, stat in groups:
        ref = _by_path(tree)
        assert len(leaves) == len(ref), kind
        for leaf in leaves:
            path = _jax_path(port, leaf.name, leaf.shape, stat)
            to_torch = (tuple(range(len(leaf.shape))) if stat else
                        placement.jax_to_torch_dims(port, leaf.name,
                                                    leaf.shape))
            assert _on_jax_dims(leaf, to_torch) == _jax_spec(
                ref[path], len(leaf.shape)), (kind, leaf.name)
    placed = jax.tree.map(
        lambda s, n: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=n),
        state, sh)
    nbytes = ours.resident_bytes()
    assert nbytes["params"] == hbm.tree_shard_nbytes(placed.params)
    assert nbytes["batch_stats"] == hbm.tree_shard_nbytes(
        placed.batch_stats)
    assert nbytes["opt_state"] == hbm.tree_shard_nbytes(
        placed.opt_state.momentum)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", list(MODELS))
def test_carried_slices_are_jax_shards(zoo, name, grid):
    """Random trees placed by JAX's ``shard_state`` (``zero1`` for the
    moments, ``fsdp`` for params and stats, so every rule is met):
    the port's slices of the carried trees at each coordinate equal the
    device's ``addressable_shards``, bit for bit."""
    jmodel, port, _ = zoo(name)
    stem, size = MODELS[name]
    params, stats = random_variables(jmodel, (2, size, size, 3), seed=3)
    moments = jax.tree.map(lambda a: (a * 3 + 1).astype(np.float32), params)
    mesh = make_mesh(*grid, devices=jax.devices()[:grid[0] * grid[1]])
    state = _jax_state(params, stats).replace(
        opt_state=jax_optim.OptState(
            momentum=moments, count=np.zeros((), np.int32),
            initialized=np.zeros((), np.bool_)))
    fsdp = jax_step.shard_state(state, mesh, fsdp=True)
    zero1 = jax_step.shard_state(state, mesh, zero1=True)
    carry = _carry(name)
    sd, msd = carry(params, stats), carry(moments, stats)
    coord = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(mesh.devices)}
    cases = (("params", "fsdp", sd, fsdp.params, False),
             ("opt", "zero1", msd, zero1.opt_state.momentum, False),
             ("stats", "fsdp", sd, fsdp.batch_stats, True))
    for kind, mode, full, tree, stat in cases:
        ours = placement.plan_placement(port, *grid, **MODES[mode])
        leaves = ours.leaves(kind)
        ref = _by_path(tree)
        offsets = ours.offsets(kind)
        values = [full[leaf.name] for leaf in leaves]
        for (d, m) in np.ndindex(*grid):
            local = ours.shard(values, kind, d, m)
            for leaf, off in zip(leaves, offsets):
                lshape = leaf.local_shape(*grid)
                got = local[off:off + lshape.numel()].view(lshape).numpy()
                to_torch = (tuple(range(len(leaf.shape))) if stat else
                            placement.jax_to_torch_dims(port, leaf.name,
                                                        leaf.shape))
                arr = ref[_jax_path(port, leaf.name, leaf.shape, stat)]
                shard, = [s for s in arr.addressable_shards
                          if coord[s.device.id] == (d, m)]
                want = np.transpose(np.asarray(shard.data),
                                    np.argsort(to_torch))
                assert np.array_equal(got, want), (kind, leaf.name, d, m)


def test_rules_corner_cases():
    """The rules on JAX shapes: an indivisible trailing dim stays whole;
    ``data`` takes the largest divisible free dim, the first of equals,
    never an indivisible one; a Dense kernel's ``data`` dim lands on the
    torch dim that holds it."""
    assert placement.tp_param_spec((512, 10), 4) == (None, None)
    assert placement.tp_param_spec((512, 10), 2) == (None, "model")
    assert placement.zero1_opt_spec((3, 3, 3, 64), 4, 1) == (
        None, None, None, "data")
    assert placement.zero1_opt_spec((3, 3, 3, 64), 4, 2) == (
        None, None, None, "model")
    assert placement.zero1_opt_spec((3, 3, 64, 64), 4, 2) == (
        None, None, "data", "model")
    assert placement.zero1_opt_spec((8, 8), 2, 1) == ("data", None)
    model = get_model("res")
    plan = placement.plan_placement(model, 2, 4, fsdp=True)
    head = {leaf.name: leaf for leaf in plan.params}["linear.weight"]
    # JAX (512, 10): 10 does not divide over 4 model ranks, 512 goes to
    # data; in the torch layout (10, 512) that is dim 1
    assert head.spec == (None, "data")
    stem = {leaf.name: leaf for leaf in plan.params}["conv1.weight"]
    # JAX (3, 3, 3, 64) at 2 x 4: Cout over model; no other dim divides
    # over 2 data ranks
    assert stem.spec == ("model", None, None, None)
    assert torch.Size((16, 3, 3, 3)) == stem.local_shape(2, 4)


def test_chip_smoke_resident_bytes_are_jax_bytes():
    """``chip_smoke.py``'s ``JAX_RESIDENT`` (it cannot import JAX): each
    entry is JAX's per-device bytes of params, BN stats and one moment
    tree under ``state_shardings`` on that mesh, and the port's
    placement's bytes."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {}
    for (name, mode, data, mp), want in smoke.JAX_RESIDENT.items():
        stem, classes, size = (("imagenet", 1000, 64) if name == "resnet50"
                               else ("cifar", 10, 32))
        if name not in shapes:
            jmodel = jax_models.get_model(name, stem=stem,
                                          num_classes=classes)
            shapes[name] = (jax.eval_shape(
                lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)),
                get_model(name, stem=stem, num_classes=classes))
        variables, port = shapes[name]
        flags = {"plain": {}, "zero1": {"zero1": True},
                 "fsdp": {"fsdp": True}}[mode]
        state = _jax_state(variables["params"], variables["batch_stats"])
        mesh = make_mesh(data, mp, devices=jax.devices()[:data * mp])
        placed = jax.tree.map(
            lambda s, n: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=n),
            state, jax_step.state_shardings(state, mesh, **flags))
        assert want == (hbm.tree_shard_nbytes(placed.params),
                        hbm.tree_shard_nbytes(placed.batch_stats),
                        hbm.tree_shard_nbytes(placed.opt_state.momentum))
        ours = placement.plan_placement(port, data, mp, **flags)
        nbytes = ours.resident_bytes()
        assert want == (nbytes["params"], nbytes["batch_stats"],
                        nbytes["opt_state"]), (name, mode, data, mp)
