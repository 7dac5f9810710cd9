"""The port's tensor-parallel LM step (``train.lm.make_lm_train_step_tp``
on ``train/placement.py``'s GSPMD placements), its ``--zero`` LM step
and ``remat``, against the JAX package's.

- GPT's placements on JAX's shapes (gpt_small and the test geometry;
  grids (4, 1), (2, 2) and (1, 4); plain, ``zero1`` and ``fsdp``): each
  leaf's split axes are those of JAX's ``state_shardings`` and each
  rank's bytes JAX's per-device bytes. gpt_small's vocab of 50257 is
  odd, so its head stays whole and its embedding splits ``D``; the GPT
  keeps flax's ``[in, out]`` Dense layout (its own
  ``jax_to_torch_dims``), so the trailing rule splits each Dense's
  output features, as in JAX;
- 3-step f32 trajectories of ``tp``, ``tp --zero1`` and ``tp --fsdp``
  on (1, 2) and (2, 2) grids of gloo ranks against JAX's
  ``make_lm_train_step_tp`` on the same mesh of virtual devices, with
  the tp eval step (``tests/mp_cases.py``): losses, params and eval
  within 1e-5; every rank's resident bytes are the plan's;
- ``--zero`` on the dp step against JAX's ``make_lm_train_step(
  zero=True)`` at 2 and 4 ranks, within 1e-5;
- ``remat`` equal to no remat, bit for bit, on the tp and dp steps.
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
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.train import placement

import mp_cases

GRIDS = [(4, 1), (2, 2), (1, 4)]
MODES = {"plain": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
TP_GRIDS = [(1, 2), (2, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(name):
    if name == "gpt_small":
        return jax_models.get_model("gpt_small"), get_model("gpt_small")
    return jax_models.GPT(**mp_cases.GEOM), GPT(**mp_cases.GEOM)


def _by_path(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", ["gpt_small", "tiny"])
def test_gpt_placement_matches_state_shardings(name, grid, mode):
    jmodel, port = _models(name)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, 8), jnp.int32))["params"]
    mesh = make_mesh(*grid, devices=jax.devices()[:grid[0] * grid[1]])
    state = JaxTrainState(
        params=shapes, batch_stats={},
        opt_state=jax_optim.OptState(
            momentum=shapes, count=np.zeros((), np.int32),
            initialized=np.zeros((), np.bool_)),
        epoch=np.ones((), np.int32))
    sh = jax_step.state_shardings(state, mesh, **MODES[mode])
    ours = placement.plan_placement(port, *grid, **MODES[mode])
    for leaves, tree in ((ours.params, sh.params),
                         (ours.opt, sh.opt_state.momentum)):
        ref = _by_path(tree)
        assert len(leaves) == len(ref)
        for leaf in leaves:
            spec = tuple(ref[leaf.name.replace(".", "/")].spec)
            assert leaf.spec == spec + (None,) * (len(leaf.shape)
                                                  - len(spec)), leaf.name
    placed = jax.tree.map(
        lambda s, n: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=n),
        state, sh)
    nbytes = ours.resident_bytes()
    assert nbytes["params"] == hbm.tree_shard_nbytes(placed.params)
    assert nbytes["opt_state"] == hbm.tree_shard_nbytes(
        placed.opt_state.momentum)
    assert nbytes["batch_stats"] == 0
    if name == "gpt_small" and grid[1] > 1 and mode == "plain":
        spec = {leaf.name: leaf.spec for leaf in ours.params}
        assert spec["head.kernel"] == (None, None)  # 50257 is odd
        assert spec["embed"] == (None, "model")
        assert spec["block_0.attn.wqkv.kernel"] == (None, "model")
        assert spec["block_0.fc2.kernel"] == (None, "model")


@pytest.fixture(scope="module")
def init():
    return mp_cases.jax_init()


def _runs(grid):
    runs = {f"{mode}_{grid[0]}x{grid[1]}": dict(kind="tp", grid=grid, **kw)
            for mode, kw in mp_cases.TP_MODES.items()}
    world = grid[0] * grid[1]
    runs[f"zero_{world}"] = dict(kind="dp", grid=(world, 1), zero=True)
    if world == 2:
        runs["tp_remat_1x2"] = dict(kind="tp", grid=grid, remat=True)
        runs["dp_2"] = dict(kind="dp", grid=(2, 1))
        runs["dp_remat_2"] = dict(kind="dp", grid=(2, 1), remat=True)
    return runs


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    out = {}
    for grid in TP_GRIDS:
        ranks = mp_cases.port_run(grid[0] * grid[1], _runs(grid), *init,
                                  tmp_path_factory.mktemp("tp"))
        for key in ranks[0]:
            out[key] = [rank[key] for rank in ranks]
    return out


@pytest.mark.parametrize("mode", list(mp_cases.TP_MODES))
@pytest.mark.parametrize("grid", TP_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_tp_trajectory_matches_jax(port, init, grid, mode):
    ranks = port[f"{mode}_{grid[0]}x{grid[1]}"]
    mp_cases.check_run(ranks[0], mp_cases.jax_tp(grid, mode, *init))
    plan = placement.plan_placement(
        GPT(**mp_cases.GEOM), *grid, **mp_cases.TP_MODES[mode])
    for rank in ranks:
        assert rank["resident"] == plan.resident_bytes()


@pytest.mark.parametrize("world", [2, 4])
def test_zero_matches_jax(port, init, world):
    ranks = port[f"zero_{world}"]
    mp_cases.check_run(ranks[0], mp_cases.jax_zero(world, *init))
    n = sum(int(np.prod(t.shape)) for t in ranks[0]["params"].values())
    for rank in ranks:  # the moments: one shard of the padded buckets
        assert rank["resident"]["opt_state"] < 4 * n // world + 4 * world


@pytest.mark.parametrize("kind", ["tp_1x2", "dp_2"])
def test_remat_equals_no_remat(port, kind):
    plain = port[kind][0]
    remat = port[kind.replace("_", "_remat_", 1)][0]
    assert remat["losses"] == plain["losses"]
    for name, t in plain["params"].items():
        assert torch.equal(remat["params"][name], t), name


def test_zero_equals_plain_dp(port):
    """``--zero``'s sharded update on the same reduced gradients as the
    plain all-reduce: the same trajectory within f32 rounding of the two
    reductions."""
    a, b = port["zero_2"][0], port["dp_2"][0]
    np.testing.assert_allclose(a["losses"], b["losses"], atol=1e-6, rtol=0)
    for name, t in a["params"].items():
        torch.testing.assert_close(t, b["params"][name], atol=1e-6, rtol=0,
                                   msg=name)


def test_chip_smoke_mp_resident_bytes_are_jax_bytes():
    """``chip_smoke.py``'s ``MP_JAX_RESIDENT`` (it cannot import JAX):
    each entry is JAX's per-device bytes of gpt_small's params and one
    moment tree under its placement on that mesh (pp: the stacked tree
    by ``pipeline_specs``; tp: ``state_shardings``; dp: replicated), and
    the port's own bytes on that grid."""
    import importlib.util
    import os

    from jax.sharding import Mesh, NamedSharding

    from pytorch_multiprocessing_distributed_tpu.parallel import (
        gpt_pipeline as jgp)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jmodel, port = _models("gpt_small")
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, 8), jnp.int32))["params"]
    dense = sum(int(np.prod(s.shape)) * 4 for s in jax.tree.leaves(shapes))
    for (kind, mode, data, deg), want in smoke.MP_JAX_RESIDENT.items():
        if kind == "dp":
            assert want == (dense, dense)
            continue
        if kind == "pp":
            stacked = jax.eval_shape(
                lambda p: jgp.stack_pipeline_params(p, deg), shapes)
            mesh = Mesh(np.asarray(jax.devices()[:data * deg]).reshape(
                data, deg), ("data", "pipe"))
            placed = jax.tree.map(
                lambda s, p: jax.ShapeDtypeStruct(
                    s.shape, s.dtype, sharding=NamedSharding(mesh, p)),
                stacked, jgp.pipeline_specs(stacked))
            nbytes = hbm.tree_shard_nbytes(placed)
            assert want == (nbytes, nbytes), (kind, mode, data, deg)
            stage = gp.stage_model(port, deg)
            ours = 4 * sum(p.numel() for p in stage.parameters())
            assert want == (ours, ours)
            continue
        mesh = make_mesh(data, deg, devices=jax.devices()[:data * deg])
        state = JaxTrainState(
            params=shapes, batch_stats={},
            opt_state=jax_optim.OptState(
                momentum=shapes, count=np.zeros((), np.int32),
                initialized=np.zeros((), np.bool_)),
            epoch=np.ones((), np.int32))
        sh = jax_step.state_shardings(state, mesh, **MODES[mode])
        placed = jax.tree.map(
            lambda s, n: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=n),
            state, sh)
        assert want == (hbm.tree_shard_nbytes(placed.params),
                        hbm.tree_shard_nbytes(placed.opt_state.momentum))
        ours = placement.plan_placement(port, data, deg,
                                        **MODES[mode]).resident_bytes()
        assert want == (ours["params"], ours["opt_state"])
