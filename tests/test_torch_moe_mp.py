"""The port's pipelined, tensor-parallel and ``--zero`` LM steps on a
Mixture-of-Experts GPT against the JAX package's, on gloo ranks
(``tests/mp_cases.py``'s ``MOE`` case: 2 layers, 2 heads, 4 top-1
experts at capacity factor 1.0, ``[4, 16]`` batches), and the MoE
leaves' placements.

- pp (gpipe and 1f1b) at (1, 2): each stage sums its layers' balance
  and z losses over its microbatches (1F1B's rematerialized forward
  counts once), the objective takes their layer and microbatch mean;
  each microbatch routes its own rows, as in JAX;
- tp at (1, 2) with ``--zero1``: the expert leaves split on JAX's
  trailing dims (``w1``/``b1`` on ``H``, ``w2``/``b2`` on ``D``, the
  router on ``E``); tp at (2, 1): the global batch's balance and z
  losses from two data indices' rows;
- ``--zero`` on the dp step at 2 ranks (a per-shard balance loss
  averaged over the shards);

each against JAX's on the same mesh of virtual devices: losses, balance
losses, every param after 3 f32 SGD steps and the eval loss within
1e-5. The placements of gpt_small with 8 experts and of the test model
equal JAX's ``state_shardings``, leaf for leaf and byte for byte, and
the MoE leaves stack into JAX's pipelined tree and carry across from
it (``from_jax_params``, ``from_jax_pipeline_params``) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.parallel import gpt_pipeline as jgp
from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.runtime import hbm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
    gpt_pipeline as gp)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params, from_jax_pipeline_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import placement

import mp_cases

MOE = mp_cases.MOE
RUNS = {"pp_gpipe": dict(kind="pp", grid=(1, 2), schedule="gpipe"),
        "pp_1f1b": dict(kind="pp", grid=(1, 2), schedule="1f1b"),
        "tp_zero1": dict(kind="tp", grid=(1, 2), zero1=True),
        "tp_2x1": dict(kind="tp", grid=(2, 1)),
        "zero_2": dict(kind="dp", grid=(2, 1), zero=True)}
MODES = {"plain": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return mp_cases.jax_init(MOE)


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return mp_cases.port_run(2, RUNS, *init, tmp_path_factory.mktemp("moe"),
                             MOE)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_moe_pipelined_trajectory_matches_jax(port, init, schedule):
    ours = port[0][f"pp_{schedule}"]
    assert len(ours["aux"]) == mp_cases.STEPS
    mp_cases.check_run(ours, mp_cases.jax_pp((1, 2), schedule, *init, MOE),
                       MOE)


def test_moe_tp_zero1_trajectory_matches_jax(port, init):
    mp_cases.check_run(port[0]["tp_zero1"], mp_cases.jax_tp(
        (1, 2), "tp_zero1", *init, case=MOE), MOE)
    plan = placement.plan_placement(GPT(**MOE["geom"]), 1, 2, zero1=True)
    for rank in port:
        assert rank["tp_zero1"]["resident"] == plan.resident_bytes()


def test_moe_tp_global_statistics_match_jax(port, init):
    """tp on a (2, 1) grid: each data index routes its rows, and the
    balance and z losses are the global batch's (JAX's GSPMD step), the
    router statistics summed over ``data``."""
    mp_cases.check_run(port[0]["tp_2x1"], mp_cases.jax_tp(
        (2, 1), "tp", *init, case=MOE), MOE)


def test_moe_zero_matches_jax(port, init):
    mp_cases.check_run(port[0]["zero_2"],
                       mp_cases.jax_zero(2, *init, MOE), MOE)


def _models(name):
    if name == "gpt_small_moe":
        return (jax_models.get_model("gpt_small", n_experts=8),
                get_model("gpt_small", n_experts=8))
    return jax_models.GPT(**MOE["geom"]), GPT(**MOE["geom"])


def _by_path(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", [(2, 2), (1, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", ["gpt_small_moe", "tiny_moe"])
def test_moe_placement_matches_state_shardings(name, grid, mode):
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
    if name == "gpt_small_moe" and grid == (1, 4) and mode == "plain":
        spec = {leaf.name: leaf.spec for leaf in ours.params}
        assert spec["block_0.moe.w1"] == (None, None, "model")
        assert spec["block_0.moe.b2"] == (None, "model")
        assert spec["block_0.moe.gate"] == (None, "model")


def test_chip_smoke_moe_resident_bytes_are_jax_bytes():
    """``chip_smoke.py``'s ``MOE_JAX_RESIDENT`` (it cannot import JAX):
    JAX's per-device bytes of gpt_small with 8 experts, params and one
    moment tree, under ``state_shardings`` on each mesh it names, and
    the port's own bytes there."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jmodel, port = _models("gpt_small_moe")
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, 8), jnp.int32))["params"]
    assert smoke.MOE_JAX_RESIDENT
    for (mode, data, deg), want in smoke.MOE_JAX_RESIDENT.items():
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


@pytest.mark.parametrize("n_stages", [1, 2])
def test_moe_leaves_stack_and_carry_like_jax(init, n_stages):
    params, _ = init
    dense = from_jax_params(params)
    assert {k for k in dense if ".moe." in k} == {
        f"block_{i}.moe.{leaf}" for i in range(2)
        for leaf in ("gate", "w1", "b1", "w2", "b2")}
    model = GPT(**MOE["geom"])
    assert {k: tuple(v.shape) for k, v in dense.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    ours = gp.stack_pipeline_params(dense, n_stages)
    jstacked = jgp.stack_pipeline_params(params, n_stages)
    want = from_jax_params(jstacked)
    assert set(ours) == set(want)
    for key, t in ours.items():
        assert torch.equal(t, want[key]), key
    assert tuple(ours["blocks.moe.w1"].shape) == (n_stages, 2 // n_stages,
                                                  4, 32, 64)
    back = gp.unstack_pipeline_params(ours, MOE["geom"]["vocab_size"])
    for key, t in dense.items():
        assert torch.equal(back[key], t), key
    smodel = gp.stage_model(model, n_stages)
    for s in range(n_stages):
        carried = from_jax_pipeline_params(jstacked, s)
        assert {k: tuple(v.shape) for k, v in carried.items()} == {
            k: tuple(v.shape) for k, v in smodel.state_dict().items()}
        for key, t in gp.stage_params(ours, s).items():
            assert torch.equal(carried[key], t), (s, key)
