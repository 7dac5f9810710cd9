"""The port's pipelined LM step (``parallel/pipeline.py`` and
``parallel/gpt_pipeline.py``) against the JAX package's, on a (data 1,
pipe 2) grid.

- ``stack_pipeline_params`` and ``unstack_pipeline_params`` against
  JAX's, bit for bit, at 1, 2 and 4 stages, with and without a head
  bias (257 vocab rows: every cut pads), and each stage's slice carried
  from JAX's stacked tree (``from_jax_pipeline_params``);
- the GPipe objective's vocab-parallel CE sum and the gradients of
  ``ce_sum / count`` against JAX's ``value_and_grad`` of its
  ``forward_ce`` inside ``shard_map``, within 1e-5;
- 3-step f32 trajectories of gpipe and of 1f1b (``tests/mp_cases.py``):
  losses, every param and the eval loss within 1e-5 of JAX's
  ``make_pipelined_lm_train_step``/``make_pipelined_lm_eval_step`` on a
  (1, 2) mesh of the conftest's virtual devices, and gpipe == 1f1b;
- each stage's resident bytes are JAX's per-device bytes of
  ``pipeline_specs``;
- the geometry and batch errors in JAX's words.

The (2, 2) grid is ``tests/test_torch_pipeline_grid.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.parallel import gpt_pipeline as jgp
from pytorch_multiprocessing_distributed_tpu.runtime import hbm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.utils.compat import shard_map
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
    gpt_pipeline as gp)
from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
    make_grid, reset_grid)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params, from_jax_pipeline_params, init_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import sgd

import mp_cases

GRID = (1, 2)
RUNS = {s: {"kind": "pp", "grid": GRID, "schedule": s}
        for s in ("gpipe", "1f1b")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return mp_cases.jax_init()


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return mp_cases.port_run(GRID[0] * GRID[1], RUNS, *init,
                             tmp_path_factory.mktemp("pp12"))


def _jax_params(layers, head_bias, seed=0):
    geom = dict(mp_cases.GEOM, num_layers=layers)
    model = jax_models.GPT(**geom, head_bias=head_bias)
    return jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 8), jnp.int32),
        train=False)["params"])


@pytest.mark.parametrize("head_bias", [True, False])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stack_and_unstack_match_jax(n_stages, head_bias):
    params = _jax_params(4, head_bias)
    dense = from_jax_params(params)
    ours = gp.stack_pipeline_params(dense, n_stages)
    want = from_jax_params(jgp.stack_pipeline_params(params, n_stages))
    assert set(ours) == set(want)
    for key, t in ours.items():
        assert torch.equal(t, want[key]), key
    back = gp.unstack_pipeline_params(ours, mp_cases.GEOM["vocab_size"])
    jback = from_jax_params(jgp.unstack_pipeline_params(
        jgp.stack_pipeline_params(params, n_stages),
        mp_cases.GEOM["vocab_size"]))
    assert set(back) == set(dense) == set(jback)
    for key, t in back.items():
        assert torch.equal(t, dense[key]) and torch.equal(t, jback[key]), key
    # each stage's slice (carried from JAX's stacked tree) and back
    stacked = jgp.stack_pipeline_params(params, n_stages)
    stages = [gp.stage_params(ours, s) for s in range(n_stages)]
    for s, stage in enumerate(stages):
        carried = from_jax_pipeline_params(stacked, s)
        assert set(carried) == set(stage)
        for key, t in stage.items():
            assert torch.equal(carried[key], t), (s, key)
    again = gp.stack_stages(stages)
    for key, t in ours.items():
        assert torch.equal(again[key], t), key
    vs = -(-mp_cases.GEOM["vocab_size"] // n_stages)
    smodel = gp.stage_model(GPT(**dict(mp_cases.GEOM, num_layers=4),
                                head_bias=head_bias), n_stages)
    assert {k: tuple(v.shape) for k, v in stages[0].items()} == {
        k: tuple(v.shape) for k, v in smodel.state_dict().items()}
    assert smodel.vocab_size == vs and smodel.num_layers == 4 // n_stages


def jax_grads(grid, params, tokens):
    """JAX's GPipe ``forward_ce``: the CE sum over the global batch and
    the gradients of ``ce_sum / count`` (stacked, flattened names)."""
    model = jax_models.GPT(**mp_cases.GEOM)
    mesh = mp_cases._mesh(grid, ("data", "pipe"))
    stacked = jgp.stack_pipeline_params(params, grid[1])
    forward_ce = jgp._make_forward_ce(model, "data", "pipe", grid[1])

    def body(p, tok):
        (_, (ce_sum, _, _)), g = jax.value_and_grad(
            forward_ce, has_aux=True)(p, tok)
        return jax.lax.psum(ce_sum, "data"), g

    specs = jgp.pipeline_specs(stacked)
    run = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P("data")),
                            out_specs=(P(), specs)))
    ce, grads = run(stacked, jnp.asarray(tokens))
    return float(ce), from_jax_params(jax.device_get(grads))


def check_grads(grid, init, tmp):
    params, batches = init
    ranks = mp_cases.port_grads(grid, params, batches[0], tmp)
    ce, want = jax_grads(grid, params, batches[0])
    for got in ranks:
        assert abs(got["ce_sum"] - ce) < mp_cases.TOL * abs(ce)
        assert set(got["grads"]) == set(want)
        for key, t in got["grads"].items():
            torch.testing.assert_close(t, want[key], atol=mp_cases.TOL,
                                       rtol=0, msg=key)


def test_vocab_parallel_ce_and_grads_match_jax(init, tmp_path):
    check_grads(GRID, init, tmp_path)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipelined_trajectory_matches_jax(port, init, schedule):
    mp_cases.check_run(port[0][schedule],
                       mp_cases.jax_pp(GRID, schedule, *init))


def test_gpipe_equals_1f1b(port):
    a, b = port[0]["gpipe"], port[0]["1f1b"]
    np.testing.assert_allclose(a["losses"], b["losses"], atol=1e-6, rtol=0)
    for name, t in a["params"].items():
        torch.testing.assert_close(t, b["params"][name], atol=1e-6, rtol=0,
                                   msg=name)
    assert a["eval"] == b["eval"]


def test_every_stage_holds_its_slice(port, init):
    """Each stage's resident bytes are JAX's per-device bytes of its
    ``pipeline_specs`` placement (one resident shard a leaf)."""
    params, _ = init
    mesh = mp_cases._mesh(GRID, ("data", "pipe"))
    stacked = jgp.stack_pipeline_params(params, GRID[1])
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), stacked,
        jgp.pipeline_specs(stacked))
    want = hbm.tree_shard_nbytes(placed)
    for rank in port:
        assert rank["gpipe"]["resident"] == {"params": want,
                                             "opt_state": want}
    dense = sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
    assert want < dense


@pytest.fixture
def one_stage():
    make_grid(1, 1, axis="pipe")
    yield
    reset_grid()


def test_geometry_and_batch_errors_keep_jax_words(one_stage):
    params = _jax_params(2, True)
    dense = from_jax_params(params)
    for n in (3, 4):
        with pytest.raises(ValueError) as ours:
            gp.stack_pipeline_params(dense, n)
        with pytest.raises(ValueError) as theirs:
            jgp.stack_pipeline_params(params, n)
        assert str(ours.value) == str(theirs.value) == (
            f"2 layers not divisible by n_stages={n}")
    with pytest.raises(ValueError, match="not a GPT tree"):
        gp.stack_pipeline_params({"embed": dense["embed"]}, 1)
    model = GPT(**mp_cases.GEOM)
    state = gp.create_pipelined_lm_state(model, init_params(model, 0, "cpu"),
                                         1)
    rows = torch.zeros((4, 8), dtype=torch.int32)
    jmodel = jax_models.GPT(**mp_cases.GEOM)
    mesh = mp_cases._mesh((1, 1), ("data", "pipe"))
    opt = jax_optim.sgd(0.1)
    jstate = jgp.create_pipelined_lm_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32), opt,
        n_stages=1, params=params)
    with pytest.raises(ValueError) as ours:
        gp.make_pipelined_lm_train_step(model, sgd(0.1),
                                        n_microbatches=3)(state, rows)
    with pytest.raises(ValueError) as theirs:
        jgp.make_pipelined_lm_train_step(jmodel, opt, mesh,
                                         n_microbatches=3)(
            jstate, jnp.zeros((4, 8), jnp.int32))
    assert str(ours.value) == str(theirs.value) == (
        "global batch 4 must divide by data axis x n_microbatches = 1 x 3")
    with pytest.raises(ValueError) as ours:
        gp.make_pipelined_lm_eval_step(model, n_microbatches=3)(state, rows)
    assert str(ours.value) == str(theirs.value)
    two = gp.create_pipelined_lm_state(
        GPT(**mp_cases.GEOM), init_params(model, 0, "cpu"), 2, stage=0)
    with pytest.raises(ValueError, match=r"^state was stacked for 2 stages "
                       r"but the mesh 'pipe' axis has 1 — create the state "
                       r"with n_stages matching the mesh$"):
        gp.make_pipelined_lm_train_step(model, sgd(0.1))(two, rows)
    for bad in ("interleaved", "GPipe"):
        with pytest.raises(ValueError) as ours:
            gp.make_pipelined_lm_train_step(model, sgd(0.1), schedule=bad)
        with pytest.raises(ValueError) as theirs:
            jgp.make_pipelined_lm_train_step(jmodel, opt, mesh,
                                             schedule=bad)
        assert str(ours.value) == str(theirs.value)


def test_stacked_checkpoint_round_trips(one_stage, init):
    """A pipelined state's payload is JAX's stacked tree (params and
    momentum under ``params/`` and ``opt_state/momentum/``) and loads
    back bit for bit; a dense payload is refused by name."""
    params, batches = init
    model = GPT(**mp_cases.GEOM)
    state = gp.create_pipelined_lm_state(model, from_jax_params(params), 1)
    step = gp.make_pipelined_lm_train_step(model, sgd(0.1))
    step(state, torch.from_numpy(batches[0]))
    payload = state.gathered().to_dict()
    want = jgp.stack_pipeline_params(params, 1)
    flat = {"params/" + k.replace(".", "/"): tuple(v.shape)
            for k, v in from_jax_params(want).items()}
    assert {k: tuple(v.shape) for k, v in payload.items()
            if k.startswith("params/")} == flat
    other = gp.create_pipelined_lm_state(GPT(**mp_cases.GEOM),
                                         from_jax_params(params), 1)
    other.load_dict(payload)
    assert torch.equal(other.params, state.params)
    assert torch.equal(other.momentum, state.momentum)
    assert int(other.count) == 1 and other.epoch == state.epoch
    dense = {"params/" + k.replace(".", "/"): v
             for k, v in from_jax_params(params).items()}
    with pytest.raises(ValueError, match="not in the pipelined"):
        other.load_dict(dense)
