"""The shared case of the model-parallel LM tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_pipeline_grid.py``
and ``tests/test_torch_lm_tp.py``): a 2-layer GPT (gpt_tiny's vocab of
257, which no grid here divides, 32 wide, 4 heads) in f32 from
JAX-initialised params, 3 SGD steps on numpy batches, through the JAX
package's pipelined, tensor-parallel and ``--zero`` steps on a mesh of
the conftest's virtual CPU devices and through the port's on the same
grid of gloo ranks (``tests/torch_mp_worker.py``). JAX's references run
with ``attn_impl="xla"``, as its CLI runs ``tp`` and ``pp`` (its
pipelined steps force it); the port runs its flash wrapper, whose plain
version is the same math on the CPU. ``MOE`` is the Mixture-of-Experts
case (``tests/test_torch_moe_mp.py``): 2 heads, 4 top-1 experts,
``[4, 16]`` batches, its balance loss compared too."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.parallel import gpt_pipeline as jgp
from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.parallel.zero import (
    zeroify_state)
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from sp_cases import free_port
from torch_mp_worker import grads_rank, steps_rank

GEOM = dict(vocab_size=257, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=4, mlp_dim=64)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 0.1
TOL = 1e-5  # loss and every param after 3 f32 steps (PR 19's)
TP_MODES = {"tp": {}, "tp_zero1": {"zero1": True}, "tp_fsdp": {"fsdp": True}}
DENSE = dict(geom=GEOM, seq=SEQ, batch=BATCH)
MOE = dict(geom=dict(GEOM, num_heads=2, n_experts=4), seq=16, batch=4)


def jax_init(case=DENSE):
    """(JAX-initialised params, ``[STEPS, batch, seq]`` int32 batches)."""
    model = jax_models.GPT(**case["geom"])
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        jax_optim.sgd(LR)).params)
    batches = np.random.default_rng(1).integers(
        0, 257, (STEPS, case["batch"], case["seq"])).astype(np.int32)
    return params, batches


def jax_steps(step, state, batches):
    """(state, losses, balance losses) of JAX's step over ``batches``."""
    losses, aux = [], []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        losses.append(float(m["loss"]))
        if "moe_aux" in m:
            aux.append(float(m["moe_aux"]))
    return state, losses, aux


def _mesh(grid, names):
    dp, deg = grid
    return Mesh(np.asarray(jax.devices()[:dp * deg]).reshape(dp, deg),
                names)


def jax_pp(grid, schedule, params, batches, case=DENSE):
    """JAX's pipelined losses, final (unstacked) params, eval loss and
    (MoE) balance losses."""
    geom = case["geom"]
    model = jax_models.GPT(**geom)
    mesh = _mesh(grid, ("data", "pipe"))
    opt = jax_optim.sgd(LR)
    state = jgp.create_pipelined_lm_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        opt, n_stages=grid[1], params=params)
    step = jgp.make_pipelined_lm_train_step(model, opt, mesh,
                                            schedule=schedule)
    state, losses, aux = jax_steps(step, state, batches)
    ev = float(jgp.make_pipelined_lm_eval_step(model, mesh)(
        state, jnp.asarray(batches[0]))["loss"])
    return losses, jgp.unstack_pipeline_params(
        jax.device_get(state.params), geom["vocab_size"]), ev, aux


def jax_tp(grid, mode, params, batches, remat=False, case=DENSE):
    """JAX's GSPMD LM losses, final params, eval loss and (MoE) balance
    losses."""
    kw = TP_MODES[mode]
    model = jax_models.GPT(**case["geom"], attn_impl="xla")
    mesh = make_mesh(*grid, devices=jax.devices()[:grid[0] * grid[1]])
    opt = jax_optim.sgd(LR)
    state = jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        opt)
    state = jax_step.shard_state(
        state.replace(params=jax.tree.map(jnp.asarray, params)), mesh, **kw)
    step = jax_lm.make_lm_train_step_tp(model, opt, mesh, remat=remat, **kw)
    state, losses, aux = jax_steps(step, state, batches)
    ev = float(jax_lm.make_lm_eval_step_tp(model, mesh, **kw)(
        state, jnp.asarray(batches[0]))["loss"])
    return losses, jax.device_get(state.params), ev, aux


def jax_zero(world, params, batches, case=DENSE):
    """JAX's ``make_lm_train_step(zero=True)`` losses and params on a
    data mesh of ``world`` devices, its eval loss and (MoE) balance
    losses."""
    model = jax_models.GPT(**case["geom"], attn_impl="xla")
    mesh = make_mesh(world, devices=jax.devices()[:world])
    opt = jax_optim.sgd(LR)
    state = jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        opt)
    state = zeroify_state(
        state.replace(params=jax.tree.map(jnp.asarray, params)), mesh)
    step = jax_lm.make_lm_train_step(model, opt, mesh, zero=True)
    state, losses, aux = jax_steps(step, state, batches)
    ev = float(jax_lm.make_lm_eval_step(model, mesh)(
        state, jnp.asarray(batches[0]))["loss"])
    return losses, jax.device_get(state.params), ev, aux


def port_run(world, runs, params, batches, tmp, case=DENSE):
    """Every run of ``runs`` (``{name: {kind, grid, ...}}``) on ``world``
    gloo ranks (one spawn); rank 0's results, after checking every rank
    holds the same whole state."""
    path, out = tmp / "inputs.pt", tmp / "out"
    runs = {name: dict(run, lr=LR) for name, run in runs.items()}
    torch.save({"geometry": case["geom"], "runs": runs,
                "params": from_jax_params(params),
                "batches": torch.from_numpy(batches)}, path)
    mp.spawn(steps_rank, args=(world, free_port(), str(path), str(out)),
             nprocs=world, join=True)
    ranks = [torch.load(f"{out}.{r}", weights_only=True)
             for r in range(world)]
    for other in ranks[1:]:
        for key, run in other.items():
            assert run["losses"] == ranks[0][key]["losses"], key
            for name, t in run["params"].items():
                assert torch.equal(t, ranks[0][key]["params"][name]), name
    return ranks


def port_grads(grid, params, tokens, tmp):
    """The port's GPipe CE sum and stacked data-summed gradients
    (``torch_mp_worker.grads_rank``), every rank's."""
    path, out = tmp / "grads_inputs.pt", tmp / "grads"
    torch.save({"geometry": GEOM, "grid": grid,
                "params": from_jax_params(params), "tokens": tokens}, path)
    world = grid[0] * grid[1]
    mp.spawn(grads_rank, args=(world, free_port(), str(path), str(out)),
             nprocs=world, join=True)
    return [torch.load(f"{out}.{r}", weights_only=True)
            for r in range(world)]


def check_run(ours, ref, case=DENSE):
    """The port's run within TOL of JAX's ``(losses, params, eval,
    balance losses)``."""
    losses, jparams, jeval, aux = ref
    np.testing.assert_allclose(ours["losses"], losses, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours["aux"], aux, atol=TOL, rtol=0)
    want = from_jax_params(jparams)
    assert set(ours["params"]) == set(want)
    for name, t in ours["params"].items():
        torch.testing.assert_close(t, want[name], atol=TOL, rtol=0,
                                   msg=name)
    assert abs(ours["eval"] - jeval) < TOL
    assert ours["count"] == case["batch"] * (case["seq"] - 1)
