"""The shared case of ``tests/test_torch_sp_train.py`` and
``tests/test_torch_sp_grid.py``: a 1-layer GPT (gpt_tiny's vocab, 32
wide, 4 heads) in f32 from JAX-initialised params, 3 SGD steps on
numpy batches, through JAX's ``make_lm_train_step(seq_axis="seq")`` on
a ``(data, seq)`` mesh of the conftest's virtual CPU devices (Pallas in
interpret mode) and through the port's on the same grid of gloo ranks
(``tests/torch_sp_worker.py``). JAX's SP steps run slowly here (seconds
a step in interpret mode), so each file takes one grid. ``MOE`` is the
Mixture-of-Experts case (``tests/test_torch_moe_sp.py``): 2 layers, 2
heads, 4 experts, ``[4, 16]`` batches, its balance loss compared too."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from torch_sp_worker import lm_rank

GEOM = dict(vocab_size=257, max_seq_len=64, hidden_size=32, num_layers=1,
            num_heads=4, mlp_dim=64)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 0.1
TOL = 1e-5
DENSE = dict(geom=GEOM, seq=SEQ, batch=BATCH)
MOE = dict(geom=dict(GEOM, num_layers=2, num_heads=2, n_experts=4), seq=16,
           batch=4)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_init(case=DENSE):
    """(JAX-initialised params, ``[STEPS, batch, seq]`` int32 batches)."""
    model = jax_models.GPT(**case["geom"])
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        jax_optim.sgd(LR)).params)
    batches = np.random.default_rng(1).integers(
        0, 257, (STEPS, case["batch"], case["seq"])).astype(np.int32)
    return params, batches


def jax_run(grid, mode, chunks, params, batches, evaluate, case=DENSE):
    """JAX's losses, final params, (``evaluate``) eval loss and (MoE)
    balance losses."""
    dp, deg = grid
    model = jax_models.GPT(**case["geom"], seq_axis="seq", sp_mode=mode)
    mesh = Mesh(np.asarray(jax.devices()[:dp * deg]).reshape(dp, deg),
                ("data", "seq"))
    opt = jax_optim.sgd(LR)
    state = jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, case["seq"]), jnp.int32),
        opt)
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    step = jax_lm.make_lm_train_step(model, opt, mesh, seq_axis="seq",
                                     vocab_chunks=chunks)
    losses, aux = [], []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        losses.append(float(m["loss"]))
        if "moe_aux" in m:
            aux.append(float(m["moe_aux"]))
    ev = None
    if evaluate:
        ev = float(jax_lm.make_lm_eval_step(
            model, mesh, seq_axis="seq", vocab_chunks=chunks)(
                state, jnp.asarray(batches[0]))["loss"])
    return losses, jax.device_get(state.params), ev, aux


def port_run(grid, runs, params, batches, tmp, case=DENSE):
    """Every ``(sp_mode, vocab_chunks)`` of ``runs`` on the grid's gloo
    ranks (one spawn); rank 0's results, after checking every rank
    holds the same state."""
    path, out = tmp / "inputs.pt", tmp / "out"
    torch.save({"grid": grid, "geometry": case["geom"], "lr": LR,
                "runs": runs,
                "params": from_jax_params(params),
                "batches": torch.from_numpy(batches)}, path)
    world = grid[0] * grid[1]
    mp.spawn(lm_rank, args=(world, free_port(), str(path), str(out)),
             nprocs=world, join=True)
    ranks = [torch.load(f"{out}.{r}", weights_only=True)
             for r in range(world)]
    for other in ranks[1:]:
        for key, run in other.items():
            assert run["losses"] == ranks[0][key]["losses"]
            for name, t in run["params"].items():
                assert torch.equal(t, ranks[0][key]["params"][name])
    return ranks[0]


def check_run(ours, grid, mode, chunks, params, batches, evaluate,
              case=DENSE):
    """The port's run within TOL of JAX's: losses, every param, the
    eval loss and (MoE) the balance losses; the global predictable
    count."""
    losses, jparams, jeval, aux = jax_run(grid, mode, chunks, params,
                                          batches, evaluate, case)
    np.testing.assert_allclose(ours["losses"], losses, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours["aux"], aux, atol=TOL, rtol=0)
    ref = from_jax_params(jparams)
    assert set(ours["params"]) == set(ref)
    for name, t in ours["params"].items():
        torch.testing.assert_close(t, ref[name], atol=TOL, rtol=0,
                                   msg=name)
    if evaluate:
        assert abs(ours["eval"] - jeval) < TOL
    assert ours["count"] == case["batch"] * (case["seq"] - 1)
