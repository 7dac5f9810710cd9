"""The port's data-parallel LM step on a Mixture-of-Experts GPT against
the JAX package's ``make_lm_train_step``, in one process (gpt_tiny's
vocab, 2 layers, D 32, 2 heads, mlp 64, 4 experts; ``[4, 16]``
batches; JAX's attention ``"xla"``, the port's flash wrapper, the same
math on the CPU).

Plain, ``grad_accum=2`` (the balance and z losses averaged over the
microbatches, the objective's share divided by them), ``vocab_chunks=5``
(the streamed head beside the MoE losses) and ``remat`` (the MoE layers
recomputed in the backward), top-1 and top-2: losses, balance losses
and every param after 3 f32 SGD steps within 1e-5 of JAX's; ``remat``
equals the plain step bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, make_lm_train_step, sgd)

import mp_cases

CASE = mp_cases.MOE
TOL = 1e-5
KW = {"plain": {}, "grad_accum": {"grad_accum": 2},
      "vocab_chunks": {"vocab_chunks": 5}, "remat": {"remat": True}}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return mp_cases.jax_init(CASE)


def _port(params, batches, top_k, **kw):
    model = GPT(**CASE["geom"], moe_top_k=top_k)
    state = create_lm_train_state(model, from_jax_params(params))
    step = make_lm_train_step(model, sgd(mp_cases.LR), **kw)
    losses, aux = [], []
    for b in batches:
        _, m = step(state, torch.from_numpy(b))
        losses.append(float(m["loss"]))
        aux.append(float(m["moe_aux"]))
    return losses, aux, state.views(state.params)


@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
@pytest.mark.parametrize("kind", list(KW))
def test_moe_dp_trajectory_matches_jax(init, kind, top_k):
    params, batches = init
    model = jax_models.GPT(**CASE["geom"], moe_top_k=top_k, attn_impl="xla")
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt = jax_optim.sgd(mp_cases.LR)
    state = jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, CASE["seq"]), jnp.int32),
        opt)
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    step = jax_lm.make_lm_train_step(model, opt, mesh, **KW[kind])
    state, jlosses, jaux = mp_cases.jax_steps(step, state, batches)
    losses, aux, ours = _port(params, batches, top_k, **KW[kind])
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, atol=TOL, rtol=0)
    want = from_jax_params(jax.device_get(state.params))
    assert set(ours) == set(want)
    for name, t in ours.items():
        torch.testing.assert_close(t, want[name], atol=TOL, rtol=0,
                                   msg=name)


def test_moe_remat_equals_plain_bit_for_bit(init):
    plain = _port(*init, 1)
    remat = _port(*init, 1, remat=True)
    assert plain[:2] == remat[:2]
    for name, t in plain[2].items():
        assert torch.equal(remat[2][name], t), name
