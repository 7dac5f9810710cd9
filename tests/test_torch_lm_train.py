"""The port's LM train and eval steps against the JAX package's
``make_lm_train_step``/``make_lm_eval_step`` on the same params (carried
with ``from_jax_params``) and the same numpy tokens.

gpt_tiny in f32 (the JAX model through its Pallas flash kernel in
interpret mode, the port through the plain flash versions): losses and
params within 1e-5 after 3 SGD steps — two frameworks' f32 sums in
different orders, seen at ~1e-7. The port at world 2 (gloo, through
``torch.multiprocessing``) and with ``grad_accum=2`` equals the port at
world 1 within 1e-6 (the same math, summed in another order).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, cosine_lr, make_lm_eval_step, make_lm_train_step,
    sgd)
from pytorch_multiprocessing_distributed_tpu_torch.train.lm import (
    _next_token_targets, local_rows)
from pytorch_multiprocessing_distributed_tpu_torch.train.step import (
    strided_microbatches)

from torch_dp_worker import train_rank

SEQ, BATCH, STEPS = 32, 8, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after:
    under the suite's parallel workers, torch's default of one thread
    per core oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(model):
    """A fresh JAX train state (the JAX step donates its input)."""
    return jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32),
        jax_optim.sgd(0.1))


@pytest.fixture(scope="module")
def jax_init():
    model = jax_models.get_model("gpt_tiny")
    params = jax.device_get(_jax_state(model).params)
    rng = np.random.default_rng(1)
    batches = rng.integers(0, 257, (STEPS, BATCH, SEQ)).astype(np.int32)
    return model, params, batches


def _port_run(jax_init, grad_accum=1):
    _, params, batches = jax_init
    model = get_model("gpt_tiny")
    state = create_lm_train_state(model, from_jax_params(params))
    step = make_lm_train_step(model, sgd(0.1), grad_accum=grad_accum)
    losses = [float(step(state, torch.from_numpy(b))[1]["loss"])
              for b in batches]
    return state, losses


def _assert_params(state, jparams, atol):
    ref = from_jax_params(jax.device_get(jparams))
    views = state.views(state.params)
    assert set(views) == set(ref)
    for name, t in views.items():
        torch.testing.assert_close(t, ref[name], atol=atol, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_trajectory_matches_jax(jax_init, n_dev):
    model, _, batches = jax_init
    jstate = _jax_state(model)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    jstep = jax_lm.make_lm_train_step(model, jax_optim.sgd(0.1), mesh)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jnp.asarray(b))
        jlosses.append(float(m["loss"]))
    state, losses = _port_run(jax_init)
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    _assert_params(state, jstate.params, TOL)
    jmom = from_jax_params(jax.device_get(jstate.opt_state.momentum))
    for name, t in state.views(state.momentum).items():
        torch.testing.assert_close(t, jmom[name], atol=TOL, rtol=0)
    assert int(state.count) == int(jstate.opt_state.count) == STEPS
    assert bool(state.initialized)


def test_params_are_trainable_views_updated_in_place(jax_init):
    state, _ = _port_run(jax_init)
    lo, hi = state.params.data_ptr(), state.params.data_ptr() + 4 * state.n
    for name, p in state.model.named_parameters():
        assert p.is_leaf and p.requires_grad, name
        assert lo <= p.data_ptr() < hi, name
        assert state.grads.data_ptr() <= p.grad.data_ptr() < (
            state.grads.data_ptr() + 4 * state.n), name


def test_grad_accum_equals_single_shot(jax_init):
    one, l1 = _port_run(jax_init)
    two, l2 = _port_run(jax_init, grad_accum=2)
    np.testing.assert_allclose(l2, l1, atol=1e-6, rtol=0)
    torch.testing.assert_close(two.params, one.params, atol=1e-6, rtol=0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world2_gloo_equals_world1(jax_init, tmp_path):
    _, params, batches = jax_init
    inputs = tmp_path / "inputs.pt"
    out = tmp_path / "out.pt"
    torch.save({"params": from_jax_params(params),
                "batches": torch.from_numpy(batches), "grad_accum": 1},
               inputs)
    mp.spawn(train_rank, args=(2, _free_port(), str(inputs), str(out)),
             nprocs=2, join=True)
    got = torch.load(out, weights_only=True)
    state, losses = _port_run(jax_init)
    np.testing.assert_allclose(got["losses"], losses, atol=1e-6, rtol=0)
    torch.testing.assert_close(got["params"], state.params, atol=1e-6,
                               rtol=0)
    ev = make_lm_eval_step(state.model)(state, torch.from_numpy(batches[0]))
    assert abs(got["eval"] - float(ev["loss"])) < 1e-6


def test_nan_guard_skips_and_carries_state(jax_init):
    state, _ = _port_run(jax_init)
    with torch.no_grad():
        state.params.mul_(1e20)
    before = (state.params.clone(), state.momentum.clone(),
              int(state.count))
    step = make_lm_train_step(state.model, sgd(0.1))
    _, m = step(state, torch.from_numpy(jax_init[2][0]))
    assert int(m["skipped"]) == 1
    assert torch.equal(state.params, before[0])
    assert torch.equal(state.momentum, before[1])
    assert int(state.count) == before[2]


def test_eval_step_matches_jax(jax_init):
    model, params, batches = jax_init
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    ref = jax_lm.make_lm_eval_step(model, mesh)(_jax_state(model),
                                                jnp.asarray(batches[0]))
    state = create_lm_train_state(get_model("gpt_tiny"),
                                  from_jax_params(params))
    got = make_lm_eval_step(state.model)(state,
                                         torch.from_numpy(batches[0]))
    assert abs(float(got["loss"]) - float(ref["loss"])) < TOL
    assert float(got["count"]) == float(ref["count"]) == BATCH * (SEQ - 1)


def test_next_token_targets_and_microbatches_match_jax():
    tokens = np.arange(24, dtype=np.int32).reshape(6, 4)
    tgt, valid = _next_token_targets(torch.from_numpy(tokens))
    jtgt, jvalid = jax_lm._next_token_targets(jnp.asarray(tokens), None)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(
        strided_microbatches(torch.from_numpy(tokens), 3).numpy(),
        np.asarray(jax_step.strided_microbatches(jnp.asarray(tokens), 3)))
    np.testing.assert_array_equal(local_rows(tokens, 1, 2), tokens[3:])
    with pytest.raises(ValueError, match="divide"):
        local_rows(tokens, 0, 4)


@pytest.mark.parametrize("total,warmup", [(5, 0), (6, 2), (1, 0)])
def test_cosine_lr_matches_jax(total, warmup):
    ours = cosine_lr(0.1, total, warmup_epochs=warmup)
    ref = jax_optim.cosine_lr(0.1, total, warmup_epochs=warmup)
    for epoch in range(1, total + 2):
        assert ours(epoch) == pytest.approx(float(ref(epoch)), abs=1e-8)


def test_cross_entropy_matches_jax():
    from pytorch_multiprocessing_distributed_tpu.ops import losses as jl
    from pytorch_multiprocessing_distributed_tpu_torch.ops import losses

    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, 11)) * 5).astype(np.float32)
    targets = rng.integers(0, 11, 6).astype(np.int32)
    got = losses.cross_entropy_per_sample(torch.from_numpy(logits),
                                          torch.from_numpy(targets))
    ref = jl.cross_entropy_per_sample(jnp.asarray(logits),
                                      jnp.asarray(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert abs(float(losses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets)))
        - float(jl.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(targets)))) < 1e-6


@pytest.mark.parametrize("world", [1, 2, 4])
def test_throughput_is_world_and_per_card(world):
    """The training summaries' rates: ``*_per_sec`` is the world's rate
    (the JAX CLIs' live rate), ``*_per_sec_per_card`` that divided by the
    world size (``train_lm`` and ``main`` both compute them here)."""
    from pytorch_multiprocessing_distributed_tpu_torch.utils import (
        throughput)

    rate, per_card = throughput(8 * 1024 * 21, 2.0, world)
    assert rate == pytest.approx(8 * 1024 * 21 / 2.0)
    assert per_card == pytest.approx(rate / world)
    assert throughput(5, 0.0, world)[0] > 0  # no division by zero
