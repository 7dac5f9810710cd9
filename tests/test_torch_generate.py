"""The port's cached generation against the JAX package's, in f32.

``_prefill`` activations and caches, and one decode horizon with the
on-device freeze gates (a row stopping on eos and one on its budget
mid-horizon, a frozen row whose position lies beyond the window), are
held against JAX at atol 1e-5 on the same carried weights (caches and
activations) and exactly on tokens and slot state. Greedy ``generate``
is token-exact with JAX ``generate`` on the serving tests' model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference import (
    generate as jax_generate)
from pytorch_multiprocessing_distributed_tpu.inference.generate import (
    _decode_horizon as jax_decode_horizon, _prefill as jax_prefill,
    _sample as jax_sample)
from pytorch_multiprocessing_distributed_tpu.serving import (
    init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.inference.generate import (
    _decode_horizon, _filter_logits, _prefill)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

# the serving tests' `_tiny` model (tests/test_serving.py)
GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, 1)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    return jmodel, jparams, model


def _np(t):
    return np.asarray(t)


def test_prefill_matches_jax(pair):
    jmodel, jparams, model = pair
    prompt = np.random.default_rng(1).integers(0, 61, (2, 9))
    jx, jk, jv = jax_prefill(jmodel, jparams, jnp.asarray(prompt), 16)
    x, k, v = _prefill(model, torch.from_numpy(prompt), 16)
    assert tuple(k.shape) == (2, 2, 16, 2, 16)
    for got, ref in ((x, jx), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5,
                                   rtol=0)


def test_decode_horizon_with_freeze_gates_matches_jax(pair):
    """Four slots, window 16 of s_max 32, horizon 5: row 0 stops on its
    eos token at step 2, row 1 on a budget of 2, row 2 runs through,
    row 3 is frozen at position 20 (beyond the window)."""
    jmodel, jparams, model = pair
    prompt = np.random.default_rng(2).integers(0, 61, (4, 8))
    _, jk, jv = jax_prefill(jmodel, jparams, jnp.asarray(prompt), 32)
    positions = np.array([8, 5, 7, 20], np.int32)
    last = np.array([3, 14, 15, 9], np.int32)
    active = np.array([True, True, True, False])
    keys = jnp.zeros((5, 2), jnp.uint32)

    def run_jax(remaining, eos):
        return jax_decode_horizon(
            jmodel, jparams, jk, jv, jnp.asarray(positions),
            jnp.asarray(last), jnp.asarray(active),
            jnp.asarray(remaining), jnp.asarray(eos), keys, window=16,
            attn_impl="xla")

    # an ungated run tells which token row 0 emits at step 2
    free, _ = run_jax(np.full(4, 99, np.int32), np.full(4, -1, np.int32))
    remaining = np.array([99, 2, 99, 0], np.int32)
    eos = np.array([int(free[1, 0]), -1, -1, -1], np.int32)
    jtok, (jkc, jvc, jpos, jlast, jact, jrem) = run_jax(remaining, eos)

    k = torch.from_numpy(np.array(jk))
    v = torch.from_numpy(np.array(jv))
    tok, (pos, lst, act, rem) = _decode_horizon(
        model, k, v, torch.from_numpy(positions), torch.from_numpy(last),
        torch.from_numpy(active), torch.from_numpy(remaining),
        torch.from_numpy(eos), 5, window=16)
    np.testing.assert_array_equal(tok.numpy(), _np(jtok))
    assert (tok.numpy()[2:, 0] == -1).all() and (tok.numpy()[2:, 1] == -1
                                                 ).all()
    assert (tok.numpy()[:, 3] == -1).all()
    for got, ref in ((pos, jpos), (lst, jlast), (act, jact), (rem, jrem)):
        np.testing.assert_array_equal(got.numpy(), _np(ref))
    # caches were written in place, column by column, like JAX's
    np.testing.assert_allclose(k.numpy(), _np(jkc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), _np(jvc), atol=1e-5, rtol=0)


def test_greedy_generate_token_exact_with_jax(pair):
    jmodel, jparams, model = pair
    rng = np.random.default_rng(0)
    for n in (3, 7, 12, 5, 9):
        prompt = rng.integers(0, 61, (1, n))
        ref = jax_generate(jmodel, jparams, jnp.asarray(prompt),
                           max_new_tokens=6)
        got = generate(model, torch.from_numpy(prompt), max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), _np(ref),
                                      err_msg=f"prompt len {n}")


def test_sampled_generate_is_seeded_and_in_vocab(pair):
    """Sampling draws from the caller's generator: the same seed gives
    the same stream; top-k keeps tokens among the k best."""
    _, _, model = pair
    prompt = torch.tensor([[1, 2, 3]])

    def draw(seed):
        return generate(model, prompt, max_new_tokens=8, temperature=0.8,
                        top_k=5, top_p=0.9,
                        generator=torch.Generator().manual_seed(seed))

    a, b = draw(4), draw(4)
    assert torch.equal(a, b)
    assert a.shape == (1, 11) and int(a.max()) < 61
    with pytest.raises(ValueError, match="generator"):
        generate(model, prompt, max_new_tokens=2, temperature=1.0)


@pytest.mark.parametrize("top_k, top_p", [(5, 0.0), (0, 0.7), (10, 0.8)])
@pytest.mark.parametrize("near_uniform", [False, True])
def test_sampling_kept_set_matches_jax(top_k, top_p, near_uniform):
    """The set of tokens the port's ``_sample`` may draw (the finite
    entries of ``_filter_logits``) against JAX ``_sample``'s draws over a
    vocabulary of 61: the union of 4000 JAX draws lies inside the port's
    kept set, and equals it where the kept probabilities are near
    uniform (then every kept token is drawn with near certainty)."""
    rng = np.random.default_rng(11 + top_k)
    scale = 0.01 if near_uniform else 2.0
    logits = (rng.normal(size=(1, 61)) * scale).astype(np.float32)
    kept = torch.isfinite(_filter_logits(torch.from_numpy(logits), 0.7,
                                         top_k, top_p))[0]
    kept = set(np.flatnonzero(kept.numpy()).tolist())
    draws = jax_sample(jnp.asarray(np.repeat(logits, 4000, axis=0)), 0.7,
                       top_k, top_p, jax.random.PRNGKey(3))
    drawn = set(np.asarray(draws).tolist())
    assert drawn <= kept
    if top_k:
        assert len(kept) <= top_k
    if near_uniform:
        assert drawn == kept
