"""The port's ``beam_search`` against the JAX package's, in f32 on the
CPU: tokens exact, scores within 1e-5, on the same numpy weights
(carried across by ``from_jax_params``).

It repeats JAX's four beam cases (``tests/test_generate.py``): one beam
is greedy ``generate``; a beam per token of an 8-token vocabulary at
depth 2 is exhaustive (the best beam is the brute-forced argmax over all
64 continuations, where equal scores show how ties break); a batch's
rows are independent of each other; one beam on a top-2 MoE model is
greedy. Ties go to the lower index, as ``jax.lax.top_k`` breaks them;
only where two candidates' f32 scores are equal does the port first
take the larger next-token logit, so that one beam stays greedy
decoding through a score that rounds two log-probs together. The checks
speak JAX's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference import (
    beam_search as jax_beam_search)
from pytorch_multiprocessing_distributed_tpu_torch.inference import (
    beam_search, generate)
from pytorch_multiprocessing_distributed_tpu_torch.inference.generate import (
    _top_k)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from serving_tp_cases import _tree

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
TINY_VOCAB = dict(vocab_size=8, max_seq_len=16, hidden_size=32,
                  num_layers=2, num_heads=2, mlp_dim=64)
MOE = dict(GEOM, n_experts=2, moe_top_k=2, moe_capacity_factor=2.0)
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(geometry, seed=1):
    tree = _tree(geometry, seed)
    model = GPT(**geometry)
    model.load_state_dict(from_jax_params(tree), assign=True)
    return jax_models.GPT(attn_impl="xla", **geometry), tree, model


@pytest.fixture(scope="module")
def dense():
    jmodel, tree, model = _pair(GEOM)
    prompt = np.random.default_rng(0).integers(0, GEOM["vocab_size"],
                                               (2, 12))
    return jmodel, tree, model, prompt


def _both(jmodel, tree, model, prompt, new, beams):
    """(port tokens, port scores, JAX tokens, JAX scores) as numpy."""
    toks, scores = beam_search(model, torch.from_numpy(prompt),
                               max_new_tokens=new, beam_size=beams)
    jt, js = jax_beam_search(jmodel, tree, jnp.asarray(prompt),
                             max_new_tokens=new, beam_size=beams)
    return toks.numpy(), scores.numpy(), np.asarray(jt), np.asarray(js)


def _match(got, got_s, want, want_s):
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)


def test_one_beam_is_greedy_and_matches_jax(dense):
    jmodel, tree, model, prompt = dense
    toks, scores, jt, js = _both(jmodel, tree, model, prompt, 6, 1)
    assert toks.shape == (2, 1, 18) and scores.shape == (2, 1)
    _match(toks, scores, jt, js)
    greedy = generate(model, torch.from_numpy(prompt), max_new_tokens=6)
    np.testing.assert_array_equal(toks[:, 0], greedy.numpy())


def test_exhaustive_tiny_vocab_matches_brute_force_and_jax():
    """beam_size = V at depth 2: the best beam is the argmax of all V^2
    continuations' summed log-probs (full forwards), its score theirs;
    the whole beam set and its order are JAX's."""
    jmodel, tree, model = _pair(TINY_VOCAB, seed=2)
    v = TINY_VOCAB["vocab_size"]
    prompt = np.random.default_rng(3).integers(0, v, (1, 4))
    toks, scores, jt, js = _both(jmodel, tree, model, prompt, 2, v)
    assert toks.shape == (1, v, 6)
    assert np.all(np.diff(scores[0]) <= 1e-6)  # best first
    _match(toks, scores, jt, js)
    cands = np.array([[a, c] for a in range(v) for c in range(v)])
    seqs = np.concatenate([np.repeat(prompt, v * v, axis=0), cands], axis=1)
    with torch.no_grad():
        logp = torch.log_softmax(model(torch.from_numpy(seqs)), -1).numpy()
    t = prompt.shape[1]
    total = (logp[np.arange(v * v), t - 1, cands[:, 0]]
             + logp[np.arange(v * v), t, cands[:, 1]])
    best = int(np.argmax(total))
    np.testing.assert_array_equal(toks[0, 0, -2:], cands[best])
    np.testing.assert_allclose(scores[0, 0], total[best], atol=1e-5,
                               rtol=1e-5)


def test_batch_rows_are_independent(dense):
    """B 2 x K 3: each row's beams and scores equal a one-row call's,
    and JAX's."""
    jmodel, tree, model, prompt = dense
    toks, scores, jt, js = _both(jmodel, tree, model, prompt, 5, 3)
    _match(toks, scores, jt, js)
    for i in range(2):
        ti, si = beam_search(model, torch.from_numpy(prompt[i:i + 1]),
                             max_new_tokens=5, beam_size=3)
        np.testing.assert_array_equal(toks[i], ti[0].numpy())
        np.testing.assert_allclose(scores[i], si[0].numpy(), rtol=1e-6)


def test_one_beam_on_moe_is_greedy_and_matches_jax():
    jmodel, tree, model = _pair(MOE, seed=3)
    prompt = np.random.default_rng(9).integers(0, GEOM["vocab_size"],
                                               (2, 10))
    toks, scores, jt, js = _both(jmodel, tree, model, prompt, 5, 1)
    _match(toks, scores, jt, js)
    greedy = generate(model, torch.from_numpy(prompt), max_new_tokens=5)
    np.testing.assert_array_equal(toks[:, 0], greedy.numpy())


def test_ties_go_to_the_lower_index_as_jax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0, 1.0, 3.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    for k in (1, 3, 5, 8):
        vals, idx = _top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_a_score_tie_goes_to_the_larger_logit_then_the_lower_index():
    """Equal scores rank by the tie key, then by index; distinct scores
    keep ``lax.top_k``'s order whatever the key."""
    x = torch.tensor([[3.0, 5.0, 3.0, 3.0, 1.0, 5.0]])
    tie = torch.tensor([[0.1, 0.2, 0.9, 0.9, 7.0, 0.3]])
    vals, idx = _top_k(x, 6, tie=tie)
    assert idx.tolist() == [[5, 1, 2, 3, 0, 4]]
    assert vals.tolist() == [[5.0, 5.0, 3.0, 3.0, 3.0, 1.0]]


def test_one_beam_is_greedy_through_a_rounded_score_tie():
    """A running score of -300 rounds log-probs 1e-5 apart to one sum:
    the beam keeps the larger logit, as greedy's argmax does (``lax.top_k``
    alone would take the lower index)."""
    logits = torch.tensor([[0.0, 1.0, 1.0 + 1e-5, -3.0]])
    logp = torch.log_softmax(logits, dim=-1)
    total = torch.tensor([[-300.0]]) + logp
    assert total[0, 1] == total[0, 2]  # the rounded tie
    _, idx = _top_k(total, 1, tie=logits)
    assert idx.item() == int(logits.argmax()) == 2
    assert _top_k(total, 1)[1].item() == 1


@pytest.mark.parametrize("kw", [dict(beam_size=0), dict(beam_size=62),
                                dict(beam_size=2, max_new_tokens=0),
                                dict(beam_size=2, max_new_tokens=60)])
def test_checks_speak_jax_words(dense, kw):
    jmodel, tree, model, prompt = dense
    kw = dict(dict(max_new_tokens=3), **kw)
    with pytest.raises(ValueError) as theirs:
        jax_beam_search(jmodel, tree, jnp.asarray(prompt), **kw)
    with pytest.raises(ValueError) as ours:
        beam_search(model, torch.from_numpy(prompt), **kw)
    assert str(ours.value) == str(theirs.value)


def test_sp_model_wants_its_dense_clone(dense):
    _, tree, model, prompt = dense
    sp_jax = jax_models.GPT(attn_impl="xla", seq_axis="seq", **GEOM)
    with pytest.raises(NotImplementedError) as theirs:
        jax_beam_search(sp_jax, tree, jnp.asarray(prompt), max_new_tokens=2,
                        beam_size=2)
    with pytest.raises(NotImplementedError) as ours:
        beam_search(model.clone(seq_axis="seq"), torch.from_numpy(prompt),
                    max_new_tokens=2, beam_size=2)
    assert str(ours.value) == str(theirs.value)
