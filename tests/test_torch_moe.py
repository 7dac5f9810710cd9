"""The port's Mixture-of-Experts layer, model and decode against the JAX
package's, on the CPU at a tiny size (D 32, H 64, E 4, B 4, S 16; the
GPT 2 layers and 2 heads).

The training layer (``ops.moe.MoEMlp``) against JAX's, top-1 and top-2,
with the capacity binding (factor 1.0: tokens drop) and not (factor
4.0): the same routes, the same kept assignments (JAX's read off its own
gradient: ``d y[b, s] / d b2[e]`` is the combine weight of a kept
assignment and 0 of a dropped one), ``y``, ``aux``, ``z`` and the
gradients of every leaf and of the input within 1e-5 in f32, and ``y``
within 3e-2 in bf16 (the experts' products rounded to bf16, as in JAX).
The decode layer (dropless) against JAX ``generate._moe_ffn``, the
model's logits and layer-mean losses against JAX's ``mutable=["losses"]``
apply, and greedy ``generate`` and the serving engine token-exact with
JAX's on an MoE GPT.
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
    _moe_ffn as jax_moe_ffn)
from pytorch_multiprocessing_distributed_tpu.ops.moe import MoEMlp as JaxMoE
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine, init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu.train.lm import (
    _collect_moe_losses)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.ops.moe import (
    MoEMlp, capacity, dispatch_masks, route, top_k_lower_first)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, from_jax_params, init_params)

B, S, D, H, E = 4, 16, 32, 64, 4
TOL = 1e-5
BF16_TOL = 3e-2
GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=D, num_layers=2,
            num_heads=2, mlp_dim=H, n_experts=E)
CASES = [(1, 1.0), (1, 4.0), (2, 1.0), (2, 4.0)]
IDS = ["top1-binding", "top1-free", "top2-binding", "top2-free"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer(k, factor, dtype=jnp.float32):
    """(JAX layer, its params with random biases, f32 input)."""
    jm = JaxMoE(n_experts=E, d_hidden=H, capacity_factor=factor, top_k=k,
                dtype=dtype)
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]
    rng = np.random.default_rng(1)
    params = {n: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(
        np.float32) * (n in ("b1", "b2")) for n, v in params.items()}
    return jm, params, x


def _port(params, k, factor):
    m = MoEMlp(D, E, H, factor, k)
    m.load_state_dict({n: torch.from_numpy(v).clone()
                       for n, v in params.items()}, assign=True)
    for p in m.parameters():
        p.requires_grad_(True)
    return m


@pytest.mark.parametrize("k,factor", CASES, ids=IDS)
def test_layer_matches_jax(k, factor):
    jm, params, x = _layer(k, factor)
    r = np.random.default_rng(2).standard_normal((B, S, D)).astype(
        np.float32)

    def jloss(p, xx):
        y, mut = jm.apply({"params": p}, xx, mutable=["losses"])
        aux, z = (mut["losses"][n][0] for n in ("moe_aux", "moe_z"))
        return jnp.sum(y * r) + 0.3 * aux + 0.7 * z, (y, aux, z)

    (_, (jy, jaux, jz)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    m = _port(params, k, factor)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, z = m(xt)
    (torch.sum(y * torch.from_numpy(r)) + 0.3 * aux + 0.7 * z).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=TOL,
                               rtol=0)
    assert abs(aux.item() - float(jaux)) < TOL
    assert abs(z.item() - float(jz)) < TOL
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=TOL,
                               rtol=0)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   atol=TOL, rtol=0, err_msg=name)

    # the routes: JAX's top_k of its own router
    gates = jax.nn.softmax(jnp.asarray(x) @ params["gate"], axis=-1)
    jtopi = np.asarray(jax.lax.top_k(gates, k)[1])
    _, _, _, topi = route(m.gate.detach(), torch.from_numpy(x), k)
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    # the kept assignments: JAX's combine weight of (token, expert)
    jkept = np.asarray(jax.jacrev(
        lambda b2: jm.apply({"params": dict(params, b2=b2)},
                            jnp.asarray(x))[..., 0])(params["b2"]))[..., 0]
    masks, slots, kept = dispatch_masks(
        torch.nn.functional.one_hot(topi, E).float(), m.capacity(S))
    ours = sum(masks).sum(-1).numpy() > 0                    # [B, S, E]
    np.testing.assert_array_equal(ours, jkept > 0)
    # the data drop assignments where the capacity binds, none elsewhere
    assert bool(kept.all()) == (factor > 1.0)
    # the slots: choice-priority order, counted out in plain Python
    for b in range(B):
        used = [0] * E
        for j in range(k):
            for s in range(S):
                e = int(topi[b, s, j])
                assert int(slots[b, s, j]) == used[e]
                assert bool(kept[b, s, j]) == (used[e] < m.capacity(S))
                used[e] += 1


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_layer_bf16_within_tolerance(k):
    jm, params, x = _layer(k, 1.0, jnp.bfloat16)
    jy = jm.apply({"params": params}, jnp.asarray(x))
    m = _port(params, k, 1.0)
    with torch.no_grad():
        y, _, _ = m(torch.from_numpy(x), torch.bfloat16)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=BF16_TOL,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 2, 3], ids=["top1", "top2", "top3"])
def test_ties_go_to_the_lower_expert_as_in_jax(k):
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.3, 0.2, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), k)
    v, i = top_k_lower_first(torch.from_numpy(gates), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("s,k,factor,e", [(16, 1, 1.0, 4), (16, 2, 1.0, 4),
                                          (1024, 1, 1.0, 8), (7, 1, 1.0, 4),
                                          (5, 2, 1.25, 8), (1, 1, 0.5, 4)])
def test_capacity_of_the_jax_layer(s, k, factor, e):
    """The capacity the JAX layer uses: the width of its dispatch,
    read through its expert inputs' shape."""
    jm = JaxMoE(n_experts=e, d_hidden=8, capacity_factor=factor, top_k=k)
    x = jnp.zeros((1, s, 4))
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    jaxpr = jax.make_jaxpr(lambda p: jm.apply({"params": p}, x))(params)
    # the expert inputs and outputs [E, B, C, D] (and the expert
    # biases broadcast to [E, 1, 1, D])
    widths = {v.aval.shape[2] for eqn in jaxpr.eqns for v in eqn.outvars
              if len(getattr(v.aval, "shape", ())) == 4
              and v.aval.shape[:2] == (e, 1) and v.aval.shape[3] == 4}
    assert max(widths) == capacity(s, k, factor, e)


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropless_layer_matches_jax(k, dtype):
    _, params, x = _layer(k, 1.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_moe_ffn({n: jnp.asarray(v) for n, v in params.items()},
                      jnp.asarray(x), jdt, k)
    got = _port(params, k, 1.0).dropless(torch.from_numpy(x), tdt)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=0)


@pytest.fixture(scope="module", params=[1, 2], ids=["top1", "top2"])
def pair(request):
    k = request.param
    jmodel = jax_models.GPT(attn_impl="xla", moe_top_k=k, **GEOM)
    jparams = jax_init_params(jmodel, 1)
    model = GPT(**GEOM, moe_top_k=k)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    return jmodel, jparams, model


def test_model_logits_and_losses_match_jax(pair):
    jmodel, jparams, model = pair
    tokens = np.random.default_rng(3).integers(0, 61, (B, S))
    jlogits, mut = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                                mutable=["losses"])
    jaux, jz = _collect_moe_losses(mut)
    logits, aux, z = model(torch.from_numpy(tokens), moe_losses=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=0)
    assert abs(float(aux) - float(jaux)) < TOL
    assert abs(float(z) - float(jz)) < TOL
    torch.testing.assert_close(model(torch.from_numpy(tokens)), logits)


def test_greedy_generate_token_exact_with_jax(pair):
    jmodel, jparams, model = pair
    rng = np.random.default_rng(0)
    for n in (3, 7, 12):
        prompt = rng.integers(0, 61, (2, n))
        ref = jax_generate(jmodel, jparams, jnp.asarray(prompt),
                           max_new_tokens=8)
        got = generate(model, torch.from_numpy(prompt), max_new_tokens=8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=f"prompt len {n}")


def test_engine_token_exact_with_jax_engine(pair):
    """The serving engine's decode and (self-drafted) verify blocks on
    the MoE model: JAX's engine's tokens, and ``generate``'s."""
    jmodel, jparams, model = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5)]
    want = JaxEngine(jmodel, jparams, max_slots=3, s_max=32, min_bucket=8,
                     decode_horizon=2).serve(
        [(np.asarray(p), 6) for p in prompts])
    for kw in ({}, {"draft_k": 2}):
        got = ServingEngine(model, max_slots=3, s_max=32, min_bucket=8,
                            decode_horizon=2, **kw).serve(
            [(p, 6) for p in prompts])
        for a, b, p in zip(got, want, prompts):
            assert a.tokens == b.tokens, (kw, len(p))
            tail = generate(model, torch.tensor([p]), max_new_tokens=6)
            assert a.tokens == tail[0, -6:].tolist()


def test_gpt_moe_blocks_and_clone():
    model = GPT(**GEOM, moe_top_k=2, moe_capacity_factor=2.0)
    names = [n for n, _ in model.named_parameters() if n.startswith(
        "block_0.")]
    assert names == ["block_0.ln1.scale", "block_0.ln1.bias",
                     "block_0.attn.wqkv.kernel", "block_0.attn.wqkv.bias",
                     "block_0.attn.wo.kernel", "block_0.attn.wo.bias",
                     "block_0.ln2.scale", "block_0.ln2.bias",
                     "block_0.moe.gate", "block_0.moe.w1", "block_0.moe.b1",
                     "block_0.moe.w2", "block_0.moe.b2"]
    assert tuple(model.block(1).moe.w2.shape) == (E, H, D)
    model.load_state_dict(init_params(model, 0, "cpu"), assign=True)
    other = model.clone(seq_axis=None)
    moe = other.block(0).moe
    assert (moe.top_k, moe.capacity_factor, moe.n_experts) == (2, 2.0, E)
    assert other.block(0).moe.w1.data_ptr() == model.block(0).moe.w1.\
        data_ptr()
    with pytest.raises(ValueError, match="top_k"):
        GPT(**GEOM, moe_top_k=5)


def test_init_params_of_the_moe_leaves():
    """flax's ``lecun_normal``: a truncated normal of std ``sqrt(1 /
    fan_in)`` with ``fan_in`` every dim but the last (``E * D`` for
    ``w1``), zero expert biases."""
    geom = dict(GEOM, hidden_size=64, mlp_dim=128, n_experts=8)
    params = init_params(GPT(**geom), 3, "cpu")
    for leaf, fan_in in (("gate", 64), ("w1", 8 * 64), ("w2", 8 * 128)):
        t = params[f"block_0.moe.{leaf}"]
        std = fan_in ** -0.5
        assert abs(float(t.std()) / std - 1) < 0.05, leaf
        assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    for leaf in ("b1", "b2"):
        assert not params[f"block_1.moe.{leaf}"].any()
    again = init_params(GPT(**geom), 3, "cpu")
    assert all(torch.equal(again[n], t) for n, t in params.items())
