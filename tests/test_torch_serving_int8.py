"""The port's int8 KV cache against the JAX package's.

Twins of ``tests/test_graftquant.py``: the port's int8 engine, dense,
paged and chunked, serves greedy transcripts token-exact with the JAX
int8 engine (and with its own model-dtype engine, where JAX's are) on
the same carried weights; int8 dense and int8 paged agree token for
token (one dequant expression); ``teacher_forced_logits`` is within
1e-5 of JAX's in f32 in both cache dtypes, and its int8-vs-model logit
delta lies in ``(0, 5e-3)`` (the JAX test's budget). The slice pin:
``serve_lm.main`` with ``--kv_layout paged --prefix_cache 4 --kv_dtype
int8`` from an ``.npz`` checkpoint prints the JAX engine's transcripts.
"""

import argparse
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_lm as jax_serve_lm
from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference import (
    generate as jax_generate, teacher_forced_logits as jax_tfl)
from pytorch_multiprocessing_distributed_tpu.serving import (
    Request as JaxRequest, ServingEngine as JaxEngine,
    SlotPool as JaxSlotPool, init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
from pytorch_multiprocessing_distributed_tpu_torch.inference import (
    teacher_forced_logits)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, SlotPool, from_jax_params)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
LOGIT_TOL = 5e-3  # tests/test_graftquant.py's committed budget
TFL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, 1)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5, 9)]
    return jmodel, jparams, model, prompts


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("max_slots", 3)
    kw.setdefault("s_max", 32)
    kw.setdefault("min_bucket", 8)
    if kw.pop("paged", False):
        kw.setdefault("kv_layout", "paged")
        kw.setdefault("page_size", 8)
    return kw


def _both(served, requests, **kw):
    """Transcripts of the port's and the JAX engine on ``requests``."""
    jmodel, jparams, model, _ = served
    port = ServingEngine(model, **_kw(kw)).serve(requests)
    ref = JaxEngine(jmodel, jparams, **_kw(kw)).serve(
        [(np.asarray(p), n) for p, n in requests])
    return ([r.tokens for r in port],
            [[int(t) for t in r.tokens] for r in ref])


def test_int8_dense_matches_jax_and_model_dtype(served):
    """tests/test_graftquant.py:136's config: int8 dense == the JAX int8
    engine == the port's model-dtype engine."""
    prompts = served[3]
    requests = [(p, 6) for p in prompts]
    got, want = _both(served, requests, kv_dtype="int8")
    assert got == want
    model_dtype, _ = _both(served, requests)
    assert got == model_dtype


def test_int8_paged_matches_jax_and_int8_dense(served):
    """:151's config: int8 paged == the JAX int8 paged engine; and the
    port's int8 paged == its int8 dense, token for token."""
    requests = [(p, 6) for p in served[3]]
    got, want = _both(served, requests, kv_dtype="int8", paged=True)
    assert got == want
    dense = ServingEngine(served[2], **_kw(dict(kv_dtype="int8"))).serve(
        requests)
    assert got == [r.tokens for r in dense]


def test_int8_chunked_prefill_and_horizon(served):
    """:160's config: chunked admission and horizons of 4 through the
    int8 cache, dense and paged."""
    requests = [(p, 8) for p in served[3][:3]]
    kw = dict(max_slots=2, prefill_chunk=5, decode_horizon=4,
              kv_dtype="int8")
    got, want = _both(served, requests, **kw)
    assert got == want
    paged, _ = _both(served, requests, paged=True, **kw)
    assert paged == got


def test_teacher_forced_logits_match_jax_and_budget(served):
    """:207: one transcript through both cache dtypes; each within 1e-5
    of JAX's, and the int8 cost nonzero and inside the budget with the
    greedy argmax kept at every position."""
    jmodel, jparams, model, prompts = served
    toks = np.asarray(jax_generate(jmodel, jparams,
                                   jnp.asarray(prompts[1])[None, :],
                                   max_new_tokens=10))
    t = torch.from_numpy(toks.astype(np.int64))
    out = {}
    for kv_dtype in ("model", "int8"):
        got = teacher_forced_logits(model, t, len(prompts[1]),
                                    kv_dtype=kv_dtype).numpy()
        ref = np.asarray(jax_tfl(jmodel, jparams, jnp.asarray(toks),
                                 len(prompts[1]), kv_dtype=kv_dtype))
        assert got.shape == ref.shape == (10, 1, 61)
        np.testing.assert_allclose(got, ref, atol=TFL_TOL, rtol=0)
        out[kv_dtype] = got
    delta = float(np.abs(out["int8"] - out["model"]).max())
    assert 0.0 < delta < LOGIT_TOL, delta
    np.testing.assert_array_equal(out["int8"].argmax(-1),
                                  out["model"].argmax(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_slot_bytes_match_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for name in ("gpt_tiny", "gpt_small"):
        model = get_model(name, dtype=dtype)
        jmodel = jax_models.get_model(name, dtype=jdt)
        for kv_dtype in ("model", "int8"):
            assert (SlotPool.per_slot_kv_bytes(model, 1024, kv_dtype)
                    == JaxSlotPool.per_slot_kv_bytes(jmodel, 1024,
                                                     kv_dtype))


def test_int8_pool_layout(served):
    pool = SlotPool(served[2], 2, 32, kv_dtype="int8")
    assert pool.k_caches.data.dtype == torch.int8
    assert tuple(pool.k_caches.scale.shape) == (2, 2, 32, 2)
    assert bool((pool.k_caches.scale == 1).all())
    with pytest.raises(ValueError, match="kv_dtype"):
        SlotPool(served[2], 2, 32, kv_dtype="fp8")


def _flat(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            yield from _flat(val, path)
        else:
            yield path, np.asarray(val)


def test_cli_paged_int8_prefix_transcripts_equal_jax(tmp_path, capsys):
    """The slice pin: the port's CLI, paged + prefix cache + int8, from
    a checkpoint, on the CPU, prints the JAX engine's transcripts for
    the JAX CLI's synthetic requests (two of them repeated, so the
    prefix cache hits), and ends with every page but the cache's
    returned."""
    jmodel = jax_models.get_model("gpt_tiny", attn_impl="xla")
    jparams = jax_init_params(jmodel, 0)
    ckpt = tmp_path / "gpt_tiny.npz"
    np.savez(ckpt, **dict(_flat(jparams)))
    path = tmp_path / "r.jsonl"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 257, (n,)).tolist() for n in (20, 33, 9)]
    prompts += [prompts[1], prompts[1][:16] + [7, 8, 9]]
    path.write_text("".join(f'{{"prompt": {p}}}\n' for p in prompts))
    flags = ["--kv_layout", "paged", "--prefix_cache", "4", "--kv_dtype",
             "int8", "--max_slots", "2", "--max_new_tokens", "5",
             "--decode_horizon", "4", "--requests", str(path)]
    snap = serve_lm.main(["--device", "cpu", "--model", "gpt_tiny",
                          "--ckpt", str(ckpt)] + flags)
    out = capsys.readouterr().out
    got = dict(re.findall(r"^req=(src-\d+) tokens=(\[.*\])$", out, re.M))

    args = argparse.Namespace(requests=str(path), stdin=False,
                              synthetic=0, seed=0, max_new_tokens=5)
    engine = JaxEngine(jmodel, jparams, max_slots=2, kv_layout="paged",
                       page_size=16, prefix_cache=4, kv_dtype="int8",
                       decode_horizon=4)
    reqs = [JaxRequest(p, n, None, uid=f"src-{i}") for i, (p, n) in
            enumerate(jax_serve_lm._load_requests(args, 257, []))]
    for r in reqs:
        engine.enqueue(r)
    for _ in engine.run():
        pass
    assert got == {r.uid: str([int(t) for t in r.tokens]) for r in reqs}
    assert snap["requests_completed"] == 5
    assert snap["prefix_hits"] == 1 and snap["prefix_partial_hits"] == 1
    assert snap["pages_in_use"] == snap["prefix_cache_pages"] > 0
    assert snap["kv_layout"] == "paged" and snap["kv_dtype"] == "int8"
