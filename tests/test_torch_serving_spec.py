"""The port's speculative serving engine against the JAX package's.

Twins of ``tests/test_graftspec.py``: with ``draft_k > 0`` the port's
``ServingEngine`` serves greedy transcripts token-exact with the JAX
speculative engine and with the port's ``generate`` on the same carried
weights, dense and paged, model dtype and int8, whole and chunked
admission, H = 1 and 4 (an EOS mid-horizon), k = 2 and 4, a prefix-cache
full hit, slots driven to the end of ``s_max`` (the verify writes past
it), and draft-model mode; every ``spec_*`` snapshot key equals the JAX
engine's on the same run, and no page leaks.

Two weight sets: random ones (acceptance stays near 0, so the
draft-length collapse and the k = 0 passes run), and the same model
fitted for a few SGD steps on a looping motif by the JAX benchmark's
``train_repetitive``, so self-drafting accepts most drafts. With H > 1
the JAX engine launches horizon h + 1 before reading horizon h, and on
the CPU backend its drafter's device table can alias the numpy mirror
that the drain then rewrites in place, so the in-flight horizon may read
the new table: its acceptance then varies from run to run. The parity
tests give the JAX drafter a copying ``place`` (the table each horizon
was launched with, which is what the port uploads); transcripts are
exact either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serving_bench import train_repetitive
from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine, init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, from_jax_params)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
MOTIF = [7, 19, 3, 42, 11, 58, 23, 5]
SPEC_KEYS = ("spec_tokens_drafted", "spec_tokens_accepted",
             "spec_verify_passes", "spec_accept_rate",
             "spec_accepted_per_target_step", "accept_len_p50",
             "accept_len_p95", "accept_len_p99")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jmodel, jparams):
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def rand():
    """tests/test_graftspec.py's fixture: random weights, 5 prompts."""
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5, 9)]
    return _pair(jmodel, jax_init_params(jmodel, 1)) + (prompts,)


@pytest.fixture(scope="module")
def loop():
    """The same model fitted on the looping motif (benchmarks/
    spec_smoke.py's recipe), and prompts that start the loop."""
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = train_repetitive(jmodel, jax_init_params(jmodel, 1), MOTIF,
                               steps=40, lr=0.3)
    prompts = [(MOTIF * 4)[:20], (MOTIF * 3)[3:17], MOTIF[2:7]]
    return _pair(jmodel, jparams) + (prompts,)


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("s_max", 32)
    kw.setdefault("min_bucket", 8)
    kw.setdefault("draft_k", 4)
    if kw.pop("paged", False):
        kw.setdefault("kv_layout", "paged")
        kw.setdefault("page_size", 8)
    return kw


def _engines(fix, **kw):
    """The port's and the JAX engine on one config (``self_draft=True``
    in draft-model mode: the target drafts for itself)."""
    jmodel, jparams, model, _ = fix
    kw = _kw(kw)
    jkw = dict(kw)
    if kw.pop("self_draft", False):
        jkw.pop("self_draft")
        jkw.update(draft_model=jmodel, draft_params=jparams)
        kw.update(draft_model=GPT(**GEOM),
                  draft_params=from_jax_params(jparams))
    ref = JaxEngine(jmodel, jparams, **jkw)
    if ref._drafter is not None:
        ref._drafter._place = lambda a: jnp.array(a, copy=True)
    return ServingEngine(model, **kw), ref


def _serve(port, ref, requests):
    got = [r.tokens for r in port.serve(requests)]
    want = [[int(t) for t in r.tokens]
            for r in ref.serve([(np.asarray(p), n) for p, n in requests])]
    return got, want


def _tail(model, prompt, n):
    return generate(model, torch.tensor([prompt]),
                    max_new_tokens=n)[0, -n:].tolist()


def _check(fix, port, ref, requests):
    """Token-exact with JAX and ``generate``; equal spec metrics; no
    page held once drained (the prefix cache's aside)."""
    got, want = _serve(port, ref, requests)
    assert got == want
    assert got == [_tail(fix[2], p, n) for p, n in requests]
    snap, jsnap = port.metrics.snapshot(), ref.metrics.snapshot()
    assert {k: snap[k] for k in SPEC_KEYS} == {k: jsnap[k]
                                               for k in SPEC_KEYS}
    if port._paged:
        cache = port._prefix_cache
        held = len(cache.page_ids()) if cache is not None else 0
        assert port.pool.pages_in_use == held
    return snap


@pytest.mark.parametrize("kw", [
    dict(max_slots=3, decode_horizon=4),
    dict(max_slots=3, decode_horizon=4, paged=True, prefill_chunk=5,
         draft_k=2),
    dict(max_slots=3, decode_horizon=4, kv_dtype="int8"),
    dict(max_slots=3, decode_horizon=4, kv_dtype="int8", paged=True),
    dict(max_slots=2, decode_horizon=1, draft_k=2,
         decode_buckets=(8, 16, 32)),
], ids=["dense", "paged-chunked-k2", "int8-dense", "int8-paged",
        "dense-h1-k2-ladder"])
def test_random_weights_match_jax(rand, kw):
    """Drafts rarely match: the draft length collapses to 0 and re-arms
    on the probe, through both decode bodies; all token-exact."""
    port, ref = _engines(rand, **kw)
    snap = _check(rand, port, ref, [(p, 8) for p in rand[3]])
    assert snap["spec_tokens_drafted"] > 0
    assert port.passes_by_k.get(0, 0) > 0  # collapsed to plain passes


@pytest.mark.parametrize("kw", [
    dict(max_slots=2, decode_horizon=4),
    dict(max_slots=2, decode_horizon=4, paged=True, prefill_chunk=5),
    dict(max_slots=2, decode_horizon=4, kv_dtype="int8", paged=True,
         draft_k=2),
], ids=["dense", "paged-chunked", "int8-paged-k2"])
def test_looping_stream_accepts_and_matches_jax(loop, kw):
    """A stream that loops: self-drafting accepts about half the drafts
    or more (the budgets cut the last passes short), several tokens per
    target pass, with JAX's exact acceptance counts; the
    first request ends at s_max - 1, so its last passes write past the
    sequence (into the spare columns, or the scratch page)."""
    port, ref = _engines(loop, **kw)
    p0, p1, p2 = loop[3]
    snap = _check(loop, port, ref, [(p0, 12), (p1, 10), (p2, 14)])
    assert snap["spec_accept_rate"] > 0.4
    assert snap["spec_accepted_per_target_step"] > 1.5
    assert 0 not in port.passes_by_k  # acceptance kept k armed
    if not port._paged:  # verify writes past s_max landed in the spares
        spare = port.pool.k_caches[:, :, port.pool.s_max:]
        assert spare.shape[2] == kw.get("draft_k", 4)
        assert bool(spare.abs().sum() > 0)


def test_eos_mid_horizon_and_prefix_full_hit(loop):
    """H = 4, paged with the prefix cache: a stop token met mid-horizon
    is emitted and freezes the row; the same prompt again is a full
    prefix hit; both token-exact with JAX and ``generate``."""
    port, ref = _engines(loop, max_slots=2, decode_horizon=4, paged=True,
                         prefix_cache=4)
    prompt = loop[3][1]
    want = _tail(loop[2], prompt, 12)
    eos = want[6]
    first = want[:want.index(eos) + 1]
    for engine, wrap in ((port, list), (ref, np.asarray)):
        engine.submit(wrap(prompt), 12, eos_id=eos)
        (done,) = [r for r, _, d in engine.run() if d]
        assert done.finish_reason == "eos"
        assert [int(t) for t in done.tokens] == first
    _check(loop, port, ref, [(prompt, 12)])
    assert port.metrics.snapshot()["prefix_hits"] == 1
    assert ref.metrics.snapshot()["prefix_hits"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_draft_model_mode(rand, paged):
    """tests/test_graftspec.py::test_spec_draft_model_mode: the target
    as its own draft accepts (nearly) every draft; requests reaching
    s_max put the draft's writes past it too."""
    port, ref = _engines(rand, max_slots=2, decode_horizon=4,
                         self_draft=True, paged=paged)
    prompts = rand[3]
    snap = _check(rand, port, ref, [(prompts[0], 6), (prompts[1], 6),
                                    (prompts[2] + prompts[3], 15)])
    assert snap["spec_accept_rate"] > 0.5
    assert snap["spec_accepted_per_target_step"] > 1.0
    assert port.spec_accept_ema > 0.5
