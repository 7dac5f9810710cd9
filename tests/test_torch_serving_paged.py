"""The port's paged KV and shared-prefix cache against the JAX package's.

Twins of ``tests/test_serving_paged.py``: the port's ``ServingEngine``
with ``kv_layout="paged"`` serves greedy transcripts token-exact with
the JAX paged engine on the same carried weights (and with the port's
dense engine and ``generate``), through full and partial prefix hits,
copy-on-write forks, 100-request churn, holds under page pressure and
chunked admission; it returns every page once drained. ``PagePool`` and
``PrefixCache`` driven through one operation sequence end with the JAX
classes' free lists, refcounts and table.
"""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    PagePool as JaxPagePool, PrefixCache as JaxPrefixCache,
    ServingEngine as JaxEngine, init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu.serving.scheduler import (
    PrefillPlan as JaxPrefillPlan, Request as JaxRequest)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    PagePool, PagePoolExhausted, PrefillPlan, PrefixCache, Request,
    ServingEngine, from_jax_params)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """tests/test_serving_paged.py's fixture: model, weights, 5 prompts."""
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, 1)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5, 9)]
    return jmodel, jparams, model, prompts


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("s_max", 32)
    kw.setdefault("min_bucket", 8)
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("page_size", 8)
    return kw


def _port(served, **kw):
    return ServingEngine(served[2], **_kw(kw))


def _jax(served, **kw):
    return JaxEngine(served[0], served[1], **_kw(kw))


def _tail(model, prompt, n):
    return generate(model, torch.tensor([prompt]),
                    max_new_tokens=n)[0, -n:].tolist()


def _jax_tokens(requests):
    return [[int(t) for t in r.tokens] for r in requests]


def test_paged_matches_dense_jax_and_generate(served):
    """The slice's engine pin: ragged requests churning through 3 slots,
    paged == dense == the JAX paged engine == ``generate``; the same
    decode shapes as dense; every page back after the drain."""
    _, _, model, prompts = served
    paged = _port(served, max_slots=3)
    dense = _port(served, max_slots=3, kv_layout="dense")
    got = [r.tokens for r in paged.serve([(p, 4) for p in prompts])]
    assert got == [r.tokens for r in dense.serve([(p, 4) for p in prompts])]
    want = _jax_tokens(_jax(served, max_slots=3).serve(
        [(np.asarray(p), 4) for p in prompts]))
    assert got == want
    assert got == [_tail(model, p, 4) for p in prompts]
    assert paged.decode_programs == dense.decode_programs
    pool = paged.pool
    assert pool.pages_in_use == 0 and pool.free_pages == pool.num_pages - 1
    again = [r.tokens for r in paged.serve([(p, 4) for p in prompts])]
    assert again == got and pool.pages_in_use == 0


def test_prefix_cache_full_hit(served):
    """An identical prompt resubmitted is a FULL hit: token-exact with
    the miss, the JAX engine and ``generate``, with no prefill run."""
    _, _, model, prompts = served
    engine = _port(served, max_slots=2, page_size=4, prefix_cache=8)
    prompt = prompts[2]  # 12 tokens: 3 aligned pages at ps 4
    (miss,) = engine.serve([(prompt, 4)])
    assert miss.prefix_hit is None
    snap0 = engine.metrics.snapshot()
    assert snap0["prefix_misses"] == 1 and snap0["prefix_hits"] == 0
    calls = []
    real = engine._prefill
    engine._prefill = lambda *a: calls.append(a) or real(*a)
    (hit,) = engine.serve([(prompt, 4)])
    assert hit.prefix_hit == "full" and not calls
    assert hit.tokens == miss.tokens == _tail(model, prompt, 4)
    ref = _jax(served, max_slots=2, page_size=4, prefix_cache=8)
    want = [_jax_tokens(ref.serve([(prompt, 4)]))[0] for _ in range(2)]
    assert want == [miss.tokens, hit.tokens]
    assert engine.metrics.snapshot()["prefix_hits"] == 1
    assert engine.pool.pages_in_use > 0  # the cache holds the prefix
    engine._prefix_cache.clear()
    assert engine.pool.pages_in_use == 0


def test_prefix_cache_cow_divergence(served):
    """(a) a prompt sharing aligned pages but diverging later is a
    PARTIAL hit; (b) two concurrent full hits of one cached prompt with
    a partial last page, one stopped by EOS mid-horizon, stay isolated
    by the copy-on-write fork. All token-exact with JAX and
    ``generate``."""
    _, _, model, prompts = served
    kw = dict(max_slots=3, page_size=4, prefix_cache=8, decode_horizon=4)
    engine, ref = _port(served, **kw), _jax(served, **kw)
    base = prompts[2] + prompts[3]  # 17 tokens: a partial page at ps 4
    (creator,) = engine.serve([(base, 4)])
    assert creator.tokens == _tail(model, base, 4)
    entry, k = engine._prefix_cache.lookup(base)
    assert entry is not None and k == 4 and entry.partial_id is not None
    fork = base[:8] + [1, 2, 3]
    before = [engine.pool.page_refcount(p) for p in entry.shared_ids[:2]]
    (partial,) = engine.serve([(fork, 4)])
    assert partial.prefix_hit == "partial"
    assert partial.tokens == _tail(model, fork, 4)
    assert [engine.pool.page_refcount(p)
            for p in entry.shared_ids[:2]] == before
    ref8 = _tail(model, base, 8)
    a = engine.submit(base, 8)
    b = engine.submit(base, 8, eos_id=ref8[2])
    for _ in engine.run():
        pass
    assert a.prefix_hit == b.prefix_hit == "full"
    assert a.tokens == ref8 and b.tokens == ref8[:3]
    assert b.finish_reason == "eos"
    ref.serve([(base, 4)])
    assert _jax_tokens(ref.serve([(fork, 4)]))[0] == partial.tokens
    ja, jb = ref.submit(base, 8), ref.submit(base, 8, eos_id=ref8[2])
    for _ in ref.run():
        pass
    assert _jax_tokens([ja, jb]) == [a.tokens, b.tokens]
    engine._prefix_cache.clear()
    assert engine.pool.pages_in_use == 0


def test_prefix_is_aligned_subprompt_of_cached(served):
    """A prompt that IS a page-aligned prefix of a longer cached one is
    a partial hit that still prefills >= 1 suffix token for its first
    token."""
    _, _, model, prompts = served
    engine = _port(served, max_slots=2, page_size=4, prefix_cache=8)
    long_p = prompts[2] + prompts[3]
    (creator,) = engine.serve([(long_p, 4)])
    assert creator.state == "done"
    sub = long_p[:16]
    (r,) = engine.serve([(sub, 4)])
    assert r.state == "done" and r.prefix_hit == "partial"
    assert r.tokens == _tail(model, sub, 4)
    ref = _jax(served, max_slots=2, page_size=4, prefix_cache=8)
    ref.serve([(long_p, 4)])
    (jr,) = ref.serve([(sub, 4)])
    assert jr.prefix_hit == "partial" and _jax_tokens([jr]) == [r.tokens]
    engine._prefix_cache.clear()
    assert engine.pool.pages_in_use == 0


def test_prefix_cache_validation(served):
    _, _, model, _ = served
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, max_slots=1, prefix_cache=4)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, max_slots=1, page_size=8)
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(model, max_slots=1, kv_layout="paged", page_size=8,
                      prefix_cache=4, temperature=0.5,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(model, max_slots=1, kv_layout="vram")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(model, max_slots=1, kv_dtype="fp8")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, max_slots=1, prefill_chunk=0)


def test_page_recycling_no_leak_churn(served):
    """100-request churn through a small pool: token-exact with the JAX
    engine round by round; every page returns, refcounts end zero and
    the table mirror ends all scratch."""
    engine = _port(served, max_slots=2, page_size=8)
    ref = _jax(served, max_slots=2, page_size=8)
    rng = np.random.default_rng(3)
    pool = engine.pool
    free0 = pool.free_pages
    for i in range(25):  # 4 requests per round = 100 requests
        batch = [(rng.integers(0, 61, (int(rng.integers(1, 20)),)).tolist(),
                  2) for _ in range(4)]
        got = [r.tokens for r in engine.serve(batch)]
        assert got == _jax_tokens(ref.serve(
            [(np.asarray(p), n) for p, n in batch])), f"round {i}"
        assert pool.pages_in_use == 0, f"leak after round {i}"
    assert pool.free_pages == free0
    assert all(pool.page_refcount(p) == 0
               for p in range(1, pool.num_pages))
    assert not pool._table.any()


def test_page_exhaustion_hold_and_named_shed(served):
    """Under page pressure the FIFO head is HELD (counted, never
    failed) until running work frees pages; a head nothing in flight
    could ever satisfy fails named ``PagePoolExhausted`` with reason
    ``pages``; a never-fits request is rejected at submission. The same
    sequence through the JAX engine gives the same tokens, holds and
    failure."""
    _, _, model, _ = served
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 61, (9,)).tolist()   # 9 + 4 -> 4 pages
    p2 = rng.integers(0, 61, (9,)).tolist()
    p3 = rng.integers(0, 61, (5,)).tolist()   # 5 + 4 -> 3 pages
    outcomes = []
    for make in (_port, _jax):
        engine = make(served, max_slots=2, page_size=4, num_pages=6)
        r1, r2 = engine.submit(p1, 4), engine.submit(p2, 4)
        holds = 0
        while engine.in_flight:
            engine.step()
            holds = max(holds, engine.metrics.page_holds)
        assert r1.state == r2.state == "done"
        with pytest.raises(ValueError, match="page"):
            engine.submit(list(range(20)), 8)
        stuck = engine.pool.alloc_pages(3)  # leaves 2 free of 5
        r3 = engine.submit(p3, 4)
        engine.step()
        assert r3.state == "failed" and r3.finish_reason == "pages"
        assert type(r3.error).__name__ == "PagePoolExhausted"
        engine.pool.decref(stuck)
        assert engine.pool.pages_in_use == 0
        outcomes.append((_jax_tokens([r1, r2]), holds,
                         engine.metrics.snapshot()["requests_failed"]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == [_tail(model, p1, 4), _tail(model, p2, 4)]
    assert outcomes[0][1] > 0 and outcomes[0][2] == 1


def test_paged_chunked_horizon_eos(served):
    """Chunked admission (5-token chunks) with fused horizons of 4 and
    an EOS that fires mid-horizon: token-exact with the JAX engine and
    ``generate``; no page leaks."""
    _, _, model, prompts = served
    ref8 = _tail(model, prompts[1], 8)
    eos = ref8[2]
    kw = dict(max_slots=2, prefill_chunk=5, decode_horizon=4)
    engine, ref = _port(served, **kw), _jax(served, **kw)
    got = engine.serve([(p, 8) for p in (prompts[0], prompts[2])])
    assert [r.tokens for r in got] == [_tail(model, p, 8)
                                       for p in (prompts[0], prompts[2])]
    assert [r.tokens for r in got] == _jax_tokens(ref.serve(
        [(np.asarray(p), 8) for p in (prompts[0], prompts[2])]))
    request = engine.submit(prompts[1], 8, eos_id=eos)
    jreq = ref.submit(prompts[1], 8, eos_id=eos)
    for _ in engine.run():
        pass
    for _ in ref.run():
        pass
    assert request.finish_reason == "eos" and request.tokens == ref8[:3]
    assert request.tokens == [int(t) for t in jreq.tokens]
    assert engine.pool.pages_in_use == 0


@pytest.mark.parametrize("length, chunk, start_at",
                         [(3, 5, 0), (12, 5, 0), (17, 4, 8), (17, 5, 4),
                          (30, 8, 0)])
def test_prefill_plan_matches_jax(length, chunk, start_at):
    port = PrefillPlan(Request([1] * length, 2), chunk, 8, 32,
                       start_at=start_at)
    ref = JaxPrefillPlan(JaxRequest([1] * length, 2), chunk, 8, 32,
                         start_at=start_at)
    assert (port.width, port.starts) == (ref.width, ref.starts)
    while not ref.done:
        assert port.next_chunk() == ref.next_chunk()
    assert port.done


def _pool_state(pool):
    return (list(pool._free), [int(r) for r in pool._refs],
            pool._table.tolist(), pool.pages_in_use)


def test_pagepool_matches_jax(served):
    jmodel, _, model, _ = served
    pools = (PagePool(model, max_slots=2, s_max=32, page_size=8,
                      num_pages=6),
             JaxPagePool(jmodel, max_slots=2, s_max=32, page_size=8,
                         num_pages=6))
    assert pools[0].pages_per_slot == pools[1].pages_per_slot == 4
    for kv_dtype in ("model", "int8"):
        assert (PagePool.page_kv_bytes(model, 8, kv_dtype)
                == JaxPagePool.page_kv_bytes(jmodel, 8, kv_dtype))
    for pool in pools:
        ids = pool.alloc_pages(3)
        assert ids == [1, 2, 3]
        pool.incref([ids[0]])
        pool.decref(ids)
        with pytest.raises(PagePoolExhausted if pool is pools[0]
                           else Exception):
            pool.alloc_pages(6)
        with pytest.raises(ValueError):
            pool.decref([2])  # already free
        ids = pool.alloc_pages(2)
        slot = pool.acquire()
        pool.bind_slot(slot, ids)
        assert pool.slot_pages(slot) == ids
        assert list(np.asarray(pool.device_table())[slot][:2]) == ids
        other = pool.acquire()
        pool.bind_slot(other, pool.alloc_pages(1))
        pool.release(slot)
    assert _pool_state(pools[0]) == _pool_state(pools[1])
    with pytest.raises(ValueError, match="num_pages"):
        PagePool(model, max_slots=1, s_max=32, page_size=8, num_pages=1)
    with pytest.raises(ValueError, match="page_size"):
        PagePool(model, max_slots=1, s_max=32, page_size=0)


def test_prefix_cache_matches_jax(served):
    """Registration, longest-prefix lookup, LRU eviction and the survivor
    reindex, on both classes through the same operations."""
    jmodel, _, model, _ = served
    results = []
    for pool_cls, cache_cls, m in ((PagePool, PrefixCache, model),
                                   (JaxPagePool, JaxPrefixCache, jmodel)):
        pool = pool_cls(m, max_slots=2, s_max=32, page_size=4)
        cache = cache_cls(pool, max_entries=2)
        copies, log = [], []

        def fake_copy(src, dst, copies=copies):
            copies.append((src, dst))

        ids = pool.alloc_pages(3)
        prompt = list(range(10))
        entry = cache.register(prompt, ids, tok0=7, copy_page=fake_copy)
        log.append((entry.n_full, entry.partial_id, entry.tok0))
        for probe in (prompt, prompt[:8] + [55, 56, 57], [9] * 12):
            got, k = cache.lookup(probe)
            log.append((None if got is None else got.tokens, k))
        pool.decref(ids)
        for base in (100, 200):
            ids2 = pool.alloc_pages(1)
            cache.register([base] * 4, ids2, tok0=1, copy_page=fake_copy)
            pool.decref(ids2)
        log.append((len(cache), cache.lookup(prompt)[1]))
        cache.clear()
        cache = cache_cls(pool, max_entries=4)
        ia = pool.alloc_pages(1)
        a = cache.register([5, 6, 7, 8], ia, tok0=1, copy_page=fake_copy)
        ib = pool.alloc_pages(2)
        cache.register([5, 6, 7, 8, 9, 10, 11, 12], ib, tok0=2,
                       copy_page=fake_copy)
        pool.decref(ia)
        pool.decref(ib)
        cache._drop(a)
        got, k = cache.lookup([5, 6, 7, 8, 99])
        log.append((got.tokens, k))
        log.append(_pool_state(pool))
        cache.clear()
        log.append(_pool_state(pool))
        results.append((copies, log))
    assert results[0] == results[1]
    assert results[0][1][-1][3] == 0  # every page back
