"""The engine's fleet seams against the JAX package's: the detached
prefill's block (whole and chunked) within 1e-5 of JAX's with the same
first token; the wire and device-resident transfers spliced bit-equal to
a local admission, model dtype and int8 (``quantize_kv_np`` bit-equal
to ``quantize_kv``), and bf16 through the wire's raw bits; ``withdraw``
leaving every other stream exact; ``hard_reclaim`` returning every slot
and page; the scheduler's withdrawals and the journal's handoff record,
byte for byte with JAX's WAL."""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.serving import (
    Request as JaxRequest, ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu.serving.scheduler import (
    FIFOScheduler as JaxScheduler)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    quantize_kv, quantize_kv_np)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    FIFOScheduler, Request, ServingEngine, from_jax_params)

from serving_heal_cases import GEOM, models

KW = dict(max_slots=2, s_max=32, min_bucket=8, retry_backoff_s=0.0)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """Both tiny GPTs, the prompts, and JAX's detached blocks (whole and
    chunked by 4) of each prompt."""
    jmodel, jparams, model = models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 9)]
    jeng = JaxEngine(jmodel, jparams, **KW)
    blocks = {}
    for chunk in (None, 4):
        for i, p in enumerate(prompts):
            tok0, k, v = jeng.prefill_detached(JaxRequest(p, 6, uid=i),
                                               chunk=chunk)
            blocks[chunk, i] = (tok0, np.asarray(k), np.asarray(v))
    return model, prompts, blocks, jparams


def _engine(model, **kw):
    return ServingEngine(model, **{**KW, **kw})


@pytest.mark.parametrize("chunk", [None, 4])
def test_detached_blocks_match_jax(served, chunk):
    model, prompts, blocks, _ = served
    engine = _engine(model)
    for i, p in enumerate(prompts):
        tok0, k, v = engine.prefill_detached(Request(p, 6, uid=i),
                                             chunk=chunk)
        jtok0, jk, jv = blocks[chunk, i]
        assert tok0 == jtok0
        assert tuple(k.shape) == jk.shape and tuple(v.shape) == jv.shape
        assert np.abs(k.numpy() - jk).max() <= TOL
        assert np.abs(v.numpy() - jv).max() <= TOL
    assert engine.in_flight == 0 and engine.pool.free_slots == 2


def test_quantize_kv_np_bit_equal_to_device_formula():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 16, 2, 16)).astype(np.float32) * 3
    x[0, 0, 3] = 0.0  # an all-zero row: scale 1
    q_np, s_np = quantize_kv_np(x)
    q = quantize_kv(torch.from_numpy(x))
    assert np.array_equal(q.data.numpy(), q_np)
    assert np.array_equal(q.scale.numpy().view(np.uint32),
                          s_np.view(np.uint32))


def _slot_columns(engine, slot, width):
    pool = engine.pool
    if hasattr(pool, "k_pages"):
        table = pool.device_table()[slot]
        out = []
        for pages in (pool.k_pages, pool.v_pages):
            parts = pages.data if hasattr(pages, "data") else pages
            tiles = parts[:, table]  # [L, n, H, ps, Dh]
            out.append(tiles.transpose(2, 3).reshape(
                tiles.shape[0], -1, *tiles.shape[2:3], *tiles.shape[4:])
                [:, :width])
        return out
    caches = (pool.k_caches, pool.v_caches)
    return [(c.data if hasattr(c, "data") else c)[:, slot, :width]
            for c in caches]


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_wire_and_resident_splices_equal_local_admission(served, kv_dtype,
                                                         layout):
    model, prompts, _, _ = served
    kw = dict(kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    p = prompts[2]
    local = _engine(model, **kw)
    request = local.submit(p, 6, uid="x")
    local.step()  # admitted: tok0 out, the prompt's columns spliced
    want = _slot_columns(local, request.slot, len(p))
    donor = _engine(model, kv_dtype=kv_dtype)
    for export in (donor.prefill_detached_wire,
                   donor.prefill_detached_resident):
        tok0, k, v, ks, vs = export(Request(p, 6, uid="x"))
        assert tok0 == request.tokens[0]
        assert (ks is None) == (kv_dtype == "model")
        assert isinstance(k, np.ndarray) == (
            export == donor.prefill_detached_wire)
        engine = _engine(model, **kw)
        moved = Request(p, 6, uid="x")
        engine.admit_prefilled(moved, tok0, k, v, k_scale=ks, v_scale=vs)
        got = _slot_columns(engine, moved.slot, len(p))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for _ in engine.run():
            pass
        for _ in local.run():
            pass
        assert moved.tokens == request.tokens


def test_bf16_wire_block_is_bit_exact():
    """numpy has no bfloat16: the wire carries the raw bits."""
    jmodel, jparams, _ = models()
    model = GPT(**GEOM, dtype=torch.bfloat16)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    engine = _engine(model)
    tok0, k, v, _, _ = engine.prefill_detached_wire(Request([1, 2, 3], 4))
    _, kr, vr, _, _ = engine.prefill_detached_resident(Request([1, 2, 3], 4))
    assert k.dtype == np.uint16
    assert np.array_equal(k, kr.view(torch.int16).numpy().view(np.uint16))
    receiver = _engine(model)
    moved = Request([1, 2, 3], 4, uid="b")
    receiver.admit_prefilled(moved, tok0, k, v)
    assert torch.equal(receiver.pool.k_caches[:, moved.slot, :3],
                       kr[:, 0, :3])


def test_withdraw_leaves_other_streams_exact(served):
    model, prompts, _, _ = served
    base = [r.tokens for r in _engine(model).serve([(p, 6) for p in prompts])]
    engine = _engine(model)
    reqs = [engine.submit(p, 6, uid=i) for i, p in enumerate(prompts)]
    engine.step()
    assert engine.withdraw(0)  # running
    assert engine.withdraw(3)  # queued
    assert not engine.withdraw("nobody")
    for _ in engine.run():
        pass
    for i in (0, 3):
        assert (reqs[i].state, reqs[i].finish_reason) == ("failed",
                                                          "withdraw")
        assert type(reqs[i].error).__name__ == "RequestWithdrawn"
    for i in (1, 2):
        assert reqs[i].tokens == base[i]
    assert engine.metrics.requests_failed == 2


def test_hard_reclaim_returns_every_slot_and_page(served):
    model, prompts, _, _ = served
    engine = _engine(model, kv_layout="paged", page_size=8,
                     prefill_chunk=4, max_slots=3)
    free0 = engine.pool.free_pages
    for i, p in enumerate(prompts):
        engine.submit(p, 6, uid=i)
    for _ in range(20):
        engine.step()
        if engine._running and engine._pending is not None:
            break
    # slots running, a chunked prefill holding its pages, blocks out
    assert engine.pool.free_pages < free0 and engine._pending is not None
    engine.hard_reclaim()
    assert engine.pool.free_slots == engine.pool.max_slots
    assert engine.pool.free_pages == free0
    assert engine._pending is None and not engine._blocks
    engine.hard_reclaim()  # idempotent
    assert engine.pool.free_pages == free0


def test_withdraw_queued_and_scheduler_withdrawals_match_jax(served):
    model, prompts, _, _ = served
    engine = _engine(model, max_slots=1)
    for i, p in enumerate(prompts):
        engine.submit(p, 6, uid=i)
    engine.step()  # one admitted, three queued
    stolen = engine.withdraw_queued(2)
    assert [r.uid for r in stolen] == [3, 2]
    assert all(r.state == "queued" for r in stolen)
    out = []
    for Sched, Req in ((JaxScheduler, JaxRequest), (FIFOScheduler, Request)):
        sched = Sched(32)
        for i in range(4):
            sched.submit(Req([1, 2], 2, uid=i))
        tail = sched.withdraw_tail()
        mid = sched.withdraw_uid(1)
        none = sched.withdraw_uid(9)
        sched.requeue_tail(tail)
        out.append((tail.uid, mid.uid, none,
                    [r.uid for r in sched._queue]))
    assert out[0] == out[1] == (3, 1, None, [0, 2, 3])


def test_record_handoff_matches_jax_wal(tmp_path):
    texts = []
    for h, Req in ((jheal, JaxRequest), (heal, Request)):
        path = tmp_path / f"{h.__name__}.jsonl"
        journal = h.RequestJournal(str(path))
        a, b = Req([1, 2, 3], 4, uid="a"), Req([4, 5], 4, uid="b")
        journal.record_admit(a)
        journal.record_admit(b)
        journal.record_handoff(a, to="r1")
        journal.record_handoff(a, to="r2")  # terminal already: nothing
        journal.record_handoff(b)
        entries = {e.uid: (e.done, e.state, e.reason)
                   for e in journal.entries}
        assert entries == {"a": (True, "handoff", "to:r1"),
                           "b": (True, "handoff", "stolen")}
        assert journal.unfinished() == []
        texts.append(path.read_text())
    assert texts[0] == texts[1]
