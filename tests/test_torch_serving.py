"""The port's serving slice against the JAX package's.

Host-side policy (buckets, horizon, FIFO admission, slot accounting) is
held against the JAX code on grids of inputs, exactly. The slice pin:
the port's ``ServingEngine`` serves 5 ragged prompts through 3 slots to
greedy transcripts token-exact with the JAX ``ServingEngine`` running
its Pallas flash-decode kernel in interpret mode, on the same carried
weights, and with the port's own ``generate``.
"""

import itertools

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    FIFOScheduler as JaxFIFO, Request as JaxRequest,
    ServingEngine as JaxEngine, bucket_length as jax_bucket_length,
    init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu.serving.kv_slots import (
    SlotPool as JaxSlotPool)
from pytorch_multiprocessing_distributed_tpu.serving.scheduler import (
    QueueFull as JaxQueueFull, pick_horizon as jax_pick_horizon)
from pytorch_multiprocessing_distributed_tpu.utils.metrics import (
    ServingMetrics as JaxServingMetrics)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import Grid
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    FIFOScheduler, QueueFull, Request, ServingEngine, SlotPool,
    bucket_length, from_jax_params, pick_horizon)
from pytorch_multiprocessing_distributed_tpu_torch.utils import (
    PercentileMeter)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)


@pytest.fixture(scope="module")
def served():
    """tests/test_serving.py's fixture: model, weights, 5 prompts."""
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, 1)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5, 9)]
    return jmodel, jparams, model, prompts


def test_bucket_length_matches_jax():
    for length, mb, s_max in itertools.product(range(1, 70), (1, 8, 16),
                                               (32, 64, 100)):
        assert (bucket_length(length, mb, s_max)
                == jax_bucket_length(length, mb, s_max))


def test_pick_horizon_matches_jax():
    grid = itertools.product((1, 2, 4, 8), (16, 64), (-1, 3, 12, 15, 60),
                             (0, 1, 3, 4, 9), (False, True))
    for h_max, window, max_pos, min_rem, pending in grid:
        assert (pick_horizon(h_max, window, max_pos, min_rem, pending)
                == jax_pick_horizon(h_max, window, max_pos, min_rem,
                                    pending))


def test_fifo_scheduler_matches_jax():
    cases = [([1, 2], 3), ([], 3), ([1], 0), (list(range(30)), 3),
             ([5] * 4, 4), ([7], 1), ([8, 9], 2)]
    port, ref = FIFOScheduler(32, max_queue=3), JaxFIFO(32, max_queue=3)
    for prompt, n in cases:
        outcomes = []
        for sched, req_cls, full in ((port, Request, QueueFull),
                                     (ref, JaxRequest, JaxQueueFull)):
            try:
                sched.submit(req_cls(prompt, n))
                outcomes.append("ok")
            except ValueError:
                outcomes.append("never-fits")
            except full:
                outcomes.append("full")
        assert outcomes[0] == outcomes[1], (prompt, n, outcomes)
    assert port.queue_depth == ref.queue_depth == 3
    while port.queue_depth:
        a, b = port.next_to_admit(), ref.next_to_admit()
        assert a.prompt == b.prompt and a.state == b.state == "running"
    assert port.next_to_admit() is None and ref.next_to_admit() is None


def test_queue_full_is_raised_and_counted(served):
    _, _, model, prompts = served
    engine = ServingEngine(model, max_slots=1, s_max=32, max_queue=2,
                           min_bucket=8)
    engine.submit(prompts[0], 2)
    engine.submit(prompts[1], 2)
    with pytest.raises(QueueFull):
        engine.submit(prompts[2], 2)
    assert engine.metrics.requests_shed == 1


def test_slot_pool_matches_jax(served):
    jmodel, _, model, _ = served
    port, ref = SlotPool(model, 4, 32), JaxSlotPool(jmodel, 4, 32)
    assert tuple(port.k_caches.shape) == tuple(ref.k_caches.shape)
    script = [("acquire",), ("acquire",), ("insert", 0, 7),
              ("insert", 1, 12), ("advance", {0: 3, 1: 1}),
              ("release", 0), ("acquire",), ("insert", 0, 2),
              ("acquire",), ("acquire",), ("release", 3),
              ("advance", {1: 4})]
    for op in script:
        for pool in (port, ref):
            if op[0] == "acquire":
                pool.acquire()
            elif op[0] == "insert":
                pool.note_insert(op[1], op[2])
            elif op[0] == "advance":
                pool.note_advance_slots(op[1])
            else:
                pool.release(op[1])
        assert port.free_slots == ref.free_slots
        assert port.occupancy == ref.occupancy
        assert port.max_active_pos == ref.max_active_pos
    with pytest.raises(ValueError):
        port.release(3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_slot_kv_bytes_matches_jax(dtype):
    import jax.numpy as jnp

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for name in ("gpt_tiny", "gpt_small"):
        assert (SlotPool.per_slot_kv_bytes(get_model(name, dtype=dtype),
                                           1024)
                == JaxSlotPool.per_slot_kv_bytes(
                    jax_models.get_model(name, dtype=jdt), 1024))


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_token_exact_with_jax_pallas_engine(served, horizon):
    """THE slice pin: 5 ragged prompts through 3 slots (requests join
    as others leave), greedy, decode horizon 1 and 4."""
    jmodel, jparams, model, prompts = served
    ref = JaxEngine(jmodel, jparams, max_slots=3, s_max=32, min_bucket=8,
                    decode_attn="pallas", decode_block_k=8,
                    decode_horizon=horizon)
    port = ServingEngine(model, max_slots=3, s_max=32, min_bucket=8,
                         decode_horizon=horizon)
    want = ref.serve([(np.asarray(p), 6) for p in prompts])
    got = port.serve([(p, 6) for p in prompts])
    for a, b, p in zip(got, want, prompts):
        assert a.tokens == b.tokens, f"prompt len {len(p)}"
        assert a.finish_reason == b.finish_reason == "length"
        tail = generate(model, torch.tensor([p]), max_new_tokens=6)
        assert a.tokens == tail[0, -6:].tolist()
    assert set(port.decode_windows) <= set(port.decode_buckets)


def test_eos_finishes_like_jax(served):
    """A request whose greedy stream hits its stop id finishes with
    reason ``eos`` on both engines, same tokens."""
    jmodel, jparams, model, prompts = served
    stream = generate(model, torch.tensor([prompts[1]]),
                      max_new_tokens=6)[0, -6:].tolist()
    eos = stream[2]
    ref = JaxEngine(jmodel, jparams, max_slots=2, s_max=32, min_bucket=8,
                    eos_id=eos)
    port = ServingEngine(model, max_slots=2, s_max=32, min_bucket=8,
                         eos_id=eos, decode_horizon=4)
    want = ref.serve([(np.asarray(p), 6) for p in prompts[:3]])
    got = port.serve([(p, 6) for p in prompts[:3]])
    for a, b in zip(got, want):
        assert (a.tokens, a.finish_reason) == (b.tokens, b.finish_reason)
    assert got[1].finish_reason == "eos" and got[1].tokens[-1] == eos


def test_metrics_snapshot_keys(served):
    _, _, model, prompts = served
    engine = ServingEngine(model, max_slots=2, s_max=32, min_bucket=8,
                           decode_horizon=4)
    engine.serve([(p, 5) for p in prompts[:3]])
    snap = engine.metrics.snapshot()
    assert set(snap) <= set(JaxServingMetrics().snapshot())
    for key in ("requests_completed", "decode_tokens_per_sec",
                "ttft_p50_s", "ttft_p99_s", "decode_step_p50_s",
                "host_syncs_per_token", "overlapped_dispatches"):
        assert key in snap
    assert snap["requests_completed"] == 3
    assert snap["tokens_generated"] == 15
    assert snap["decode_tokens"] == 12


def test_percentile_meter_is_numpy_exact():
    vals = np.random.default_rng(3).random(57).tolist()
    meter = PercentileMeter()
    for v in vals:
        meter.update(v)
    for q in (50, 90, 95, 99):
        assert meter.percentile(q) == pytest.approx(np.percentile(vals, q),
                                                    abs=1e-12)


# the journal and the readback watchdog were refused under a mesh until
# the ranks took the clock's decisions from rank 0 (the name is kept from
# then): a mesh engine takes them now, the bounded retry beside them
@pytest.mark.parametrize("kw", [dict(journal=object(), dispatch_retries=2),
                                dict(readback_timeout_s=0.5),
                                dict(journal="j.jsonl"),
                                dict(readback_timeout_s=1.0),
                                dict(journal=object()),
                                dict(readback_timeout_s=2.0,
                                     dispatch_retries=3)])
def test_unported_engine_features_raise(served, kw):
    _, _, model, _ = served
    engine = ServingEngine(model, max_slots=2, s_max=32, mesh=Grid(1, 1),
                           **kw)
    assert engine.journal is kw.get("journal")
    assert engine._readback_timeout_s == kw.get("readback_timeout_s")
    assert engine._dispatch_retries == kw.get("dispatch_retries", 3)
    assert engine.decisions is None  # this process's clock decides


def test_engine_argument_checks(served):
    _, _, model, prompts = served
    ServingEngine(model, max_slots=2, s_max=32, kv_layout="dense")
    with pytest.raises(TypeError):
        ServingEngine(model, max_slots=2, no_such_option=1)
    with pytest.raises(ValueError, match="CUDA"):
        ServingEngine(model, max_slots=2, s_max=32, decode_attn="cuda")
    with pytest.raises(ValueError, match="generator"):
        ServingEngine(model, max_slots=2, temperature=0.5)
    with pytest.raises(ValueError, match="bind"):
        ServingEngine(GPT(**GEOM), max_slots=2)
    with pytest.raises(ValueError, match="dispatch_retries"):
        ServingEngine(model, max_slots=2, s_max=32, dispatch_retries=0)
    engine = ServingEngine(model, max_slots=2, s_max=32)
    assert engine.submit(prompts[0], 2, deadline_s=1.0).deadline_s == 1.0
    with pytest.raises(ValueError, match="vocab"):
        engine.submit([61], 2)
    engine.begin_drain("test")
    with pytest.raises(QueueFull, match="DRAINING"):
        engine.submit(prompts[1], 2)
