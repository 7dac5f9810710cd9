"""The port's serving fault domains against the JAX engine's
(``tests/test_graftfault.py``'s matrix, both engines side by side): the
same six ``serving.*`` sites; under the same ``FaultPlan`` at each site
(a transient ``error:1``, an error outlasting the retries, a fatal) the
same raised error class, failed uids and reasons, transcripts, and
``dispatch_retries``/``requests_failed``/``requests_redelivered``/
``watchdog_trips``/``horizon_collapses`` moves; the watchdog, deadline
eviction, the drain deadline, ``submit_retrying`` and the closed
admission after ``begin_drain`` alike; the retry default repaired; and
the one place the two classify a failure differently on purpose (a real
failure inside a call that writes the pool in place).
"""

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import (
    faults as jfaults)
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu.serving.scheduler import (
    QueueFull as JaxQueueFull)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import faults
from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
    PoolPoisonedError)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    QueueFull, ServingEngine)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    engine as engine_mod)

from serving_heal_cases import ENGINE_KW, models, outcome, prompts

# site -> (admission mode of the engine that reaches it, hits skipped)
SITES = {
    "serving.decode_dispatch": ("chunked", 1),
    "serving.horizon_readback": ("chunked", 1),
    "serving.prefill": ("whole", 0),
    "serving.prefill_chunk": ("chunked", 1),
    "serving.prefill_tok0": ("chunked", 0),
    "serving.slot_insert": ("chunked", 0),
}
MODES = {"chunked": dict(prefill_chunk=4), "whole": {}}
# kind -> FaultRule (kind, times): once, past the 3 default attempts,
# fatal
KINDS = {"transient": ("error", 1), "exhausted": ("error", 3),
         "fatal": ("fatal", 1)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """The tiny GPT in both packages, its prompts, and one engine pair
    per admission mode that survives its faults (reused: the JAX
    engine's programs compile once a pair; both keep the same
    history)."""
    jmodel, jparams, model = models()
    ps = prompts()
    pairs = {mode: _pair(jmodel, jparams, model, **kw)
             for mode, kw in MODES.items()}
    return jmodel, jparams, model, ps, pairs


def _pair(jmodel, jparams, model, **kw):
    kw = {**ENGINE_KW, **kw}
    return JaxEngine(jmodel, jparams, **kw), ServingEngine(model, **kw)


def _both(pair, rule, ps, **kw):
    """One run of each engine of ``pair`` under the same single-rule
    plan ``rule`` = (site, kind, times, after[, hang_s]): (JAX's
    outcome, the port's outcome, faults injected in each)."""
    out, fired = [], []
    for engine, f in zip(pair, (jfaults, faults)):
        site, kind, times, after, *hang = rule
        plan = f.FaultPlan([f.FaultRule(
            site, kind, times=times, after=after,
            **({"hang_s": hang[0]} if hang else {}))])
        with f.armed(plan):
            out.append(outcome(engine, ps, **kw))
        fired.append(plan.triggered())
    return out[0], out[1], fired


def test_serving_sites_match_jax():
    port = {s for s in faults.registered_sites() if s.startswith("serving.")}
    ref = {s for s in jfaults.registered_sites()
           if s.startswith("serving.")}
    assert port == ref == set(SITES)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("site", sorted(SITES))
def test_fault_matrix_matches_jax(served, site, kind):
    jmodel, jparams, model, ps, pairs = served
    mode, after = SITES[site]
    fault, times = KINDS[kind]
    engine_wide = site in ("serving.decode_dispatch",
                           "serving.horizon_readback")
    survives = kind == "transient" or (kind == "exhausted"
                                       and not engine_wide)
    pair = (pairs[mode] if survives
            else _pair(jmodel, jparams, model, **MODES[mode]))
    ref, got, fired = _both(pair, (site, fault, times, after), ps)
    assert fired[0] == fired[1] == times
    assert got == ref
    if kind == "transient":
        assert got["error"] is None and not got["failed"]
        assert got["counts"]["dispatch_retries"] == 1
    elif survives:
        # a per-request site past its retries: that request alone fails
        assert got["error"] is None and len(got["failed"]) == 1
        assert list(got["failed"].values()) == [("error", "FaultInjected")]
    else:
        # engine-wide retries spent fail fast with the last injected
        # error; a fatal one propagates as itself
        assert got["error"] == ("FaultInjected" if kind == "exhausted"
                                else "GraftFaultError")
        assert not pair[1].health.ready and not pair[0].health.ready


def test_watchdog_trips_like_jax(served):
    jmodel, jparams, model, ps, _ = served
    pair = _pair(jmodel, jparams, model, readback_timeout_s=0.2)
    ref, got, fired = _both(
        pair, ("serving.horizon_readback", "hang", 1, 0, 1.0), ps)
    assert fired == [1, 1] and got == ref
    assert got["error"] == "FaultTimeout"
    assert got["counts"]["watchdog_trips"] == 1


def test_deadline_eviction_like_jax(served):
    *_, ps, pairs = served
    jeng, peng = pairs["chunked"]
    ref = outcome(jeng, ps, deadlines=[0.0, None, None, None])
    got = outcome(peng, ps, deadlines=[0.0, None, None, None])
    assert got == ref
    assert got["failed"] == {"r0": ("deadline", "DeadlineExceeded")}
    assert got["counts"]["requests_failed"] == 1


def test_drain_deadline_like_jax(served):
    jmodel, jparams, model, ps, _ = served
    states = []
    for engine in _pair(jmodel, jparams, model):
        reqs = [engine.submit(p, 20, uid=f"r{i}") for i, p in enumerate(ps)]
        engine.step()  # some running, some queued
        engine.begin_drain("test")
        engine.drain(0.0)
        states.append([(r.state, r.finish_reason, type(r.error).__name__,
                        r.tokens) for r in reqs])
        assert engine.pool.occupancy == 0 and engine.in_flight == 0
        assert engine.health.dead
    assert states[0] == states[1]
    assert {s[:3] for s in states[1]} == {
        ("failed", "drain", "DeadlineExceeded")}


def test_submit_retrying_like_jax(served):
    jmodel, jparams, model, ps, _ = served
    runs = []
    for engine, full in zip(_pair(jmodel, jparams, model, max_slots=1,
                                  max_queue=1),
                            (JaxQueueFull, QueueFull)):
        first = engine.submit(ps[0], 2, uid="first")
        with pytest.raises(full):
            engine.submit(ps[1], 2)
        events = []
        request = engine.submit_retrying(ps[1], 2, attempts=64, uid="late",
                                         events_out=events)
        assert events and all(ev[0] is first for ev in events)
        for _ in engine.run():
            pass
        runs.append((request.state, request.tokens, first.tokens,
                     [(ev[1], ev[2]) for ev in events],
                     engine.metrics.snapshot()["requests_shed"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == "done" and runs[1][4] > 1


def test_queue_full_after_begin_drain_like_jax(served):
    jmodel, jparams, model, ps, _ = served
    texts = []
    for engine, full in zip(_pair(jmodel, jparams, model),
                            (JaxQueueFull, QueueFull)):
        engine.begin_drain("sigterm")
        engine.begin_drain("again")  # idempotent
        with pytest.raises(full) as err:
            engine.submit(ps[0], 2)
        texts.append((str(err.value), engine.health.reason,
                      engine.metrics.snapshot()["requests_shed"]))
    assert texts[0] == texts[1]
    assert "DRAINING" in texts[1][0]


def test_default_engine_absorbs_two_transient_dispatch_faults(served):
    """The retry default repaired: JAX's engine retries 3 times by
    default, and the port's default engine now does too."""
    jmodel, jparams, model, ps, _ = served
    kw = dict(max_slots=2, s_max=32, min_bucket=8, decode_horizon=4)
    pair = (JaxEngine(jmodel, jparams, **kw), ServingEngine(model, **kw))
    base = outcome(pair[1], ps)
    ref, got, fired = _both(pair, ("serving.decode_dispatch", "error", 2, 1),
                            ps)
    assert fired == [2, 2] and got == ref
    assert got["error"] is None and got["tokens"] == base["tokens"]
    assert got["counts"]["dispatch_retries"] == 2


def test_pool_writing_failure_is_fatal_in_the_port(served, monkeypatch):
    """Where the port classifies on purpose unlike JAX on the CPU: JAX
    calls a failure inside a pool-DONATING program PoolPoisonedError, and
    its CPU backend donates nothing, so there a real dispatch failure
    propagates as itself and a real insert failure quarantines the
    request. The port writes the pool in place on every device, so a
    real failure inside the decode horizon or the insert splice may
    leave it partly written: PoolPoisonedError, no retry, no
    quarantine."""
    jmodel, jparams, model, ps, _ = served

    def explode(*a, **k):
        raise RuntimeError("simulated kernel failure mid-call")

    jeng, peng = _pair(jmodel, jparams, model)
    jeng._decode = explode
    monkeypatch.setattr(engine_mod, "_decode_horizon", explode)
    ref, got = outcome(jeng, ps), outcome(peng, ps)
    assert ref["error"] == "RuntimeError"
    assert got["error"] == "PoolPoisonedError"
    assert got["counts"]["dispatch_retries"] == 0
    monkeypatch.undo()

    jeng, peng = _pair(jmodel, jparams, model)
    jeng._insert_jit = explode
    monkeypatch.setattr(peng, "_arm_slot", explode)
    ref, got = outcome(jeng, ps), outcome(peng, ps)
    assert ref["error"] is None
    assert ref["failed"]["r0"] == ("error", "RuntimeError")
    assert got["error"] == "PoolPoisonedError" and not got["failed"]
    with pytest.raises(PoolPoisonedError, match="in place"):
        peng._pool_write(explode)
