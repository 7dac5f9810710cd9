"""Supervised restart of the port's serving engine against the JAX
package's (``tests/test_graftheal.py``'s restart cases): a fatal at the
decode dispatch, the engine rebuilt over its journal and the unfinished
requests redelivered, dense and paged, token-exact with the
uninterrupted port run and with JAX's transcripts; redelivery absorbing
``QueueFull``; the refusal of a sampled engine; the journal, the
watchdog and both deadlines on a 1 x 1 mesh, whose clock decisions a
replaying rank takes from outside.
"""

import os

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import Grid
from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal
from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
    FaultPlan, FaultRule, armed)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine)

from serving_heal_cases import ENGINE_KW, models, prompts

LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", page_size=8)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """The tiny GPT in both packages, its prompts, and JAX's
    uninterrupted transcripts in each layout."""
    jmodel, jparams, model = models()
    ps = prompts()
    ref = {name: [r.tokens for r in JaxEngine(
        jmodel, jparams, **ENGINE_KW, **kw).serve([(p, 6) for p in ps])]
        for name, kw in LAYOUTS.items()}
    return model, ps, ref


def _supervised(model, ps, path, plan, max_restarts=2, **kw):
    """``tests/test_graftheal.py``'s ``serve_once`` under the port's
    ``Supervisor``: each attempt opens the journal, builds an engine,
    redelivers, submits the prompts once, drains. Returns (the
    supervisor, the last engine, ``{uid: request}``)."""
    submitted = {"done": False}
    finished = {}

    def serve_once(attempt):
        journal = heal.RequestJournal(path, backoff_s=0.0)
        engine = ServingEngine(model, journal=journal, **ENGINE_KW, **kw)
        live = engine.redeliver(journal.unfinished())
        if not submitted["done"]:
            live += [engine.submit(p, 6, uid=i) for i, p in enumerate(ps)]
            submitted["done"] = True
        engine.drain(None)
        for r in live:
            finished[r.uid] = r
        return engine

    sup = heal.Supervisor(serve_once, max_restarts=max_restarts,
                          backoff_s=0.0, sleep=lambda s: None)
    with armed(plan):
        engine = sup.run()
    return sup, engine, finished


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_restart_token_exact(served, tmp_path, layout):
    model, ps, ref = served
    kw = LAYOUTS[layout]
    base = [r.tokens for r in ServingEngine(
        model, **ENGINE_KW, **kw).serve([(p, 6) for p in ps])]
    path = str(tmp_path / "wal.jsonl")
    # the third dispatch dies fatally, after some tokens are out
    plan = FaultPlan([FaultRule("serving.decode_dispatch", "fatal",
                                times=1, after=2)])
    sup, engine, finished = _supervised(model, ps, path, plan, **kw)
    assert plan.triggered() == 1 and sup.restarts == 1
    got = [finished[uid].tokens for uid in sorted(finished)]
    assert got == base == ref[layout]
    assert engine.metrics.requests_redelivered > 0
    assert open(path).read() == ""  # the clean drain compacted it empty
    assert engine.health.dead  # drained


def test_restart_budget_exhaustion_is_loud(served, tmp_path):
    model, ps, _ = served
    path = str(tmp_path / "wal.jsonl")
    plan = FaultPlan([FaultRule("serving.decode_dispatch", "fatal",
                                times=0)])
    with pytest.raises(heal.RestartBudgetExhausted, match="1 restart"):
        _supervised(model, ps, path, plan, max_restarts=1)
    # the WAL keeps every admitted request for a process restart
    assert len(heal.load_journal_entries(path)) == len(ps)


def test_redeliver_absorbs_queue_full(served, tmp_path):
    model, ps, ref = served
    path = str(tmp_path / "wal.jsonl")
    j = heal.RequestJournal(path, backoff_s=0.0)
    crashed = ServingEngine(model, journal=j, **ENGINE_KW)
    for i, p in enumerate(ps):
        crashed.submit(p, 6, uid=i)
    crashed.step()  # some progress, then the "crash"
    j2 = heal.RequestJournal(path, backoff_s=0.0)
    unfinished = j2.unfinished()
    assert len(unfinished) > 1
    tight = ServingEngine(model, journal=j2, max_queue=1, **ENGINE_KW)
    events = []
    red = tight.redeliver(unfinished, events_out=events)
    assert len(red) == len(unfinished) and events
    assert tight.metrics.requests_redelivered == len(unfinished)
    tight.drain(None)
    for r in red:
        assert r.tokens == ref["dense"][r.uid]


def test_redeliver_raises_once_admission_is_closed(served, tmp_path):
    model, ps, _ = served
    j = heal.RequestJournal(str(tmp_path / "wal.jsonl"), backoff_s=0.0)
    engine = ServingEngine(model, journal=j, **ENGINE_KW)
    engine.submit(ps[0], 6, uid=0)
    j2 = heal.RequestJournal(j.path, backoff_s=0.0)
    fresh = ServingEngine(model, journal=j2, **ENGINE_KW)
    fresh.begin_drain("sigterm")
    with pytest.raises(Exception, match="DRAINING"):
        fresh.redeliver(j2.unfinished())


def test_sampled_engine_rejects_journal_as_jax(served, tmp_path):
    import jax

    model, _, _ = served
    jmodel, jparams, _ = models()
    texts = []
    for h, build in (
            (jheal, lambda j: JaxEngine(jmodel, jparams, max_slots=2,
                                        s_max=32, temperature=0.7,
                                        rng=jax.random.PRNGKey(0),
                                        journal=j)),
            (heal, lambda j: ServingEngine(
                model, max_slots=2, s_max=32, temperature=0.7,
                generator=torch.Generator().manual_seed(0), journal=j))):
        journal = h.RequestJournal(str(tmp_path / f"{h.__name__}.jsonl"))
        with pytest.raises(ValueError, match="greedy") as err:
            build(journal)
        texts.append(str(err.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("what", ["journal", "readback_timeout_s",
                                  "submit_deadline", "drain_deadline"])
def test_mesh_refusals_name_roadmap(served, tmp_path, what):
    """The four features a mesh engine refused until the ranks took the
    clock's decisions from rank 0 (``ServingEngine.decisions``) now run
    on a 1 x 1 grid, each with the outcome of the engine without a mesh
    on the same requests. (The name is kept from when they raised.)"""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
        FaultTimeout)

    model, ps, _ = served
    outcomes = []
    for mesh in (None, Grid(1, 1)):
        if what == "journal":
            path = str(tmp_path / f"w-{mesh is not None}.jsonl")
            engine = ServingEngine(model, mesh=mesh, journal=heal.
                                   RequestJournal(path, backoff_s=0.0),
                                   **ENGINE_KW)
            reqs = [engine.submit(p, 6, uid=i) for i, p in enumerate(ps)]
            engine.drain(None)
            assert open(path).read() == ""  # compacted empty
            outcomes.append([r.tokens for r in reqs])
        elif what == "readback_timeout_s":
            engine = ServingEngine(model, mesh=mesh, readback_timeout_s=0.2,
                                   **ENGINE_KW)
            engine.submit(ps[0], 6, uid=0)
            plan = FaultPlan([FaultRule("serving.horizon_readback", "hang",
                                        times=1, hang_s=1.0)])
            with armed(plan), pytest.raises(FaultTimeout):
                for _ in engine.run():
                    pass
            outcomes.append(engine.metrics.watchdog_trips)
        elif what == "submit_deadline":
            engine = ServingEngine(model, mesh=mesh, **ENGINE_KW)
            reqs = [engine.submit(p, 6, uid=i,
                                  deadline_s=0.0 if i == 0 else None)
                    for i, p in enumerate(ps)]
            for _ in engine.run():
                pass
            outcomes.append([(r.state, r.finish_reason, r.tokens)
                             for r in reqs])
        else:
            engine = ServingEngine(model, mesh=mesh, **ENGINE_KW)
            reqs = [engine.submit(p, 20, uid=i) for i, p in enumerate(ps)]
            engine.step()
            engine.drain(0.0)
            outcomes.append([(r.state, r.finish_reason,
                              type(r.error).__name__) for r in reqs])
            assert engine.in_flight == 0 and engine.health.dead
    assert outcomes[0] == outcomes[1]
    if what == "readback_timeout_s":
        assert outcomes[1] == 1
    elif what == "submit_deadline":
        assert outcomes[1][0][:2] == ("failed", "deadline")
    elif what == "drain_deadline":
        assert {o[:2] for o in outcomes[1]} == {("failed", "drain")}


def test_replayed_decisions_must_match_the_state(served):
    """A rank that replays another's decisions applies exactly those
    uids, and raises when one of them is not in flight here."""
    model, ps, _ = served
    engine = ServingEngine(model, mesh=Grid(1, 1), **ENGINE_KW)
    first = engine.submit(ps[0], 6, uid=0, deadline_s=60.0)
    second = engine.submit(ps[1], 6, uid=1, deadline_s=60.0)
    taken = []

    def replay(kind, decide):
        taken.append((kind, decide()))
        return [1] if kind == "expire" else None

    engine.decisions = replay
    engine.step()
    assert taken == [("expire", [])]  # nothing is overdue on this clock
    assert (second.state, second.finish_reason) == ("failed", "deadline")
    assert first.state == "running"
    engine.decisions = lambda kind, decide: ["nobody"]
    with pytest.raises(RuntimeError, match="in flight"):
        engine.step()
