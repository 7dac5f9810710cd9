"""The port's fleet router (``serving/router.py``, ``replica.py``)
against the JAX package's, on JAX ``tests/test_graftroute.py``'s cases:
the tiny GPT (2 layers, 2 heads, f32) carried from JAX, its prompts,
and JAX's single-engine streams as the reference.

Every stream through the port's fleet equals JAX's single engine, in
both roles, split dense and split paged with chunked prefill, across a
replica's death (journal and records) and a whole-fleet recovery;
placement, the window's halving, the ``FleetSaturated`` shed and its
words, the transfer's refusals and ``merged_metrics``/``healthz`` key
for key equal JAX's router on the same replicas' settings. No wall-clock
assertion (JAX's TTFT ratio is left out).
"""

import json

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.serving import (
    FleetSaturated as JaxFleetSaturated, QueueFull as JaxQueueFull,
    Request as JaxRequest, Router as JaxRouter,
    ServingEngine as JaxEngine, ServingReplica as JaxReplica)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    faults, heal)
from pytorch_multiprocessing_distributed_tpu_torch.runtime.scope import (
    prometheus_text)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    FleetDead, FleetSaturated, PageTransfer, PrefixCacheDirectory,
    QueueFull, Request, Router, ServingEngine, ServingReplica)

from serving_heal_cases import models

KW = dict(max_slots=2, s_max=32, min_bucket=8, retry_backoff_s=0.0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """Both packages' tiny GPT, the prompts, JAX's single-engine streams
    (max_new 6) and one JAX fleet of two replicas run to its end."""
    jmodel, jparams, model = models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist()
               for n in (3, 7, 12, 5, 9, 6)]
    done = JaxEngine(jmodel, jparams, **KW).serve([(p, 6) for p in prompts])
    baseline = {i: list(r.tokens) for i, r in enumerate(done)}
    jrouter = JaxRouter([JaxReplica("r0", JaxEngine(jmodel, jparams, **KW)),
                         JaxReplica("r1", JaxEngine(jmodel, jparams, **KW))])
    jout = jrouter.serve([(p, 6) for p in prompts])
    return dict(jmodel=jmodel, jparams=jparams, model=model,
                prompts=prompts, baseline=baseline, jrouter=jrouter,
                jout=jout)


def _engine(s, **kw):
    return ServingEngine(s["model"], **{**KW, **kw})


def _jengine(s, **kw):
    return JaxEngine(s["jmodel"], s["jparams"], **{**KW, **kw})


def _keys(d):
    """A nested dict's key paths (its values apart)."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict) and k != "fleet_admit_windows":
            out |= {f"{k}/{sub}" for sub in _keys(v)}
    return out


def test_fleet_streams_equal_jax(served):
    s = served
    router = Router([ServingReplica("r0", _engine(s)),
                     ServingReplica("r1", _engine(s))])
    out = router.serve([(p, 6) for p in s["prompts"]])
    for i, request in enumerate(out):
        assert request.state == "done"
        assert list(request.tokens) == s["baseline"][i], f"stream {i}"
    merged, jmerged = router.merged_metrics(), s["jrouter"].merged_metrics()
    assert merged["tokens_generated"] == sum(map(len,
                                                 s["baseline"].values()))
    per = merged["per_replica"]
    assert all(v["requests_completed"] > 0 for v in per.values())
    # the same placement as JAX's fleet, request by request
    assert ([router._assigned[r.uid] for r in out]
            == [s["jrouter"]._assigned[r.uid] for r in s["jout"]])
    for key in ("tokens_generated", "requests_completed", "decode_tokens",
                "fleet_steals", "fleet_transfers_routed", "fleet_replicas"):
        assert merged[key] == jmerged[key], key


def test_merged_metrics_and_healthz_match_jax_key_for_key(served):
    s = served
    router = Router([ServingReplica("r0", _engine(s)),
                     ServingReplica("r1", _engine(s))])
    router.serve([(p, 6) for p in s["prompts"]])
    jrouter = s["jrouter"]
    assert _keys(router.merged_metrics()) == _keys(jrouter.merged_metrics())
    assert _keys(router.healthz()) == _keys(jrouter.healthz())
    assert router.healthz()["state_name"] == jrouter.healthz()["state_name"]
    text = prometheus_text(router.merged_metrics(), "pmdt_fleet")
    assert "pmdt_fleet_tokens_generated" in text
    assert "per_replica" not in text
    assert "goodput_frac" in json.dumps(router.merged_metrics())


def test_placement_and_window_halving_match_jax(served):
    """Submissions only (nothing runs): the same replica for each
    request, the same holds, the same AIMD windows."""
    s = served
    states = []
    for R, Rep, eng in ((JaxRouter, JaxReplica, _jengine),
                        (Router, ServingReplica, _engine)):
        r0 = Rep("r0", eng(s), window_max=3)
        r1 = Rep("r1", eng(s), window_max=3)
        router = R([r0, r1])
        uids = [router.submit(p, 2, uid=f"u{i}").uid
                for i, p in enumerate(s["prompts"][:2])]
        for j in range(r0.window + r1.window):
            router.submit(s["prompts"][2], 2, uid=f"h{j}")
        w = r0.window
        r0.note_pressure()
        halved = r0.window
        r0._holds_base = r0.engine.metrics.page_holds
        r0._shed_base = r0.engine.metrics.requests_shed
        r0.poll_pressure()
        states.append((dict(router._assigned), len(router._pending), w,
                       halved, r0.window, uids))
    assert states[0] == states[1]
    assigned, pending, w, halved, grown, uids = states[1]
    assert {assigned[u] for u in uids} == {"r0", "r1"} and pending > 0
    assert halved == max(1, w // 2) and grown == halved + 1


def test_fleet_saturated_shed_and_words_match_jax(served):
    s = served
    out = []
    for R, Rep, eng, Sat, QF in (
            (JaxRouter, JaxReplica, _jengine, JaxFleetSaturated,
             JaxQueueFull),
            (Router, ServingReplica, _engine, FleetSaturated, QueueFull)):
        router = R([Rep("r0", eng(s, max_queue=1))], max_pending=1)
        n_ok = 0
        with pytest.raises(Sat) as err:
            for _ in range(64):
                router.submit(s["prompts"][0], 4)
                n_ok += 1
        assert isinstance(err.value, QF)
        out.append((n_ok, router.requests_shed_fleet, str(err.value)))
    assert out[0] == out[1] and out[1][0] >= 2 and out[1][1] == 1


def test_work_stealing_journals_the_handoff(served, tmp_path):
    s = served
    journal = heal.RequestJournal(str(tmp_path / "victim.jsonl"))
    victim = ServingReplica("victim", _engine(s, journal=journal),
                            journal=journal)
    thief = ServingReplica("thief", _engine(s))
    router = Router([victim, thief])
    reqs = [victim.engine.submit(p, 6, uid=f"v{i}")
            for i, p in enumerate(s["prompts"])]
    while router.in_flight:
        router.step()
    assert router.steals >= 1
    stolen = [u for u, rid in router._assigned.items() if rid == "thief"]
    assert stolen
    for i, request in enumerate(reqs):
        assert request.state == "done"
        assert list(request.tokens) == s["baseline"][i]
    entries = {e.uid: e for e in journal.entries}
    for uid in stolen:
        assert entries[uid].done and entries[uid].state == "handoff"


def test_page_transfer_and_directory():
    request = Request([1, 2, 3], 4, uid="t")
    k = np.zeros((2, 1, 8, 2, 16), np.float32)
    transfer = PageTransfer(request, 5, k, np.ones_like(k), src_rid="pf")
    assert transfer.nbytes == 2 * k.nbytes and not transfer.resident
    assert (transfer.tok0, transfer.request, transfer.src_rid) == (
        5, request, "pf")
    t = torch.zeros(2, 1, 8, 2, 16)
    assert PageTransfer(request, 5, t, t).resident
    d = PrefixCacheDirectory(page_size=4)
    d.register(list(range(10)), "r0")
    d.register(list(range(100, 104)), "r1")
    assert d.lookup(list(range(10))) == "r0"
    assert d.lookup(list(range(8)) + [99]) == "r0"
    assert d.lookup(list(range(4)) + [99]) == "r0"
    assert d.lookup([99, 98, 97]) is None
    assert d.lookup(list(range(100, 104)) + [1]) == "r1"
    d.drop_replica("r0")
    assert d.lookup(list(range(10))) is None
    d.register([1, 2], "r2")
    assert d.lookup([1, 2]) is None
    assert d.hot_prompts(1) == [tuple(range(100, 104))]


def test_prefix_hit_routed_to_holding_replica(served):
    s = served
    rng = np.random.default_rng(7)

    def mk():
        return _engine(s, kv_layout="paged", page_size=8, prefix_cache=4)

    router = Router([ServingReplica("p0", mk()), ServingReplica("p1", mk())])
    warm = rng.integers(0, 61, (16,)).tolist()
    first = router.serve([(warm, 4)])[0]
    holder = router._assigned[first.uid]
    router.serve([(warm, 4)])
    hit = router.serve([(warm, 4)])[0]
    assert router._assigned[hit.uid] == holder
    assert router.prefix_routed >= 2
    assert router._by_rid[holder].engine.metrics.prefix_hits == 2
    assert list(hit.tokens) == list(first.tokens)
    want = _jengine(s).serve([(warm, 4)])[0].tokens
    assert list(first.tokens) == list(want)


@pytest.mark.parametrize("layout", ["dense", "paged_chunked"])
def test_split_matches_monolithic(served, layout):
    s = served
    pf_kw, dc_kw = (({}, {}) if layout == "dense" else
                    (dict(prefill_chunk=4),
                     dict(kv_layout="paged", page_size=8)))
    router = Router([
        ServingReplica("pf", _engine(s, **pf_kw), role="prefill"),
        ServingReplica("dc", _engine(s, **dc_kw), role="decode")])
    out = router.serve([(p, 6) for p in s["prompts"]])
    for i, request in enumerate(out):
        assert request.state == "done"
        assert list(request.tokens) == s["baseline"][i], f"stream {i}"
    assert router.transfers_routed == len(s["prompts"])
    assert router.transfer_bytes > 0
    assert router._by_rid["pf"].engine.metrics.decode_tokens == 0
    assert router._by_rid["pf"].transfers_out == len(s["prompts"])


def test_admit_prefilled_backpressure_words_match_jax(served):
    s = served
    words = []
    for eng, Req in ((_jengine, JaxRequest), (_engine, Request)):
        donor = eng(s)
        engine = eng(s, max_slots=1)
        engine.pool.acquire()  # the one slot is taken
        tok0, k, v = donor.prefill_detached(Req(s["prompts"][1], 4,
                                                uid="a"))
        k, v = np.asarray(k), np.asarray(v)
        with pytest.raises(Exception) as full:
            engine.admit_prefilled(Req(s["prompts"][3], 4, uid="b"),
                                   tok0, k, v)
        paged = eng(s, kv_layout="paged", page_size=8, num_pages=4)
        with pytest.raises(ValueError) as pages:
            paged.admit_prefilled(Req([1] * 20, 8, uid="big"), 0, k, v)
        with pytest.raises(ValueError) as quant:
            paged.admit_prefilled(Req([1] * 4, 2, uid="q"), 0, k, v,
                                  k_scale=k[..., 0], v_scale=v[..., 0])
        words.append((type(full.value).__name__, str(full.value),
                       str(pages.value), str(quant.value)))
    assert words[0] == words[1]
    assert words[1][0] == "QueueFull" and "free slot" in words[1][1]
    assert "page" in words[1][2]


def _journaled(s, tmp_path, i, **kw):
    journal = heal.RequestJournal(str(tmp_path / f"wal{i}.jsonl"))
    return ServingReplica(f"r{i}", _engine(s, journal=journal, **kw),
                          journal=journal)


def test_replica_death_redelivers_token_exact(served, tmp_path):
    s = served
    router = Router([_journaled(s, tmp_path, i, dispatch_retries=1)
                     for i in range(2)])
    for i, p in enumerate(s["prompts"]):
        router.submit(p, 6, uid=f"u{i}")
    for _ in range(3):
        router.step()
    plan = faults.FaultPlan([faults.FaultRule(
        "serving.decode_dispatch", "fatal", times=1)], seed=1)
    with faults.armed(plan):
        while router.in_flight:
            router.step()
    assert sum(r.reaped for r in router.replicas) == 1
    assert router.requests_redelivered >= 1
    recs = router.records()
    for i in range(len(s["prompts"])):
        assert recs[f"u{i}"].state == "done"
        assert list(recs[f"u{i}"].tokens) == s["baseline"][i]
    merged = router.merged_metrics()
    assert merged["tokens_generated"] == sum(map(len,
                                                 s["baseline"].values()))
    assert merged["redelivery_replayed_tokens"] > 0
    hz = router.healthz()
    assert hz["state_name"] == "READY"
    dead = next(r for r in router.replicas if r.reaped)
    assert hz["replicas"][dead.rid]["state_name"] == "DEAD"
    # the reaped engine's residency went back
    assert dead.engine.pool.free_slots == dead.engine.pool.max_slots
    assert not dead.engine._running and not dead.engine._blocks


def test_whole_fleet_death_is_named(served):
    s = served
    router = Router([ServingReplica("solo", _engine(s, dispatch_retries=1))])
    router.submit(s["prompts"][0], 6)
    plan = faults.FaultPlan([faults.FaultRule(
        "serving.decode_dispatch", "fatal", times=1)], seed=1)
    with faults.armed(plan), pytest.raises(FleetDead):
        for _ in range(64):
            router.step()


def test_draining_replica_refuses_but_finishes(served):
    s = served
    r0, r1 = (ServingReplica(f"r{i}", _engine(s)) for i in range(2))
    router = Router([r0, r1])
    first = router.submit(s["prompts"][0], 6)
    draining = router._by_rid[router._assigned[first.uid]]
    other = r1 if draining is r0 else r0
    draining.engine.begin_drain("test")
    hz = router.healthz()
    assert hz["state_name"] == "READY"
    assert hz["replicas"][draining.rid]["state_name"] == "DRAINING"
    later = [router.submit(p, 6) for p in s["prompts"][1:4]]
    assert all(router._assigned[r.uid] == other.rid for r in later)
    while router.in_flight:
        router.step()
    for i, request in enumerate([first] + later):
        assert list(request.tokens) == s["baseline"][i]


def test_fleet_drain_and_recover(served, tmp_path):
    s = served

    def mkfleet():
        return Router([_journaled(s, tmp_path, i) for i in range(2)])

    router = mkfleet()
    for i, p in enumerate(s["prompts"]):
        router.submit(p, 6, uid=f"u{i}")
    for _ in range(3):
        router.step()
    prefix = {uid: list(r.tokens) for uid, r in router.records().items()}
    del router  # abandoned mid-run: the WALs are not closed
    fresh = mkfleet()
    assert fresh.recover()
    while fresh.in_flight:
        fresh.step()
    recs = fresh.records()
    for i in range(len(s["prompts"])):
        toks = list(recs[f"u{i}"].tokens)
        assert toks == s["baseline"][i]
        assert toks[:len(prefix[f"u{i}"])] == prefix[f"u{i}"]
    fresh.drain(None)
    assert fresh.healthz()["state_name"] == "DEAD"
    for i in range(2):
        assert (tmp_path / f"wal{i}.jsonl").read_text() == ""


def test_unbounded_drain_terminates_with_held_work(served):
    s = served
    router = Router([ServingReplica("r0", _engine(s), window_max=1)])
    placed = router.submit(s["prompts"][0], 4)
    held = router.submit(s["prompts"][1], 4)
    assert len(router._pending) == 1
    assert router.drain(None)
    assert placed.state == "done" and placed.tokens
    assert (held.state, held.finish_reason) == ("failed", "drain")
    assert router.healthz()["state_name"] == "DEAD"


def test_reap_skips_router_held_uids(served):
    """A journal-less prefill replica's death re-routes its intake (the
    router's records rebuild nothing here: every uid rides a held
    path), and each stream is served once."""
    s = served
    pf = ServingReplica("pf", _engine(s), role="prefill")
    dc = ServingReplica("dc", _engine(s), role="decode")
    router = Router([pf, dc])
    reqs = [router.submit(p, 6, uid=f"u{i}")
            for i, p in enumerate(s["prompts"][:3])]
    dc.window = 0
    router.step()
    assert len(router._transfers) == 1
    pf.engine.health.to_dead("test")
    dc.window = 0
    router.step()
    assert len(router._pending) == 2 and router.requests_redelivered == 0
    dc.window = dc.window_max
    while router.in_flight:
        router.step()
    merged = router.merged_metrics()
    assert merged["requests_completed"] == 3
    for i, request in enumerate(reqs):
        assert list(router.records()[request.uid].tokens) == \
            s["baseline"][i]


def test_records_redeliver_without_a_journal(served):
    """A journal-less decode replica's death: the router's own records
    rebuild the entries, redelivered token-exact."""
    s = served
    router = Router([ServingReplica(f"r{i}", _engine(s, dispatch_retries=1))
                     for i in range(2)])
    for i, p in enumerate(s["prompts"]):
        router.submit(p, 6, uid=f"u{i}")
    router.step()
    plan = faults.FaultPlan([faults.FaultRule(
        "serving.decode_dispatch", "fatal", times=1)], seed=1)
    with faults.armed(plan):
        while router.in_flight:
            router.step()
    assert router.requests_redelivered >= 1
    for i in range(len(s["prompts"])):
        assert list(router.records()[f"u{i}"].tokens) == s["baseline"][i]
    assert router.merged_metrics()["tokens_generated"] == sum(
        map(len, s["baseline"].values()))


def test_split_backpressure_bounds_intake(served):
    s = served
    pf = ServingReplica("pf", _engine(s), role="prefill", window_max=2)
    dc = ServingReplica("dc", _engine(s), role="decode")
    router = Router([pf, dc], max_pending=1)
    router.submit(s["prompts"][0], 4)
    router.submit(s["prompts"][1], 4)
    assert len(pf._prefill_queue) == 2
    router.submit(s["prompts"][2], 4)
    assert len(router._pending) == 1
    with pytest.raises(FleetSaturated):
        router.submit(s["prompts"][3], 4)
    assert not router._transfer_backlog_full()
    dc.window = 0
    assert router._transfer_backlog_full()
    dc.window = dc.window_max
    for _ in router.run():
        pass
    assert all(r.state == "done" for r in router.records().values())


def test_invalid_request_fails_named(served):
    s = served
    r0 = ServingReplica("r0", _engine(s), window_max=1)
    router = Router([r0])
    bad = [61 + 5, 1, 2]
    with pytest.raises(ValueError):
        router.submit(bad, 4, uid="direct")
    assert "direct" not in router.records()
    good = router.submit(s["prompts"][0], 4, uid="good")
    held = router.submit(bad, 4, uid="held")
    while router.in_flight:
        router.step()
    assert good.state == "done" and good.tokens
    assert held.state == "failed" and isinstance(held.error, ValueError)
    assert not r0.dead


def test_splice_fatal_reaps_and_redelivers_once(served):
    s = served
    pf = ServingReplica("pf", _engine(s), role="prefill")
    d1 = ServingReplica("d1", _engine(s), role="decode")
    d2 = ServingReplica("d2", _engine(s), role="decode")
    router = Router([pf, d1, d2])

    def boom(*a, **kw):
        raise RuntimeError("poisoned splice")

    d1.engine.admit_prefilled = boom
    request = router.submit(s["prompts"][0], 6, uid="u0")
    while router.in_flight:
        router.step()
    assert d1.reaped and d1.dead and not d2.dead
    assert router.requests_redelivered == 0
    assert list(router.records()[request.uid].tokens) == s["baseline"][0]
    merged = router.merged_metrics()
    assert merged["requests_completed"] == 1
    assert merged["tokens_generated"] == len(s["baseline"][0])


def test_recover_dedups_uid_across_wals(served, tmp_path):
    """One uid admitted and unfinished in two WALs (a crash inside the
    steal's handoff window) is redelivered once, as JAX's recover does
    on copies of the same WALs."""
    s = served
    request = Request(s["prompts"][0], 6, None, "u0")
    counts = []
    for tag, h, Rep, eng, R in (("jax", jheal, JaxReplica, _jengine,
                                 JaxRouter),
                                ("port", heal, ServingReplica, _engine,
                                 Router)):
        paths = [str(tmp_path / f"{tag}{i}.jsonl") for i in range(2)]
        for path in paths:
            h.RequestJournal(path).record_admit(request)
        reps = []
        for i, path in enumerate(paths):
            journal = h.RequestJournal(path)
            reps.append(Rep(f"r{i}", eng(s, journal=journal),
                            journal=journal))
        router = R(reps)
        counts.append(len(router.recover()))
    assert counts == [1, 1]
    while router.in_flight:
        router.step()
    assert list(router.records()["u0"].tokens) == s["baseline"][0]
    assert router.merged_metrics()["requests_completed"] == 1


def test_replica_membership(served):
    """``add_replica``/``remove_replica`` (the autoscaler's): a joined
    replica takes work, a removed dead one folds its counters in."""
    s = served
    router = Router([ServingReplica("r0", _engine(s))])
    router.serve([(s["prompts"][0], 4)])
    extra = ServingReplica("r1", _engine(s))
    router.add_replica(extra)
    with pytest.raises(ValueError, match="duplicate"):
        router.add_replica(extra)
    with pytest.raises(ValueError, match="drain it"):
        router.remove_replica("r1")
    before = router.merged_metrics()["tokens_generated"]
    r0 = router._by_rid["r0"]
    r0.engine.drain(None)
    router.remove_replica("r0")
    assert router.merged_metrics()["tokens_generated"] == before
    assert router.merged_metrics()["fleet_replicas_retired"] == 1
    out = router.serve([(s["prompts"][1], 6)])
    assert list(out[0].tokens) == s["baseline"][1]
