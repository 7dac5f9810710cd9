"""The serving half of the port's ``runtime/heal.py`` against the JAX
package's: the health machine and the ``/healthz`` payload and code, the
request journal (``tests/test_graftheal.py``'s cases through both
modules), byte-identical WAL files for the same operations, each
package reading the other's WAL as its engine wrote it, and the SIGTERM
drain handler on the port's engine.
"""

import json
import signal
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.runtime import (
    scope as jscope)
from pytorch_multiprocessing_distributed_tpu.runtime import store as jstore
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    heal, store)
from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
    GraftFaultError)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    QueueFull, ServingEngine)
from pytorch_multiprocessing_distributed_tpu_torch.serving.scheduler import (
    DONE, FAILED)

from serving_heal_cases import ENGINE_KW, models, prompts

BOTH = [heal, jheal]
IDS = ["port", "jax"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """The tiny GPT in both packages and its prompts: ``(jmodel,
    jparams, model, prompts)``."""
    jmodel, jparams, model = models()
    ps = prompts()
    return jmodel, jparams, model, ps


def _req(uid, prompt=(1, 2, 3), max_new=4, eos=None):
    return SimpleNamespace(uid=uid, prompt=list(prompt),
                           max_new_tokens=max_new, eos_id=eos,
                           state=DONE, finish_reason="eos")


def _entries(entries):
    return [(e.uid, e.prompt, e.max_new_tokens, e.eos_id, e.tokens, e.done,
             e.state, e.reason) for e in entries]


# ------------------------------------------------------- health machine

@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_health_forward_only_transitions(h):
    state = h.HealthState()
    assert state.state == h.STARTING
    state.to_ready()
    assert state.ready and not state.draining
    state.to_draining("sigterm")
    assert state.draining and state.reason == "sigterm"
    state.to_draining("again")  # re-enter: no-op, the first reason stays
    assert state.reason == "sigterm"
    state.to_dead("drained")
    assert state.dead
    with pytest.raises(ValueError, match="backward"):
        state.to_ready()


def _monitor(h, s):
    m = h.HeartbeatMonitor(s.MemStore(), "0", ["0", "1"],
                           soft_timeout_s=1.0, hard_timeout_s=2.0,
                           backoff_s=0.0)
    m.heartbeat.beat()
    return m


def _strip_times(payload):
    out = dict(payload)
    out.pop("since_s")
    if "last_beat_age_s" in out:
        out["last_beat_age_s"] = sorted(out["last_beat_age_s"])
    return out


def test_healthz_payloads_and_codes_match_jax():
    """The payload in every state, with and without a monitor, and the
    HTTP code JAX's stats server answers for it."""
    port, ref = heal.HealthState(), jheal.HealthState()
    pm, jm = _monitor(heal, store), _monitor(jheal, jstore)
    assert heal.healthz(None) == jheal.healthz(None)
    server = jscope.start_stats_server(
        lambda: {}, port=0, health_fn=lambda: jheal.healthz(ref, jm))
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        for step in ("to_ready", "to_draining", "to_dead"):
            getattr(port, step)("test")
            getattr(ref, step)("test")
            got = heal.healthz(port, pm)
            want = jheal.healthz(ref, jm)
            assert _strip_times(got) == _strip_times(want)
            assert _strip_times(heal.healthz(port)) == _strip_times(
                jheal.healthz(ref))
            try:
                with urllib.request.urlopen(url) as r:
                    code = r.status
            except urllib.error.HTTPError as e:
                code = e.code
            assert heal.healthz_code(got) == code
    finally:
        server.shutdown()


# ------------------------------------------------------------- journal

@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_wal_roundtrip_and_unfinished(h, tmp_path):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    a, b = _req(1), _req(2, prompt=(9,), max_new=2)
    j.record_admit(a)
    j.record_admit(b)
    j.note_events([(a, 7, False), (a, 8, False), (b, 5, True)])
    j2 = h.RequestJournal(path, backoff_s=0.0)  # a crash: no close
    unfin = j2.unfinished()
    assert [e.uid for e in unfin] == [1]
    assert unfin[0].tokens == [7, 8] and unfin[0].prompt == [1, 2, 3]
    assert j2.known(2) and j2.known(1) and not j2.known(3)


@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_torn_tail_tolerated(h, tmp_path, capsys):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    j.record_admit(_req(1))
    j._fh.close()
    with open(path, "a") as fh:
        fh.write('{"op": "tok", "uid": 1, "tok')  # a torn append
    j2 = h.RequestJournal(path, backoff_s=0.0)
    assert [e.uid for e in j2.unfinished()] == [1]
    assert "torn" in capsys.readouterr().err


@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_reopen_after_torn_tail_keeps_new_records(h, tmp_path, capsys):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    j.record_admit(_req(1))
    j._fh.close()
    with open(path, "a") as fh:
        fh.write('{"op": "tok", "uid": 1, "tok')
    j2 = h.RequestJournal(path, backoff_s=0.0)
    a = _req(1)
    j2.record_admit(a)  # idempotent
    j2.record_admit(_req(2))
    j2.note_events([(a, 7, False)])
    j3 = h.RequestJournal(path, backoff_s=0.0)
    assert [e.uid for e in j3.unfinished()] == [1, 2]
    assert j3.unfinished()[0].tokens == [7]
    assert capsys.readouterr().err.count("torn") >= 1


@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_replay_prefix_dedup_and_divergence(h, tmp_path):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    a = _req(1)
    j.record_admit(a)
    j.note_events([(a, 7, False)])
    j2 = h.RequestJournal(path, backoff_s=0.0)
    a2 = _req(1)
    j2.record_admit(a2)
    j2.note_events([(a2, 7, False), (a2, 9, False)])
    j3 = h.RequestJournal(path, backoff_s=0.0)
    assert j3.unfinished()[0].tokens == [7, 9]
    j4 = h.RequestJournal(path, backoff_s=0.0)
    a3 = _req(1)
    j4.record_admit(a3)
    with pytest.raises(Exception, match="diverged") as err:
        j4.note_events([(a3, 6, False)])
    assert type(err.value).__name__ == "GraftFaultError"


@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_close_compacts_atomically(h, tmp_path):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    a, b = _req(1), _req(2)
    j.record_admit(a)
    j.record_admit(b)
    j.note_events([(a, 7, True), (b, 5, False)])
    j.close()
    lines = [json.loads(x) for x in open(path) if x.strip()]
    assert [x["op"] for x in lines] == ["admit", "tok"]
    assert lines[0]["uid"] == 2 and lines[1]["tokens"] == [5]


@pytest.mark.parametrize("h", BOTH, ids=IDS)
def test_record_failed_is_terminal(h, tmp_path):
    path = str(tmp_path / "wal.jsonl")
    j = h.RequestJournal(path, backoff_s=0.0)
    a = _req(1)
    a.state, a.finish_reason = FAILED, "error"
    j.record_admit(a)
    j.record_failed(a)
    assert h.RequestJournal(path, backoff_s=0.0).unfinished() == []


def _operations(h, path):
    """One sequence of journal operations: admits, token batches, a
    finish, a failure, a redelivered prefix, a compaction."""
    j = h.RequestJournal(path, backoff_s=0.0)
    a, b, c = _req("src-0"), _req("src-1", (4, 5), 3, eos=2), _req(7)
    for r in (a, b, c):
        j.record_admit(r)
    j.note_events([(a, 11, False), (b, 12, False), (c, 13, False)])
    b.finish_reason = "length"
    j.note_events([(a, 14, False), (b, 15, True)])
    c.state, c.finish_reason = FAILED, "deadline"
    j.record_failed(c)
    j.record_admit(a)  # idempotent
    with open(path, "rb") as f:
        wal = f.read()
    j2 = h.RequestJournal(path, backoff_s=0.0)
    a2 = _req("src-0")
    j2.record_admit(a2)
    j2.note_events([(a2, 11, False), (a2, 14, False), (a2, 16, False)])
    with open(path, "rb") as f:
        replayed = f.read()
    j2.close()
    with open(path, "rb") as f:
        compacted = f.read()
    return wal, replayed, compacted


def test_wal_bytes_identical_to_jax(tmp_path):
    port = _operations(heal, str(tmp_path / "port.jsonl"))
    ref = _operations(jheal, str(tmp_path / "jax.jsonl"))
    assert port == ref
    assert port[2]  # src-0 is still unfinished after the compaction


def _crashed_wal(engine_cls, model, params, ps, path, h, **kw):
    """A WAL an engine left mid-serve: every request admitted, two
    steps run, then the process "dies" (the journal is never closed)."""
    journal = h.RequestJournal(path, backoff_s=0.0)
    args = (model,) if params is None else (model, params)
    engine = engine_cls(*args, journal=journal, **ENGINE_KW, **kw)
    for i, p in enumerate(ps):
        engine.submit(p, 6, uid=f"src-{i}")
    engine.step()
    engine.step()
    engine.submit(ps[0], 2, uid="late")
    return journal


def test_each_package_reads_the_others_engine_wal(served, tmp_path):
    jmodel, jparams, model, ps = served
    pj = _crashed_wal(ServingEngine, model, None, ps,
                      str(tmp_path / "port.jsonl"), heal)
    jj = _crashed_wal(JaxEngine, jmodel, jparams, ps,
                      str(tmp_path / "jax.jsonl"), jheal)
    for path in (pj.path, jj.path):
        assert (_entries(jheal.load_journal_entries(path))
                == _entries(heal.load_journal_entries(path)))
    # the two engines journaled the same requests and tokens
    assert (_entries(heal.load_journal_entries(pj.path))
            == _entries(jheal.load_journal_entries(jj.path)))
    assert any(e.tokens for e in heal.load_journal_entries(pj.path))
    with open(pj.path, "rb") as f, open(jj.path, "rb") as g:
        assert f.read() == g.read()
    # and a port engine redelivers JAX's WAL token-exact with its own
    baseline = {f"src-{i}": r.tokens for i, r in enumerate(
        ServingEngine(model, **ENGINE_KW).serve([(p, 6) for p in ps]))}
    journal = heal.RequestJournal(jj.path, backoff_s=0.0)
    engine = ServingEngine(model, journal=journal, **ENGINE_KW)
    red = engine.redeliver(journal.unfinished())
    engine.drain(None)
    got = {r.uid: r.tokens for r in red if r.uid != "late"}
    assert got == {u: baseline[u] for u in got} and got
    assert open(jj.path).read() == ""


def test_missing_wal_is_an_empty_journal(tmp_path):
    path = str(tmp_path / "none.jsonl")
    assert heal.load_journal_entries(path) == []
    assert jheal.load_journal_entries(path) == []


def test_journal_write_fault_retries_then_fails_named(tmp_path):
    from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
        FaultPlan, FaultRule, armed)

    j = heal.RequestJournal(str(tmp_path / "w.jsonl"), backoff_s=0.0)
    with armed(FaultPlan([FaultRule("heal.journal_write", "error",
                                    times=2)])):
        j.record_admit(_req(1))  # two transient failures absorbed
    assert j.known(1)
    with armed(FaultPlan([FaultRule("heal.journal_write", "error",
                                    times=0)])):
        with pytest.raises(GraftFaultError, match="journal append"):
            j.record_admit(_req(2))


# ------------------------------------------------------- drain handler

def test_sigterm_flips_draining_and_admission_closes(served):
    """The chaining handler on the port's engine: SIGTERM mid-serve ->
    DRAINING, admission refused naming the drain, in-flight requests
    still finish, the previous handler fires too and comes back."""
    _, _, model, ps = served
    baseline = [r.tokens for r in ServingEngine(model, **ENGINE_KW).serve(
        [(p, 6) for p in ps])]
    engine = ServingEngine(model, **ENGINE_KW)
    outer = {"fired": 0}

    def counting_handler(s, f):
        outer["fired"] += 1

    prev0 = signal.signal(signal.SIGTERM, counting_handler)
    try:
        prev = heal.install_drain_handler(engine)
        reqs = [engine.submit(p, 6) for p in ps]
        engine.step()
        signal.raise_signal(signal.SIGTERM)
        assert engine.health.draining and outer["fired"] == 1
        with pytest.raises(QueueFull, match="DRAINING"):
            engine.submit(ps[0], 4)
        assert engine.metrics.requests_shed == 1
        assert engine.drain(None)
        assert [r.state for r in reqs] == [DONE] * 4
        assert [r.tokens for r in reqs] == baseline
        assert engine.health.dead and engine.pool.occupancy == 0
        heal.restore_drain_handler(prev)
        assert signal.getsignal(signal.SIGTERM) is counting_handler
    finally:
        signal.signal(signal.SIGTERM, prev0)
