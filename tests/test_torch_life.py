"""The port's ownership ledger against the JAX package's.

``OwnershipLedger`` gives JAX's counts and audit findings for the same
acquire/release script (one test over both modules; acquire sites and
ages differ by file and clock and are cut from the findings), and the
request journal's life sites (its file and one hold per admitted
request, released when the request is terminal) leave both packages'
ledgers empty after the same serve, drain and close. The engine's slot
and page holds are audited in ``tests/test_torch_scope_engine.py``.
"""

import gc
import re
import threading

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.runtime import life as jlife
from pytorch_multiprocessing_distributed_tpu.serving.scheduler import (
    Request as JaxRequest)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal, life
from pytorch_multiprocessing_distributed_tpu_torch.serving import Request

MODS = pytest.mark.parametrize("mod", [jlife, life], ids=["jax", "port"])


class _Loan:
    """A weak-referenceable stand-in for a pooled buffer."""


def _script(m):
    led = m.OwnershipLedger()
    led.acquire("slot", ("pool", 0))
    led.acquire("slot", ("pool", 1), holder="r1")
    led.tag("slot", ("pool", 0), "r0")
    led.release("slot", ("pool", 1))
    led.release("slot", ("pool", 9))  # a grant armed mid-life
    led.acquire("page", ("pool", 3))
    led.acquire("page", ("pool", 3))  # double acquire: an anomaly
    loan = _Loan()
    led.acquire("buffer", 1, obj=loan)
    thread = threading.Thread(target=lambda: None)
    thread.start()
    thread.join()
    led.acquire("thread", "t", obj=thread)
    del loan
    gc.collect()
    findings = [re.sub(r" acquired at \S+ [0-9.]+s ago", "", f)
                .replace(" granted at", "").split(" and again at")[0]
                for f in led.audit_drained("drain")]
    return (led.counts(), dict(led.acquired), dict(led.released),
            dict(led.unmatched_releases), findings)


@MODS
def test_ledger_audit_equals_jax(mod):
    got, want = _script(mod), _script(jlife)
    assert got == want
    assert got[0]["slot"] == 1 and got[0]["page"] == 1
    assert len(got[4]) == 3  # the slot, the page, the double acquire
    assert mod.active_ledger() is None
    with mod.armed() as led:
        assert mod.active_ledger() is led
    assert mod.active_ledger() is None


def _journal(pkg, path):
    """Admit three requests, finish one, fail one, leave one open;
    close. The ledger's live holds before and after the close."""
    lf, hl, req = ((jlife, jheal, JaxRequest) if pkg == "jax"
                   else (life, heal, Request))
    with lf.armed() as led:
        journal = hl.RequestJournal(str(path))
        reqs = [req([1, 2, 3], 4, uid=f"r{i}") for i in range(3)]
        for r in reqs:
            journal.record_admit(r)
        journal.record_admit(reqs[0])  # a redelivery appends nothing
        reqs[0].state, reqs[0].finish_reason = "done", "length"
        journal.note_events([(reqs[0], 7, False), (reqs[0], 8, True)])
        reqs[1].state, reqs[1].finish_reason = "failed", "error"
        journal.record_failed(reqs[1])
        before = led.counts()
        audit_open = len(led.audit_drained())
        journal.close()
        return before, audit_open, led.counts(), led.audit_drained()


def test_journal_holds_equal_jax(tmp_path):
    got = _journal("port", tmp_path / "port.jsonl")
    want = _journal("jax", tmp_path / "jax.jsonl")
    assert got[:3] == want[:3]
    assert got[0]["journal"] == 1 and got[0]["file"] == 1
    assert got[1] == 2  # the open request and the open file
    assert got[2]["file"] == 0 and got[2]["journal"] == 1
    assert (tmp_path / "port.jsonl").read_bytes() == (
        tmp_path / "jax.jsonl").read_bytes()
