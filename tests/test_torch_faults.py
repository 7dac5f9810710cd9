"""The port's fault layer (``..._torch/runtime/faults.py`` and
``runtime/store.py``) against the JAX package's: the same spec and seed
give the same firing sequence, the same corrupted byte offsets and the
same retries; the stores' surface over ``MemStore`` and over a real
localhost ``torch.distributed.TCPStore``; and the checkpoint-write site
on the port's single-file checkpoint (a corrupt payload caught by the
digest check and skipped by ``load_with_fallback``).

No test arms the ``PMDT_FAULT_PLAN`` env hook: plans are built and armed
programmatically (``faults.armed``), and always disarmed after.
"""

import threading

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import faults as jfaults
from pytorch_multiprocessing_distributed_tpu_torch.runtime import faults
from pytorch_multiprocessing_distributed_tpu_torch.runtime.store import (
    MemStore, TCPStore, TCPStoreServer)

SPECS = [
    "seed=7;store.get=error:2;train.checkpoint_write=corrupt:0",
    "seed=3;every=3;a=error:0:1;b=corrupt:2;c=fatal:1:4",
    "every=2;seed=11;c=hang:2:0.001;a=corrupt:3:1;b=error:0",
    "seed=0;train.checkpoint_write=error:1:1",
]


def _drive(mod, spec, calls=24):
    """Outcomes of ``calls`` hits over the sites of ``spec``, round robin:
    'ok', the raised class name, or the offsets a corrupt rule flipped;
    and each rule's trigger count."""
    plan = mod.plan_from_spec(spec)
    sites = sorted({r.site for r in plan.rules})
    out = []
    for i in range(calls):
        site = sites[i % len(sites)]
        payload = bytes(range(37 + i))
        try:
            got = plan.apply(site, payload)
        except mod.GraftFaultError as e:
            out.append((site, type(e).__name__, str(e)))
            continue
        flipped = [j for j, (a, b) in enumerate(zip(got, payload)) if a != b]
        out.append((site, "ok", flipped))
    return out, [(r.site, r.kind, r.triggered) for r in plan.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_fires_as_jax(spec):
    ours, our_rules = _drive(faults, spec)
    ref, ref_rules = _drive(jfaults, spec)
    assert ours == ref
    assert our_rules == ref_rules
    assert any(kind != "ok" or flipped for _, kind, flipped in ours)


def test_rules_and_grammar_as_jax():
    for mod in (faults, jfaults):
        plan = mod.plan_from_spec("x=hang:3:0.5;every=4;y=corrupt:0:2")
        assert [(r.site, r.kind, r.times, r.after, r.every, r.hang_s)
                for r in plan.rules] == [("x", "hang", 3, 0, 4, 0.5),
                                         ("y", "corrupt", 0, 2, 4, 0.25)]
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultRule("x", "explode")
        with pytest.raises(ValueError, match=">= 0"):
            mod.FaultRule("x", times=-1)
        # a corrupt rule where no payload passes is a named error
        plan = mod.FaultPlan([mod.FaultRule("z", "corrupt")])
        with pytest.raises(mod.GraftFaultError, match="no payload"):
            plan.apply("z", None)
    assert issubclass(faults.FaultInjected, ConnectionError)
    assert issubclass(faults.PeerLostError, faults.GraftFaultError)
    e = faults.PeerLostError("3", "gone")
    assert (e.who, e.why, str(e)) == ("3", "gone", "peer '3' lost: gone")


def _retries(mod, fails, attempts, retry_on=None):
    naps, seen = [], []
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise mod.FaultInjected(f"flake {calls['n']}")
        return calls["n"]

    kw = {} if retry_on is None else {"retry_on": retry_on}
    try:
        got = mod.retry_with_backoff(
            fn, attempts=attempts, base_delay_s=0.1, max_delay_s=0.3,
            on_retry=lambda i, e: seen.append((i, str(e))),
            sleep=naps.append, **kw)
    except Exception as e:  # compared below, by class and text
        got = (type(e).__name__, str(e))
    return got, naps, seen, calls["n"]


@pytest.mark.parametrize("fails,attempts", [(0, 3), (2, 3), (3, 3), (4, 6)])
def test_retry_with_backoff_as_jax(fails, attempts):
    assert _retries(faults, fails, attempts) == _retries(jfaults, fails,
                                                          attempts)


def test_retry_passes_non_transient_and_timeout_names_what_hung():
    assert _retries(faults, 1, 3, retry_on=(KeyError,))[0][0] == \
        "FaultInjected"
    with pytest.raises(faults.FaultTimeout, match="bring-up.*hint"):
        faults.run_with_timeout(lambda: threading.Event().wait(5), 0.05,
                                "bring-up", hint="hint")
    with pytest.raises(KeyError):
        faults.run_with_timeout(lambda: {}["x"], 5, "lookup")
    assert faults.run_with_timeout(lambda: 4, 5, "four") == 4


def test_memstore_surface_and_sites():
    store = MemStore()
    store.set("k", b"v")
    assert store.get("k") == b"v" and store.get("absent") is None
    assert store.add("n", 2) == 2 and store.add("n", 3) == 5
    assert store.get("n") == b"5"
    assert store.delete("k") and not store.delete("k")
    plan = faults.plan_from_spec("store.set=corrupt:1;store.get=error:1:1")
    with faults.armed(plan):
        store.set("c", b"abc")
        store.get("c")
        with pytest.raises(faults.FaultInjected):
            store.get("c")
    assert store.get("c") != b"abc"  # corrupted on its way in
    assert plan.triggered() == 2 and faults.active_plan() is None


def test_tcp_store_over_torch_store():
    """The port's client on a real localhost torch TCPStore (port 0):
    the JAX client's surface, a counting barrier of three clients, and
    injected faults retried (set, get) or, for ``add``, retried only
    when injected."""
    with TCPStoreServer(port=0) as server:
        clients = [TCPStore(port=server.port, backoff_s=0.0,
                            timeout_s=10.0) for _ in range(3)]
        a, b, _ = clients
        a.set("k", b"v")
        assert b.get("k") == b"v" and b.get("absent") is None
        assert a.add("n", 2) == 2 and b.add("n", 3) == 5
        assert a.wait("k") == b"v"
        assert a.delete("k") and b.get("k") is None
        for round_no in range(2):
            done = []
            threads = [threading.Thread(
                target=lambda c=c: (c.barrier("b", 3), done.append(1)))
                for c in clients]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            assert len(done) == 3, round_no
        plan = faults.plan_from_spec("store.set=error:2;store.get=error:1")
        with faults.armed(plan):
            a.set("r", b"1")  # two injected faults, third attempt lands
            assert a.get("r") == b"1"
            assert a.add("m", 1) == 1  # add's site is store.set
        assert plan.triggered() == 3
        with faults.armed(faults.plan_from_spec("store.get=error:3")):
            with pytest.raises(faults.FaultInjected):
                a.get("r")  # persistent: the attempts run out
        wrapped = TCPStore(store=a._store)
        assert wrapped.get("r") == b"1"
        for c in clients:
            c.close()


def test_checkpoint_write_site_corrupt_falls_back(tmp_path):
    """A corrupt fault at ``train.checkpoint_write`` flips a byte after
    the digest is taken: the load names the mismatch and
    ``load_with_fallback`` resumes from the previous valid epoch."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_model)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state)
    from pytorch_multiprocessing_distributed_tpu_torch.train.checkpoint import (
        CheckpointCorruptError, load_checkpoint, load_with_fallback,
        save_checkpoint)

    def state(seed):
        st = create_train_state(init_model(get_model("res"), seed))
        return st

    st = state(0)
    st.epoch = 1
    save_checkpoint(str(tmp_path), st, 1)
    ref = st.params.clone()
    with torch.no_grad():
        st.params.add_(1.0)
    st.epoch = 2
    plan = faults.plan_from_spec("seed=5;train.checkpoint_write=corrupt:1")
    with faults.armed(plan):
        save_checkpoint(str(tmp_path), st, 2)
    assert plan.triggered("train.checkpoint_write") == 1
    with pytest.raises(CheckpointCorruptError, match="model_2.pth"):
        load_checkpoint(str(tmp_path / "model_2.pth"), state(1))
    assert issubclass(CheckpointCorruptError, faults.GraftFaultError)
    fresh, used = load_with_fallback(str(tmp_path), state(1))
    assert used.endswith("model_1.pth") and fresh.epoch == 1
    assert torch.equal(fresh.params, ref)
    # an injected error is a named fatal at the save
    with faults.armed(faults.plan_from_spec("train.checkpoint_write=error")):
        with pytest.raises(faults.FaultInjected):
            save_checkpoint(str(tmp_path), st, 3)
    assert not (tmp_path / "model_3.pth").exists()


def test_every_site_of_the_port_is_registered():
    """Importing the modules registers the sites the JAX package names
    for the training path (the port has no serving sites yet)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (  # noqa: F401
        dist)
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import (  # noqa: F401
        heal)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (  # noqa: F401
        checkpoint, orbax_ckpt)

    ours = faults.registered_sites()
    for site in ("store.get", "store.set", "heartbeat.write",
                 "heartbeat.read", "heal.restart", "runtime.rendezvous",
                 "train.checkpoint_write", "train.orbax_save"):
        assert site in ours, site
