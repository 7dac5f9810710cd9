"""The port's supervision layer (``..._torch/runtime/heal.py``, the
training half) against the JAX package's ``runtime/heal.py``: the same
liveness verdicts on a fake clock over ``MemStore``, the same
``Supervisor`` attempts, backoff delays, propagation and budget
exhaustion; the pre-collective gate wired into ``parallel.dist``; the
gate over a real localhost ``torch.distributed.TCPStore``; and the
``PMDT_HEARTBEAT`` hook end to end on two gloo processes (in
subprocesses: no test sets ``PMDT_*`` here).
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import faults as jfaults
from pytorch_multiprocessing_distributed_tpu.runtime import heal as jheal
from pytorch_multiprocessing_distributed_tpu.runtime import store as jstore
from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    faults, heal, store)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = [(heal, faults, store), (jheal, jfaults, jstore)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared by class, text and fields
        return (type(e).__name__, str(e), getattr(e, "who", None),
                getattr(e, "why", None))


# ---------------------------------------------------------------- liveness

def _tracker_trace(h):
    clock = {"t": 0.0}
    tr = h.LivenessTracker(["a", "ghost"], soft_timeout_s=1.0,
                           hard_timeout_s=3.0, clock=lambda: clock["t"])
    out = []
    for t, beat in ((0.5, 1), (1.2, 1), (1.6, None), (3.4, 2), (4.5, 2),
                    (7.0, 2), (7.1, 3)):
        clock["t"] = t
        tr.observe("a", beat)
        tr.observe("ghost", None)
        out.append((t, tr.states(), tr.dead(), tr.suspect(),
                    round(tr.age("a"), 6)))
    return out


def test_tracker_as_jax():
    assert _tracker_trace(heal) == _tracker_trace(jheal)
    for h in (heal, jheal):
        with pytest.raises(ValueError, match="hard_timeout"):
            h.LivenessTracker([], soft_timeout_s=2.0, hard_timeout_s=1.0)
        with pytest.raises(ValueError, match="> 0"):
            h.LivenessTracker([], soft_timeout_s=0.0, hard_timeout_s=1.0)


def _monitor_trace(h, st, interval):
    """Three monitors on one MemStore: host 2 goes silent after two
    rounds, later a local fatal is posted and cleared; every gate's
    outcome in order."""
    mem = st.MemStore()
    clock = {"t": 0.0}
    peers = ["0", "1", "2"]
    mons = [h.HeartbeatMonitor(mem, p, peers, soft_timeout_s=1.0,
                               hard_timeout_s=3.0, interval_s=interval,
                               backoff_s=0.0, clock=lambda: clock["t"])
            for p in peers]
    out = []
    script = [(0.1, (0, 1, 2)), (0.6, (0, 1, 2)), (1.2, (0, 1)),
              (2.2, (0, 1)), (3.2, (0, 1)), (4.5, (0, 1)), (4.6, (1, 0))]
    for t, who in script:
        clock["t"] = t
        for i in who:
            out.append((t, i, _outcome(mons[i].gate),
                        mons[i].heartbeat.count,
                        mons[i].tracker.states()))
    out.append(("poison", h.check_poison(mem)))
    h.clear_poison(mem)
    clock["t"] = 5.0
    out.append(("cleared", _outcome(mons[0].poll)))
    h.post_poison(mem, "1", "simulated fatal", by="1")
    h.post_poison(mem, "0", "late duplicate", by="0")
    clock["t"] = 5.2
    out.append(("posted", _outcome(mons[0].gate), h.check_poison(mem)))
    out.append(("snapshot", sorted(mons[0].snapshot())))
    return out


@pytest.mark.parametrize("interval", [0.0, 0.5])
def test_monitor_verdicts_as_jax(interval):
    ours = _monitor_trace(heal, store, interval)
    ref = _monitor_trace(jheal, jstore, interval)
    assert ours == ref
    # the silent host is named on both survivors (the headline)
    lost = [o for o in ours if len(o) == 5 and o[2][0] == "PeerLostError"]
    assert {o[1] for o in lost} >= {0, 1} and all(o[2][2] == "2"
                                                  for o in lost)


def test_heartbeat_retries_then_fails_loud():
    for h, f, st in BOTH:
        mem = st.MemStore()
        beat = h.Heartbeat(mem, "0", backoff_s=0.0)
        with f.armed(f.plan_from_spec("heartbeat.write=error:2")):
            assert beat.beat() == 1  # two flakes, the third lands
        with f.armed(f.plan_from_spec("heartbeat.write=error:3")):
            with pytest.raises(f.FaultInjected):
                beat.beat()
        assert beat.count == 1 and mem.get("heal/beat/0") == b"1"


# -------------------------------------------------------------- supervisor

def _supervise(h, f, case):
    naps, order = [], []

    def target(attempt):
        order.append(attempt)
        if case == "recover" and attempt < 4:
            raise f.GraftFaultError(f"again {attempt}")
        if case == "exhaust":
            raise f.PeerLostError("3", "gone")
        if case == "bug":
            raise KeyError("logic bug")
        if case == "exit":
            raise SystemExit(0)
        if case == "site" and attempt < 2:
            raise f.GraftFaultError("first")
        return f"done {attempt}"

    sup = h.Supervisor(target, max_restarts=4 if case != "exhaust" else 2,
                       backoff_s=1.0, max_backoff_s=5.0, sleep=naps.append,
                       rendezvous=lambda: order.append("rdv"),
                       name="drill" if case == "exhaust" else "")
    if case == "site":
        # a fault at the restart itself consumes budget like any fatal
        with f.armed(f.plan_from_spec("heal.restart=error:1")):
            got = _outcome(sup.run)
    else:
        try:
            got = _outcome(sup.run)
        except SystemExit as e:
            got = ("SystemExit", e.code)
    return got, naps, order, sup.restarts


@pytest.mark.parametrize("case", ["recover", "exhaust", "bug", "exit",
                                  "site"])
def test_supervisor_as_jax(case):
    ours = _supervise(heal, faults, case)
    assert ours == _supervise(jheal, jfaults, case)
    if case == "recover":
        assert ours[0] == ("ok", "done 4")
        assert ours[1] == [1.0, 2.0, 4.0, 5.0]  # doubling, capped
    if case == "exhaust":
        assert ours[0][0] == "RestartBudgetExhausted"
        assert "drill" in ours[0][1] and "2 restart" in ours[0][1]
    if case == "bug":
        assert ours[0][0] == "KeyError" and ours[3] == 0


def test_exhaustion_chains_the_last_fatal():
    def always(attempt):
        raise faults.PeerLostError("3", "gone")

    with pytest.raises(heal.RestartBudgetExhausted) as err:
        heal.Supervisor(always, max_restarts=1, backoff_s=0.0,
                        sleep=lambda s: None).run()
    assert isinstance(err.value.__cause__, faults.PeerLostError)
    with pytest.raises(ValueError, match=">= 0"):
        heal.Supervisor(always, max_restarts=-1)


# ------------------------------------------------------------- the gate

def test_dist_gate_wiring():
    def dead_gate():
        raise faults.PeerLostError("7", "unit-test gate")

    dist.install_collective_gate(dead_gate)
    try:
        with pytest.raises(faults.PeerLostError, match="'7'"):
            dist.gate_collectives()
        with pytest.raises(faults.PeerLostError, match="'7'"):
            dist.barrier()
    finally:
        dist.clear_collective_gate()
    dist.gate_collectives()  # uninstalled: a no-op
    dist.barrier()
    mem = store.MemStore()
    clock = {"t": 0.0}
    monitor = heal.HeartbeatMonitor(mem, "0", ["0"], soft_timeout_s=1.0,
                                    hard_timeout_s=2.0, backoff_s=0.0,
                                    clock=lambda: clock["t"])
    heal.arm(monitor)
    try:
        assert heal.active_monitor() is monitor
        dist.gate_collectives()  # through monitor.gate
        assert monitor.heartbeat.count == 1
        with faults.armed(faults.plan_from_spec("runtime.rendezvous=fatal")):
            with pytest.raises(faults.GraftFaultError, match="rendezvous"):
                dist.barrier()
    finally:
        heal.disarm()
    assert heal.active_monitor() is None
    dist.gate_collectives()


def test_gate_over_real_tcp_store():
    """Three 'hosts', one client each of a real torch TCPStore: host 2
    beats twice and goes silent; both survivors raise a PeerLostError
    naming it within the hard timeout (wall clock, no hang)."""
    peers = ["0", "1", "2"]
    with store.TCPStoreServer(port=0) as server:
        clients = [store.TCPStore(port=server.port, backoff_s=0.0,
                                  timeout_s=10.0) for _ in peers]
        monitors = [heal.HeartbeatMonitor(
            c, p, peers, soft_timeout_s=0.15, hard_timeout_s=0.4,
            backoff_s=0.0) for c, p in zip(clients, peers)]
        for _ in range(2):
            for m in monitors:
                m.gate()
            time.sleep(0.05)
        errors = {}
        deadline = time.monotonic() + 10.0

        def survivor(m):
            while time.monotonic() < deadline:
                try:
                    m.gate()
                except faults.PeerLostError as e:
                    errors[m.host] = e
                    return
                time.sleep(0.05)

        threads = [threading.Thread(target=survivor, args=(m,))
                   for m in monitors[:2]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(12.0)
        assert not any(t.is_alive() for t in threads)
        assert set(errors) == {"0", "1"}
        assert all(e.who == "2" for e in errors.values()), errors


def test_heartbeat_env_names_the_lost_rank(tmp_path):
    """Two gloo processes joined under ``PMDT_HEARTBEAT`` (the hook arms
    a monitor over the rendezvous store): rank 1 dies without leaving
    the group; rank 0's gate, at the window boundaries it keeps
    reaching, raises a named ``PeerLostError`` for rank 1 within the
    hard timeout."""
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                   PMDT_WORLD_SIZE="2", PMDT_RANK=str(rank),
                   PMDT_HEARTBEAT="0.2:0.6:0.05", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_heal_worker.py"),
             "peer_loss"], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 3, outs[1]
    assert procs[0].returncode == 0, outs[0]
    assert "raised PeerLostError who=1" in outs[0], outs[0]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
