"""The serving fleet's replica directory (``runtime/fleet.py``) against
the JAX package's: ``publish_replica``/``replica_directory`` over a
``TCPStore`` with concurrent writers, the TTL filter and the reap's
``unpublish_replica``, the same records as JAX's over its ``MemStore``;
``fleet_serving_report`` equal to JAX's on the same per-replica dicts;
the router publishing and unpublishing its replicas."""

import threading

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import (
    fleet as jfleet)
from pytorch_multiprocessing_distributed_tpu.runtime.store import (
    MemStore as JaxMemStore)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    faults, fleet, store)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    Router, ServingEngine, ServingReplica)

from serving_heal_cases import models

RIDS = [f"r{i}" for i in range(8)]


def _publish_all(mod, make_client, run_uid):
    """Eight threads, each with its own client, publish at once."""
    barrier = threading.Barrier(len(RIDS))
    ok = []

    def publish(rid):
        client = make_client()
        barrier.wait()
        ok.append(mod.publish_replica(client, rid, role="both",
                                      state="ready", run_uid=run_uid,
                                      address=f"127.0.0.1:{9100 + int(rid[1:])}",
                                      now=100.0))

    threads = [threading.Thread(target=publish, args=(r,)) for r in RIDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ok == [True] * len(RIDS)


def test_concurrent_publishers_lossless_and_equal_to_jax():
    with store.TCPStoreServer(port=0) as server:
        client = store.TCPStore(port=server.port, backoff_s=0.0)
        _publish_all(fleet, lambda: store.TCPStore(port=server.port,
                                                   backoff_s=0.0), "race")
        jstore = JaxMemStore()
        _publish_all(jfleet, lambda: jstore, "race")
        got = fleet.replica_directory(client, run_uid="race")
        assert got == jfleet.replica_directory(jstore, run_uid="race")
        assert set(got) == set(RIDS)
        # an idempotent re-publish claims no second roster slot
        fleet.publish_replica(client, "r0", run_uid="race", state="draining")
        assert int(client.add("fleet/race/replicas/n", 0)) == len(RIDS)
        assert fleet.replica_directory(client, run_uid="race")["r0"][
            "state"] == "draining"
        # the TTL filter: r0 just refreshed, the others aged out
        fresh = fleet.replica_directory(client, run_uid="race", ttl_s=60.0)
        assert set(fresh) == {"r0"}
        assert set(fleet.replica_directory(client, run_uid="race",
                                           ttl_s=60.0, now=130.0)) == set(RIDS)
        assert fleet.unpublish_replica(client, "r3", run_uid="race")
        assert "r3" not in fleet.replica_directory(client, run_uid="race")


def test_store_outage_is_best_effort(capsys):
    mem = store.MemStore()
    plan = faults.FaultPlan([faults.FaultRule("store.set", "error",
                                              times=1)])
    with faults.armed(plan):
        assert not fleet.publish_replica(mem, "r0")
    assert "replica publish 'r0' failed" in capsys.readouterr().err
    assert fleet.replica_directory(mem) == {}


def test_fleet_serving_report_equals_jax():
    per = {"r0": {"state": "ready", "goodput_frac": 0.9},
           "r1": {"state": "ready", "goodput_frac": 0.4},
           "r2": {"state": "dead", "goodput_frac": 0.7}}
    got = fleet.fleet_serving_report(per)
    assert got == jfleet.fleet_serving_report(per)
    assert got["straggler"] == "r1" and got["replicas_alive"] == 2
    assert fleet.fleet_serving_report({}) == jfleet.fleet_serving_report({})


def test_router_publishes_and_unpublishes():
    torch.set_num_threads(1)
    _, _, model = models()
    mem = store.MemStore()
    engines = [ServingEngine(model, max_slots=2, s_max=32, min_bucket=8,
                             dispatch_retries=1) for _ in range(2)]
    router = Router([ServingReplica("r0", engines[0],
                                    address="127.0.0.1:9100"),
                     ServingReplica("r1", engines[1])],
                    store=mem, run_uid="t")
    directory = fleet.replica_directory(mem, run_uid="t")
    assert directory["r0"]["role"] == "both"
    assert directory["r0"]["address"] == "127.0.0.1:9100"
    assert directory["r1"]["state"] == "ready"
    router.submit([1, 2, 3], 4, uid="a")
    plan = faults.FaultPlan([faults.FaultRule("serving.decode_dispatch",
                                              "fatal", times=1)])
    with faults.armed(plan):
        while router.in_flight:
            router.step()
    dead = [r.rid for r in router.replicas if r.reaped]
    assert len(dead) == 1
    assert set(fleet.replica_directory(mem, run_uid="t")) == (
        {"r0", "r1"} - set(dead))
    router.begin_drain("test")
    for rec in fleet.replica_directory(mem, run_uid="t").values():
        assert rec["state"] == "draining"


@pytest.mark.parametrize("mod", [fleet, jfleet], ids=["port", "jax"])
def test_unstamped_and_garbage_stamps_are_kept(mod):
    mem = JaxMemStore()
    mod.publish_replica(mem, "r0", now=0.0)
    mem.set("fleet/run/replica/r0", b'{"rid": "r0", "published_at": "x"}')
    mod.publish_replica(mem, "r1", now=0.0)
    mem.set("fleet/run/replica/r1", b'{"rid": "r1"}')
    assert set(mod.replica_directory(mem, ttl_s=1.0, now=99.0)) == {
        "r0", "r1"}
