"""The port's ``runtime/fleet.py`` against the JAX package's, and the
fleet on four gloo ranks of ``train_lm``.

One script over both packages (``pkg`` is JAX's modules or the port's),
with injected clocks: three ranks' monitors on one ``MemStore``, rank 2
arriving late at every boundary; the collector's clock offsets,
endpoints, straggler report, merged gauges and merged timeline, the
goodput gauges of a fixed event list, and the stamps a failing store
drops equal JAX's. Then ``chip_smoke.py``'s [fleet-xcard] run on the
CPU: four ``train_lm --parallel dp`` ranks under ``PMDT_FLEET`` (set in
the spawned ranks only), one slowed by a 0.1 s hang a store write
(gloo blocks the host in every collective, so the slowed rank lags only
at the stamp after each gate: twice the card run's hang keeps that lag
well above the CPU ranks' jitter); rank 0's
collector names it, merges four lanes and reads a goodput fraction in
(0, 1] from every rank's ``/snapshot.json``.
"""

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import fleet as jfleet
from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu.runtime import store as jstore
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    fleet, scope, store)

import chip_smoke

PKGS = pytest.mark.parametrize("pkg", [(jfleet, jscope, jstore),
                                       (fleet, scope, store)],
                               ids=["jax", "port"])


def _clock(start):
    box = [start]

    def tick(dt=0.0):
        box[0] += dt
        return box[0]
    return box, tick


def _fleet_script(fl, sc, st):
    mem = st.MemStore()
    monitors, clocks = [], []
    for rank in range(3):
        box, tick = _clock(100.0 * rank)
        clocks.append(box)
        monitors.append(fl.FleetMonitor(mem, "host-a", rank, 3,
                                        run_uid="r1", perf=tick,
                                        wall=lambda r=rank: 5000.0 + r))
    for step in range(4):
        for rank, (mon, box) in enumerate(zip(monitors, clocks)):
            box[0] += 0.010 + (0.030 if rank == 2 else 0.001 * rank)
            mon.note_arrival("all_reduce@data", axis="data", nbytes=64)
            if step % 2:
                mon.note_arrival("dist.gate")
    for rank, mon in enumerate(monitors):
        mon.publish_endpoint(f"127.0.0.1:{9000 + rank}")
    col = fl.FleetCollector(mem, run_uid="r1")
    events = {r: [{"name": "train.window", "cat": "train", "ph": "X",
                   "ts": 100.0 * r + 0.5, "dur": 0.25, "tid": 1, "seq": 0,
                   "epoch": 1},
                  {"name": "fleet.arrive", "cat": "fleet", "ph": "i",
                   "ts": 100.0 * r + 0.8, "tid": 1, "seq": 1}]
              for r in range(3)}
    snaps = {0: {"loss": 2.0, "ok": True}, 1: {"loss": 3.0}, 2: None}
    return (col.clock_offsets(), col.endpoints(), col.straggler_report(),
            col.merged_gauges(snaps),
            col.merged_timeline(events, hosts={0: "a", 1: "b", 2: "c"}),
            [m.snapshot() for m in monitors])


@PKGS
def test_collector_views_equal_jax(pkg):
    got = _fleet_script(*pkg)
    assert got == _fleet_script(jfleet, jscope, jstore)
    report = got[2]
    assert report["straggler_rank"] == 2 and report["collectives"] == 6
    assert report["by_name"]["all_reduce@data"]["nbytes"] == 64
    assert sum(e.get("ph") == "M" for e in got[4]["traceEvents"]) == 3


def _goodput(fl, sc):
    events = [
        sc.Event("train.window", "train", "X", 0.0, 1.0, 1, 0, {}),
        sc.Event("train.data", "train", "X", 0.1, 0.2, 1, 1, {}),
        sc.Event("train.metrics_fetch", "train", "X", 0.8, 0.1, 1, 2, {}),
        sc.Event("train.checkpoint", "train", "X", 1.0, 0.5, 1, 3, {}),
        sc.Event("checkpoint.write", "train", "X", 1.1, 0.3, 1, 4, {}),
        sc.Event("fault.retry", "fault", "i", 1.6, 0.0, 1, 5,
                 {"delay_s": 0.02}),
        sc.Event("heal.restart", "fault", "i", 1.7, 0.0, 1, 6,
                 {"backoff_s": 0.25}),
        sc.Event("decode.drain", "serving", "X", 2.0, 0.5, 1, 7, {}),
        sc.Event("spec.verify", "serving", "X", 2.0, 0.5, 1, 8,
                 {"waste_s": 0.1}),
        sc.Event("engine.drain", "serving", "X", 2.5, 0.5, 1, 9, {}),
    ]
    ledger = fl.GoodputLedger.from_events(events)
    again = ledger.ingest([e.to_dict() for e in events])  # seq cursor
    with sc.scoped(sc.Scope()) as s:
        for e in events:
            s.record(e)
        fl.arm_goodput()
        try:
            armed = fl.goodput_gauges()
        finally:
            fl.disarm_goodput()
    return ledger.gauges(), again, armed, fl.goodput_gauges()


@PKGS
def test_goodput_gauges_equal_jax(pkg):
    got = _goodput(pkg[0], pkg[1])
    assert got == _goodput(jfleet, jscope)
    gauges = got[0]
    assert got[1] == 0 and got[3] == {}
    assert 0.0 < gauges["goodput_frac"] <= 1.0
    assert gauges["goodput_checkpoint_write_s"] == pytest.approx(0.3)


class _DownStore:
    def set(self, key, value):
        raise ConnectionError("store down")


@PKGS
def test_store_outage_drops_stamps(pkg, capsys):
    fl, sc, _ = pkg
    mon = fl.FleetMonitor(_DownStore(), "h", 0, 2)
    for _ in range(3):
        mon.note_arrival("dist.gate")
    assert mon.dropped_stamps == 5 and mon.snapshot()[
        "fleet_arrivals"] == 0
    assert capsys.readouterr().err.count("dropping stamps") == 1
    with fl.scoped_fleet(mon):
        with sc.scoped(sc.Scope()) as s:
            sc.emit("x")
        assert s.events()[0].attrs == {"host": "h", "rank": 0,
                                       "run_uid": "run"}
        fl.note_arrival("dist.gate")
    assert sc.get_identity() is None and fl.active_fleet() is None
    assert mon.dropped_stamps == 6


def test_four_gloo_ranks_name_the_slowed_rank():
    report, steps = chip_smoke._fleet_run(
        "cpu", "gpt_tiny", ["--batch_size", "8", "--seq_len", "32",
                            "--corpus_tokens", "1024"], hang_s=0.1,
        timeout_s=240)
    chip_smoke._check_fleet(report, steps)
    assert steps == [4] * 4
    assert report["endpoints"] == 4 and report["dropped"] == [0] * 4
    assert len(set(report["arrivals"])) == 1  # every rank stamped alike
