"""The serving engine's observability against the JAX engine's, dense
and paged with a prefix cache.

The same tiny GPT (carried from JAX) and the same requests go through
both engines with the scope bus, the device-memory ledger and the
ownership ledger armed (``tests/scope_cases.py``): the ordered ``(name,
cat, attrs)`` stream of the ``request``, ``serving``, ``spec``,
``decode`` and ``fault`` events (times dropped: every ``*_s`` attr) is
equal; the ``request.timeline`` records carry JAX's keys; the ledgers
hold JAX's entries (the decode-program temps apart, which the port has
no model of); a drained engine holds nothing on the ownership ledger;
and a fatal fault leaves the same flight dump. The speculative int8
case is ``tests/test_torch_scope_spec.py``.
"""

import json

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import faults as jfaults
from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    faults, scope)

from scope_cases import (CASES, _engine, _strip, check_drained,
                         check_event_stream, check_hbm, check_timelines,
                         make_fix, run_case)

NAMES = ['dense', 'paged_prefix']


@pytest.fixture(scope="module")
def fix():
    return make_fix()


@pytest.fixture(scope="module")
def runs(fix):
    return {(name, pkg): run_case(fix, pkg, CASES[name]) for name in NAMES
            for pkg in ("jax", "port")}


@pytest.mark.parametrize("case", NAMES)
def test_event_stream_equals_jax(runs, case):
    check_event_stream(runs, case)


@pytest.mark.parametrize("case", NAMES)
def test_timelines_have_jax_keys(runs, case):
    check_timelines(runs, case)


@pytest.mark.parametrize("case", NAMES)
def test_hbm_ledger_equals_jax(runs, case):
    check_hbm(runs, case)


@pytest.mark.parametrize("case", NAMES)
def test_drained_engine_holds_nothing(runs, case):
    check_drained(runs, case)


def _flight(fix, pkg, tmp_path):
    sc, fl = (jscope, jfaults) if pkg == "jax" else (scope, faults)
    path = tmp_path / f"{pkg}.jsonl"
    plan = fl.plan_from_spec("serving.decode_dispatch=fatal:1:1")
    with sc.scoped(sc.Scope(flight_path=str(path))), fl.armed(plan):
        engine = _engine(fix, pkg, CASES["dense"])
        for i, p in enumerate(fix[3][:3]):
            engine.submit(p, 6, uid=f"r{i}")
        with pytest.raises(Exception) as err:
            for _ in engine.run():
                pass
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return err.type.__name__, lines[0], [
        (e["name"], e["cat"], _strip({k: v for k, v in e.items() if k
                                      not in ("name", "cat", "ph", "ts",
                                              "dur", "tid", "seq")}))
        for e in lines[1:]]


def test_fatal_fault_flight_dump_equals_jax(fix, tmp_path):
    got, want = _flight(fix, "port", tmp_path), _flight(fix, "jax",
                                                        tmp_path)
    assert got[0] == want[0] == "GraftFaultError"
    assert got[1]["graftscope_flight"] == want[1]["graftscope_flight"]
    assert got[2] == want[2]
    assert got[2][-1][0] == "engine.fatal"
