"""The speculative serving engine's observability against the JAX
engine's: ``draft_k=4`` self-drafting over int8 KV, the checks of
``tests/test_torch_scope_engine.py`` (``tests/scope_cases.py``) on the
``spec.draft`` and ``spec.verify`` spans too. The dense pool holds
``draft_k`` spare columns past ``s_max`` (JAX drops those writes; torch
cannot), so its bytes are JAX's in that proportion.
"""

import pytest

from scope_cases import (CASES, _engine, _strip, check_drained,
                         check_event_stream, check_hbm, check_timelines,
                         make_fix, run_case)

NAMES = ['spec_int8']


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
