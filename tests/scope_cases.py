"""Shared parts of the serving engine's observability tests
(``tests/test_torch_scope_engine.py`` and ``test_torch_scope_spec.py``):
the tiny GPT carried from JAX, prompts with a repeated and a shared
prefix, one armed run of an engine (the JAX package's or the port's)
reduced to what the two must agree on, and the checks of a case."""

import numpy as np

from pytorch_multiprocessing_distributed_tpu.runtime import hbm as jhbm
from pytorch_multiprocessing_distributed_tpu.runtime import life as jlife
from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
    hbm, life, scope)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine)

from serving_heal_cases import models

CATS = ("request", "serving", "spec", "decode", "fault")
BASE = dict(s_max=32, min_bucket=8, decode_horizon=4)
CASES = {
    "dense": dict(max_slots=3),
    "paged_prefix": dict(max_slots=2, kv_layout="paged", page_size=4,
                         prefix_cache=8),
    "spec_int8": dict(max_slots=3, draft_k=4, kv_dtype="int8"),
}


def make_fix():
    jmodel, jparams, model = models()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 61, (9,)).tolist()
    prompts = [base, rng.integers(0, 61, (5,)).tolist(), list(base),
               base[:8] + [3, 4, 5], rng.integers(0, 61, (12,)).tolist()]
    return jmodel, jparams, model, prompts


def _strip(attrs):
    return {k: v for k, v in attrs.items()
            if not k.endswith("_s") and k != "deadline_s"}


def _stream(events):
    return [(e.name, e.cat, _strip(e.attrs)) for e in events
            if e.cat in CATS]


def _engine(fix, pkg, kw):
    jmodel, jparams, model, _ = fix
    if pkg == "jax":
        engine = JaxEngine(jmodel, jparams, **BASE, **kw)
        if engine._drafter is not None:
            import jax.numpy as jnp

            engine._drafter._place = lambda a: jnp.array(a, copy=True)
        return engine
    return ServingEngine(model, **BASE, **kw)


def run_case(fix, pkg, kw):
    """Serve the prompts with every ledger armed, drain, clear the
    prefix cache: (events, timelines, hbm entries, life audit)."""
    sc, hb, lf = ((jscope, jhbm, jlife) if pkg == "jax"
                  else (scope, hbm, life))
    with sc.scoped(sc.Scope()) as s, hb.scoped_ledger() as ledger, \
            lf.armed() as led:
        engine = _engine(fix, pkg, kw)
        reqs = [engine.submit(p, 6, uid=f"r{i}")
                for i, p in enumerate(fix[3])]
        for _ in engine.run():
            pass
        engine.drain()
        if engine._prefix_cache is not None:
            engine._prefix_cache.clear()
        audit = led.audit_drained("drain")
    entries = {k: v for k, v in ledger.entries().items()
               if not k.startswith("serving.decode_temp_")}
    return (s.events(), [r.timeline() for r in reqs], entries,
            ledger.snapshot(), audit)




def check_event_stream(runs, case):
    port, ref = runs[(case, "port")][0], runs[(case, "jax")][0]
    got, want = _stream(port), _stream(ref)
    assert got == want
    names = {n for n, _, _ in got}
    assert {"request.submit", "request.admit", "request.first_token",
            "request.done", "decode.dispatch", "decode.drain",
            "serving.slot_insert", "engine.draining",
            "engine.drain"} <= names
    if case == "paged_prefix":
        modes = {a["mode"] for n, _, a in got if n == "serving.prefix_hit"}
        assert modes == {"full", "partial"}
    if case == "spec_int8":
        assert {"spec.draft", "spec.verify"} <= names


def check_timelines(runs, case):
    port, ref = runs[(case, "port")][1], runs[(case, "jax")][1]
    assert [sorted(t) for t in port] == [sorted(t) for t in ref]
    assert [(t["uid"], t["state"], t["finish_reason"], t["tokens"])
            for t in port] == [(t["uid"], t["state"], t["finish_reason"],
                                t["tokens"]) for t in ref]
    assert all(t["ttft_s"] <= t["total_s"] for t in port)


def check_hbm(runs, case):
    port, ref = dict(runs[(case, "port")][2]), dict(runs[(case, "jax")][2])
    assert sorted(port) == sorted(ref)
    snap, jsnap = runs[(case, "port")][3], runs[(case, "jax")][3]
    # JAX's totals count its decode-program temps, which the port lacks
    skip = {"hbm_total_bytes", "hbm_temps_bytes", "hbm_entries"}
    if case == "spec_int8":
        # a speculative dense pool holds draft_k spare columns past s_max
        # (JAX drops those writes; torch cannot): bytes in proportion
        cat, nbytes, attrs = port.pop("serving.kv_pool")
        jcat, jbytes, jattrs = ref.pop("serving.kv_pool")
        s_max, k = BASE["s_max"], CASES[case]["draft_k"]
        assert (cat, attrs) == (jcat, jattrs)
        assert nbytes * s_max == jbytes * (s_max + k)
        skip |= {"hbm_kv_bytes", "hbm_kv_serving_kv_pool_bytes"}
    assert port == ref
    gauges = [k for k in jsnap if "decode_temp" not in k and k not in skip]
    assert {k: snap[k] for k in gauges} == {k: jsnap[k] for k in gauges}


def check_drained(runs, case):
    assert runs[(case, "port")][4] == [] == runs[(case, "jax")][4]
