"""The port's ``runtime/scope.py`` against the JAX package's.

Each test runs once per package (``mod`` is the JAX module or the
port's) on the same event lists, built with fixed clocks, and holds the
module's output to the JAX module's: the Chrome trace, the JSONL log
and its parse, the Prometheus exposition, the flight dump and the
flight recorder, the CLI glue (which flags arm what, the derived flight
path), and the stats server's routes. The ``PMDT_SCOPE`` hook is
exercised in a subprocess of each package.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from argparse import Namespace

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu_torch.runtime import scope

MODS = pytest.mark.parametrize("mod", [jscope, scope], ids=["jax", "port"])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = {"requests_completed": 16, "ttft_p99_s": 0.125, "ok": True,
            "decode_windows": [64, 128], "hbm.kv-pool bytes": 4096,
            "9lives": 2.5e-7, "name": "gpt_small"}


def _events(mod):
    """Spans and instants with fixed stamps, attrs of every JSON kind."""
    return [
        mod.Event("request.submit", "request", "i", 10.0, 0.0, 7, 0,
                  {"req": "src-0", "prompt_len": 5}),
        mod.Event("serving.prefill", "serving", "X", 10.25, 0.5, 7, 1,
                  {"req": "src-0", "bucket": 16}),
        mod.Event("decode.drain", "serving", "X", 11.0, 0.125, 9, 2,
                  {"h": 4, "window": 64, "tokens": 12}),
        mod.Event("fault.retry", "fault", "i", 11.5, 0.0, 9, 3,
                  {"attempt": 0, "error": "FaultInjected",
                   "delay_s": 0.02}),
    ]


@MODS
def test_exporters_equal_jax(mod, tmp_path):
    events, ref = _events(mod), _events(jscope)
    got = mod.to_chrome_trace(events, t0=9.5, pid=3)
    assert got == jscope.to_chrome_trace(ref, t0=9.5, pid=3)
    assert got["traceEvents"][1]["dur"] == 0.5e6
    assert mod.to_chrome_trace(events, pid=3) == jscope.to_chrome_trace(
        ref, pid=3)
    mod.write_jsonl(str(tmp_path / "a.jsonl"), events)
    jscope.write_jsonl(str(tmp_path / "b.jsonl"), ref)
    assert (tmp_path / "a.jsonl").read_bytes() == (
        tmp_path / "b.jsonl").read_bytes()
    assert mod.events_from_jsonl(str(tmp_path / "a.jsonl")) == [
        e.to_dict() for e in ref]
    mod.write_chrome_trace(str(tmp_path / "a.json"), events, t0=9.5)
    assert json.loads((tmp_path / "a.json").read_text())[
        "displayTimeUnit"] == "ms"
    for prefix in ("pmdt_serving", "pmdt"):
        assert mod.prometheus_text(SNAPSHOT, prefix) == \
            jscope.prometheus_text(SNAPSHOT, prefix)
    assert "pmdt__9lives 2.5e-07" in mod.prometheus_text(SNAPSHOT, "pmdt")


@MODS
def test_scope_ring_and_cursor_equal_jax(mod):
    def fill(m, keep):
        s = m.Scope(keep=keep, flight_capacity=3)
        for e in _events(m) * 2:
            s.record(e)
        first, cursor = s.events_since(0)
        more, end = s.events_since(cursor - 2)
        return ([e.seq for e in s.events()], [e.seq for e in s.tail()],
                s.dropped, s.counts(), [e.seq for e in first], cursor,
                [e.seq for e in more], end)

    for keep in (True, False):
        assert fill(mod, keep) == fill(jscope, keep)
    with pytest.raises(ValueError, match="flight_capacity"):
        mod.Scope(flight_capacity=0)


@MODS
def test_flight_dump_and_recorder_equal_jax(mod, tmp_path):
    def dump(m, name):
        path = str(tmp_path / f"{name}.jsonl")
        s = m.Scope(keep=False, flight_capacity=3, flight_path=path)
        with m.scoped(s):
            for e in _events(m):
                s.record(e)
            with pytest.raises(KeyError):
                with m.flight_recorder("drive loop"):
                    raise KeyError("boom")
            assert m.flight_dump("again", str(tmp_path / "bad/x")) is None
        assert m.flight_dump("disarmed") is None
        lines = [json.loads(x) for x in open(path).read().splitlines()]
        header = {k: v for k, v in lines[0].items()
                  if k not in ("t0", "wall_time")}
        rows = [{k: v for k, v in row.items() if k not in ("ts", "tid",
                                                           "seq")}
                for row in lines[1:]]
        return header, rows

    got, want = dump(mod, "got"), dump(jscope, "want")
    assert got == want
    assert got[1][-1]["name"] == "engine.fatal"
    assert got[0]["graftscope_flight"] == "drive loop: KeyError: 'boom'"


@MODS
def test_emit_span_and_cli_glue_equal_jax(mod):
    def run(m):
        with m.scoped(m.Scope()) as s:
            m.emit("a", cat="x", k=1)
            with m.span("b", cat="y", k=2) as sp:
                sp.note(tokens=3)
            with pytest.raises(ValueError):
                with m.span("c"):
                    raise ValueError
            m.emit_span("d", 0.5, t_start=1.0, k=4)
            rows = [(e.name, e.cat, e.ph, e.attrs) for e in s.events()]
        assert m.active_scope() is None
        assert m.span("off") is m.span("off2")  # the shared no-op
        return rows

    assert run(mod) == run(jscope)

    def glue(m, **flags):
        args = Namespace(**{"trace_out": "", "events_out": "",
                            "flight_path": "", "stats_port": 0, **flags})
        s = m.arm_from_args(args)
        m.disarm()
        return None if s is None else (s.keep, s.flight_path)

    for flags in ({}, {"trace_out": "run/t.json"},
                  {"events_out": "e.jsonl", "flight_path": "f.jsonl"},
                  {"stats_port": 9000}, {"flight_path": "f.jsonl"}):
        assert glue(mod, **flags) == glue(jscope, **flags)
    import argparse

    parsers = []
    for m in (mod, jscope):
        p = argparse.ArgumentParser()
        m.add_cli_args(p, stats_port=True)
        parsers.append(vars(p.parse_args([])))
    assert parsers[0] == parsers[1]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


@MODS
def test_stats_server_routes_equal_jax(mod):
    def serve(m, state):
        with m.scoped(m.Scope()) as s:
            for e in _events(m):
                s.record(e)
            server = m.start_stats_server(
                lambda: SNAPSHOT, port=0,
                health_fn=lambda: {"state": state},
                events_fn=m.scope_events_fn)
            port = server.server_address[1]
            try:
                out = [_get(port, p) for p in (
                    "/metrics", "/snapshot.json", "/healthz",
                    "/events.json", "/events.json?since=3", "/nope")]
            finally:
                server.shutdown()
                server.server_close()
        return out

    for state in ("ready", "draining"):
        got, want = serve(mod, state), serve(jscope, state)
        assert got == want
        assert got[2][0] == (200 if state == "ready" else 503)
        assert [e["name"] for e in json.loads(got[4][1])] == ["fault.retry"]


@pytest.mark.parametrize("pkg", [
    "pytorch_multiprocessing_distributed_tpu",
    "pytorch_multiprocessing_distributed_tpu_torch"])
@pytest.mark.parametrize("value", ["1", "f.jsonl"])
def test_env_hook_arms_at_import(pkg, value):
    code = (f"import {pkg}.runtime.scope as s; a = s.active_scope(); "
            "print(a.keep, a.flight_path)")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMDT_")}
    env.update(PMDT_SCOPE=value, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = ("False graftscope_flight.jsonl" if value == "1"
            else "True f.jsonl")
    assert proc.stdout.split("\n")[-2] == want
