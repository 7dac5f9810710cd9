"""``serve_lm``'s live telemetry against the JAX CLI's.

A port ``serve_lm --device cpu --stdin --stats_port P`` run in a
subprocess answers every route while it serves: ``/healthz`` is 200
with ``state: ready``, ``/snapshot.json`` and ``/metrics`` carry the
gauge names a JAX engine's snapshot gives under the same CLI wiring
(its decode-program temps apart, which the port has no model of),
``/events.json`` serves the armed scope. The trainers' servers bind
and close with their runs (``tests/test_torch_scope_restart.py`` holds
a supervised restart on a fixed port).
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import fleet as jfleet
from pytorch_multiprocessing_distributed_tpu.runtime import hbm as jhbm
from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)

from cli_procs import PORT, REPO, cli_env, free_port, run_cli
from serving_heal_cases import ENGINE_KW, models


def _get(port, path, timeout=5.0):
    """(status, body) of one GET; status 0 while nothing listens."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return 0, ""


def _names(text):
    return {line.split()[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def _jax_names():
    """The /metrics names of a JAX engine under the JAX CLI's wiring:
    the serving snapshot, the armed ledger and hbm_per_slot_bytes, the
    goodput gauges."""
    jmodel, jparams, _ = models()
    with jscope.scoped(jscope.Scope()), jhbm.scoped_ledger() as ledger:
        jfleet.arm_goodput()
        try:
            engine = JaxEngine(jmodel, jparams, **ENGINE_KW)
            engine.serve([(np.arange(5), 4)])
            snap = engine.metrics.snapshot()
            snap.update(ledger.snapshot())
            snap["hbm_per_slot_bytes"] = engine.pool.per_slot_bytes
            snap.update(jfleet.goodput_gauges())
        finally:
            jfleet.disarm_goodput()
    return {n for n in _names(jscope.prometheus_text(snap))
            if "decode_temp" not in n}


def test_stats_routes_answer_with_jax_names():
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", f"{PORT}.serve_lm", "--device", "cpu",
         "--model", "gpt_tiny", "--random_init", "--stdin", "--max_slots",
         "2", "--max_new_tokens", "4", "--stats_port", str(port)],
        cwd=REPO, env=cli_env(), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while _get(port, "/healthz")[0] != 200:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            assert time.monotonic() < deadline
            time.sleep(0.1)
        code, body = _get(port, "/healthz")
        assert json.loads(body)["state"] == "ready"
        code, snap = _get(port, "/snapshot.json")
        assert code == 200
        snap = json.loads(snap)
        assert snap["hbm_params_serving_params_bytes"] > 0
        assert "goodput_frac" in snap
        code, metrics = _get(port, "/metrics")
        assert code == 200
        got = _names(metrics)
        code, events = _get(port, "/events.json")
        assert code == 200
        assert [e["name"] for e in json.loads(events)][:1] == [
            "heal.health"]
        assert _get(port, "/nope")[0] == 404
        out = proc.communicate("hi\n", timeout=120)[0]
        assert proc.returncode == 0, out[-3000:]
        assert "metrics: " in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = _jax_names()
    assert got - {"pmdt_serving_hbm_temps_bytes"} == want - {
        "pmdt_serving_hbm_temps_bytes"}


@pytest.mark.parametrize("cli", ["main", "train_lm"])
def test_trainer_cli_stats_server_closes(tmp_path, cli):
    """The trainers' stats servers bind, serve the trainer's gauges with
    the ledger's, and close with the run (``/healthz`` then refuses)."""
    port = free_port()
    argv = (["--world_size", "1", "--synthetic", "--batch_size", "16"]
            if cli == "main" else
            ["--model", "gpt_tiny", "--batch_size", "8", "--seq_len",
             "32", "--corpus_tokens", "3000"])
    out = run_cli(cli, argv + [
        "--device", "cpu", "--epochs", "1", "--save_path", str(tmp_path),
        "--stats_port", str(port), "--trace_out",
        str(tmp_path / "t.json")], PMDT_SMALL_SYNTH="32")
    assert f"stats: http://127.0.0.1:{port}/metrics" in out
    assert _get(port, "/healthz", timeout=1.0)[0] == 0
    trace = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    names = {e["name"] for e in trace}
    assert {"train.window", "train.metrics_fetch", "train.checkpoint",
            "checkpoint.write", "heal.health"} <= names
