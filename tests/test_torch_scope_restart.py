"""A supervised ``serve_lm`` restart on a fixed ``--stats_port``,
against the JAX CLI's.

A fatal at the 4th decode dispatch under ``--journal --max_restarts 1
--stats_port P --events_out``: the port's CLI binds P once an engine
(the dying engine's listener is closed before the rebuild), finishes
every request, leaves a flight dump, and its event names, counted,
equal the JAX CLI's on the same command (JAX's ahead-of-time
``compile.lower`` metering apart). Both CLIs run in subprocesses.
"""

import json
import subprocess
import sys
from collections import Counter

from cli_procs import PORT, REPO, cli_env, free_port


def _restart_run(tmp_path, pkg, port):
    """A fatal dispatch, one supervised restart over the journal: the
    CLI's output and its event names, counted."""
    argv = ["--model", "gpt_tiny", "--random_init", "--synthetic", "6",
            "--max_slots", "3", "--decode_horizon", "4", "--quiet",
            "--journal", str(tmp_path / f"{pkg}.wal"), "--max_restarts",
            "1", "--restart_backoff", "0", "--stats_port", str(port),
            "--events_out", str(tmp_path / f"{pkg}.jsonl")]
    env = cli_env(PMDT_FAULT_PLAN="serving.decode_dispatch=fatal:1:3")
    if pkg == "port":
        cmd = ["-m", f"{PORT}.serve_lm", "--device", "cpu"]
    else:
        cmd = ["serve_lm.py"]
        env.update(JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *cmd, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = Counter(json.loads(line)["name"] for line in
                    (tmp_path / f"{pkg}.jsonl").read_text().splitlines())
    return proc.stdout, names


def test_restart_rebinds_the_fixed_stats_port(tmp_path):
    port = free_port()
    out, names = _restart_run(tmp_path, "port", port)
    assert out.count(f"stats: http://127.0.0.1:{port}/metrics") == 2
    snap = json.loads(out.split("metrics: ", 1)[1].splitlines()[0])
    assert snap["restarts"] == 1 and snap["requests_failed"] == 0
    assert (tmp_path / "port.flight.jsonl").exists()
    _, want = _restart_run(tmp_path, "jax", port)
    del want["compile.lower"]  # JAX's ahead-of-time metering
    assert names == want
    assert names["engine.fatal"] == 2  # the engine's and the loop's
