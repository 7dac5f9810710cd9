"""Fault tolerance under ``serve_lm --tp 2`` on two gloo ranks, against
the JAX CLI's ``--tp 2`` on the CPU devices (in this process, on the
same gpt_tiny weights): after a fatal at the decode dispatch's 3rd hit on
every rank, ``--journal --max_restarts 1`` restarts both ranks at the
same pass, and the transcripts, ``requests_redelivered`` and the empty
journal equal JAX's; SIGTERM to the CLI that spawned the ranks, under
``--drain_deadline_s``, drains: the short requests finish inside the
deadline, the long ones fail overdue named, both ranks end with the same
outcomes (the CLI raises otherwise) and exit 0; deadlines through the
store lockstep expire the same uids on every rank, rank 0's clock
deciding.
"""

import contextlib
import io
import json
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import serve_lm as jax_serve_lm
from pytorch_multiprocessing_distributed_tpu.runtime import (
    faults as jfaults)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from cli_procs import PORT, REPO, cli_env, free_port, start_cli
from serving_heal_cases import GEOM, models, prompts, tiny_ckpts
from torch_serving_tp_worker import lockstep_rank

FATAL = "seed=0;serving.decode_dispatch=fatal:1:3"
BASE = ["--model", "gpt_tiny", "--synthetic", "6", "--max_slots", "3",
        "--s_max", "64", "--decode_buckets", "off", "--max_new_tokens",
        "16", "--seed", "1"]
# the drain drill at horizon 1: three short and three long requests in
# six slots; the SIGTERM goes after 8 tokens of each, so the drain has 4
# steps to finish the short ones and 152 for the long ones
DRILL = ["--device", "cpu", "--model", "gpt_tiny", "--random_init",
         "--max_slots", "6", "--tp", "2", "--drain_deadline_s", "0.6"]
DRILL_NEW = (12, 12, 12, 160, 160, 160)
DRILL_SIGNAL_AT = 6 * 8
TIMEOUT_S = 120


def _transcripts(text):
    found = re.findall(r"^req=(\S+) tokens=(\[.*\])$", text, re.M)
    assert len({u for u, _ in found}) == len(found), "a uid finished twice"
    return dict(found)


def _metrics(text):
    return json.loads(re.search(r"^metrics: (\{.*\})$", text,
                                re.M).group(1))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return tiny_ckpts(tmp_path_factory.mktemp("tp_heal"))


def test_tp2_restart_matches_jax_cli(ckpts, tmp_path, monkeypatch):
    npz, msgpack = ckpts
    port_wal, jax_wal = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    heal_flags = ["--max_restarts", "1", "--restart_backoff", "0", "--tp",
                  "2"]
    # the port's two ranks run while the JAX CLI serves here
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.serve_lm", "--device", "cpu",
         *BASE, *heal_flags, "--ckpt", npz, "--journal", str(port_wal)],
        cwd=REPO, env=cli_env(PMDT_FAULT_PLAN=FATAL),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        monkeypatch.setattr(sys, "argv", [
            "serve_lm.py", *BASE, *heal_flags, "--ckpt", msgpack,
            "--journal", str(jax_wal)])
        buf = io.StringIO()
        with jfaults.armed(jfaults.plan_from_spec(FATAL)), \
                contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_serve_lm.main()
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    want, jsnap = _transcripts(buf.getvalue()), _metrics(buf.getvalue())
    got, snap = _transcripts(out), _metrics(out)
    assert len(got) == 6 and got == want
    assert "graftheal: restart 1: engine rebuilt" in out
    assert err.count("graftheal: restart 1/1 after GraftFaultError") == 2
    assert snap["restarts"] == 1 and snap["tp"] == 2
    assert snap["requests_redelivered"] == jsnap["requests_redelivered"] > 0
    assert port_wal.read_text() == jax_wal.read_text() == ""


def test_tp2_sigterm_drains_every_rank_alike(tmp_path):
    """``serve_lm --tp 2`` as a user starts it (the CLI spawns its two
    ranks); SIGTERM to that process after its 48th token line."""
    wal, reqs = tmp_path / "wal.jsonl", tmp_path / "requests.jsonl"
    rng = np.random.default_rng(0)
    reqs.write_text("".join(
        json.dumps({"prompt": rng.integers(0, 257, (8,)).tolist(),
                    "max_new_tokens": n}) + "\n" for n in DRILL_NEW))
    proc = start_cli("serve_lm", DRILL + ["--requests", str(reqs),
                                          "--journal", str(wal)], cli_env())
    lines, toks, done_before = [], 0, None
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for line in proc.stdout:
            lines.append(line)
            if " tok=" in line:
                toks += 1
                if toks == DRILL_SIGNAL_AT:
                    done_before = "".join(lines).count(" tokens=")
                    proc.send_signal(signal.SIGTERM)
            assert time.monotonic() < deadline, "the CLI outlived its bound"
        rc = proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    assert rc == 0, out[-3000:]
    snap = _metrics(out)
    failed = re.findall(r"^failed: req=(\S+) reason=(\S+) (\w+):", out, re.M)
    # the short requests finished inside the deadline, after the signal
    assert done_before == 0
    assert sorted(_transcripts(out)) == ["src-0", "src-1", "src-2"]
    assert sorted(failed) == [(f"src-{i}", "drain", "DeadlineExceeded")
                              for i in (3, 4, 5)]
    # both ranks ended with these outcomes (the CLI compares them)
    assert [(r["requests_completed"], r["requests_failed"])
            for r in snap["tp_ranks"]] == [(3, 3), (3, 3)]
    assert wal.read_text() == ""  # every admitted request is terminal


def test_lockstep_deadlines_expire_alike_on_every_rank(tmp_path):
    """Rank 0's clock decides: ``d0`` (deadline 0) expires at the first
    step, ``d2`` (a 20 ms budget over 24 tokens) while it runs, and the
    drain's 0 s deadline fails whatever is left; rank 1 replays each
    decision and ends with the same states."""
    _, jparams, _ = models()
    ps = prompts()
    inputs = {"geometry": GEOM, "params": from_jax_params(jparams),
              "kw": dict(max_slots=2, s_max=32, min_bucket=8,
                         retry_backoff_s=0.0),
              "requests": [(ps[0], 4, 0.0), (ps[1], 4, None),
                           (ps[2], 16, 0.02), (ps[3], 16, None)],
              "steps": 6, "drain_s": 0.0}
    path, out = tmp_path / "inputs.pt", tmp_path / "out"
    torch.save(inputs, path)
    ctx = mp.start_processes(lockstep_rank, args=(
        2, free_port(), str(path), str(out)), nprocs=2, join=False,
        start_method="spawn")
    try:
        while not ctx.join(timeout=TIMEOUT_S):
            pass
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    assert ranks[0] == ranks[1]
    states = ranks[0]["states"]
    assert states["d0"][:2] == ("failed", "deadline")
    assert states["d1"][0] == "done"
    reasons = {s[1] for s in states.values() if s[0] == "failed"}
    assert reasons <= {"deadline", "drain"}
    assert ranks[0]["failed"] == sum(s[0] == "failed"
                                     for s in states.values())
