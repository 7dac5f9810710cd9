"""The port's ``serve_lm`` fault tolerance through the CLI, in
subprocesses on the CPU (each with its own ``PMDT_*`` env): a supervised
restart under ``PMDT_FAULT_PLAN`` with ``--journal --max_restarts 1``,
the crashed engine freed before the rebuild (in process), SIGTERM with
``--drain_deadline_s``, a SIGKILL followed by a re-run of
the same command, and the heal flags accepted under ``--tp 2``. The
transcripts are held to an uninterrupted run of the same command.
"""

import contextlib
import io
import json
import re
import signal
import time
import weakref

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
from pytorch_multiprocessing_distributed_tpu_torch.runtime import faults, heal
from pytorch_multiprocessing_distributed_tpu_torch.serving import ServingEngine

from cli_procs import cli_env, start_cli

BASE = ["--device", "cpu", "--model", "gpt_tiny", "--random_init",
        "--synthetic", "6", "--max_slots", "3", "--decode_horizon", "4",
        "--max_new_tokens", "16"]
# the drain drill: longer streams at horizon 1, so a SIGTERM finds them
# in flight
LONG = BASE[:-3] + ["1", "--max_new_tokens", "60"]
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _transcripts(text):
    found = re.findall(r"^req=(\S+) tokens=(\[.*\])$", text, re.M)
    uids = [uid for uid, _ in found]
    assert len(set(uids)) == len(uids), f"a uid finished twice: {uids}"
    return {uid: json.loads(toks) for uid, toks in found}


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted runs' transcripts (in this process)."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, argv in (("base", BASE), ("long", LONG)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve_lm.main(argv)
            out[name] = _transcripts(buf.getvalue())
    finally:
        torch.set_num_threads(threads)
    assert len(out["base"]) == 6 and len(out["long"]) == 6
    return out


def _run(argv, stop_at=None, sig=None, **env):
    """The CLI in a subprocess: its merged output and exit code; ``sig``
    is sent 10 ms after the ``stop_at``-th token line (the process has
    printed that step's events and is inside the next step)."""
    proc = start_cli("serve_lm", argv, cli_env(**env))
    lines, toks = [], 0
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for line in proc.stdout:
            lines.append(line)
            if " tok=" in line:
                toks += 1
                if sig is not None and toks == stop_at:
                    time.sleep(0.01)
                    proc.send_signal(sig)
            assert time.monotonic() < deadline, "the CLI outlived its bound"
        rc = proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return "".join(lines), rc


def _metrics(out):
    return json.loads(re.search(r"^metrics: (\{.*\})$", out, re.M).group(1))


def test_supervised_restart_is_token_exact(reference, tmp_path):
    wal = tmp_path / "wal.jsonl"
    out, rc = _run(BASE + ["--journal", str(wal), "--max_restarts", "1",
                           "--restart_backoff", "0"],
                   PMDT_FAULT_PLAN="seed=0;serving.decode_dispatch=fatal:1:3")
    assert rc == 0, out[-3000:]
    snap = _metrics(out)
    assert snap["restarts"] == 1 and snap["requests_redelivered"] > 0
    assert "graftheal: restart 1: engine rebuilt" in out
    assert _transcripts(out) == reference["base"]
    assert wal.read_text() == ""  # the clean drain compacted it empty


def test_restart_frees_the_crashed_engine(reference, tmp_path, monkeypatch):
    """In process: when the supervisor rebuilds, the crashed engine (its
    KV pool with it) is already gone; the snapshot is the last engine's,
    and ``attempts`` holds each engine's decode passes."""
    built, alive = [], []

    def engine(*a, **kw):
        alive.append([ref() is not None for ref in built])
        e = ServingEngine(*a, **kw)
        built.append(weakref.ref(e))
        return e

    monkeypatch.setattr(serve_lm, "ServingEngine", engine)
    buf = io.StringIO()
    plan = faults.plan_from_spec("seed=0;serving.decode_dispatch=fatal:1:3")
    with faults.armed(plan), contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        snap = serve_lm.main(BASE + [
            "--journal", str(tmp_path / "wal.jsonl"), "--max_restarts", "1",
            "--restart_backoff", "0"])
    assert alive == [[], [False]]
    assert _transcripts(buf.getvalue()) == reference["base"]
    assert snap["restarts"] == 1 and len(snap["attempts"]) == 2
    first, last = snap["attempts"]
    assert first["decode_passes_by_k"] == {"0": 3}  # the fatal's hit 3
    assert snap["decode_passes_by_k"] == last["decode_passes_by_k"]
    assert snap["decode_launches"] == last["decode_launches"]
    # the rebuilt engine's counters: it served every request again
    assert snap["requests_redelivered"] == snap["requests_completed"] == 6


def test_sigterm_drains_and_fails_overdue_named(reference, tmp_path):
    wal = tmp_path / "wal.jsonl"
    out, rc = _run(LONG + ["--journal", str(wal), "--drain_deadline_s",
                           "0.001"], stop_at=10, sig=signal.SIGTERM)
    assert rc == 0, out[-3000:]
    snap = _metrics(out)
    done = _transcripts(out)
    failed = re.findall(r"^failed: req=(\S+) reason=(\S+) (\w+):", out,
                        re.M)
    assert failed, "the drain deadline failed no in-flight request"
    assert {(r, e) for _, r, e in failed} == {("drain", "DeadlineExceeded")}
    assert snap["requests_failed"] == len(failed)
    assert snap["requests_completed"] == len(done)
    assert len(done) + len(failed) == 6
    assert all(reference["long"][uid] == toks for uid, toks in done.items())
    assert wal.read_text() == ""  # every admitted request is terminal


def test_sigkill_then_rerun_redelivers_once(reference, tmp_path):
    wal = tmp_path / "wal.jsonl"
    argv = BASE + ["--journal", str(wal)]
    first, rc = _run(argv, stop_at=40, sig=signal.SIGKILL)
    assert rc == -signal.SIGKILL
    before = _transcripts(first)
    # journaled done but not yet printed when the kill landed: counted
    unprinted = {e.uid: e.tokens for e in heal.load_journal_entries(str(wal))
                 if e.done and e.uid not in before}
    second, rc = _run(argv)
    assert rc == 0, second[-3000:]
    after = _transcripts(second)
    assert _metrics(second)["requests_redelivered"] == 6 - len(before) - len(
        unprinted)
    again = {m for m in re.findall(r"^req=(\S+) ", second, re.M)}
    assert not (again & (set(before) | set(unprinted)))
    assert {**before, **unprinted, **after} == reference["base"]
    assert wal.read_text() == ""


@pytest.mark.parametrize("flag,value", [("--journal", "w.jsonl"),
                                        ("--max_restarts", "1"),
                                        ("--drain_deadline_s", "1.0")])
def test_heal_flags_refused_under_tp(flag, value):
    """The heal flags ``--tp 2`` refused until rank 0's lockstep carried
    their decisions are now accepted by the CLI's checks (the name is
    kept from then; ``tests/test_torch_serve_tp_heal.py`` runs them on
    two ranks)."""
    args = serve_lm.build_parser().parse_args(
        ["--device", "cpu", "--random_init", "--tp", "2", flag, value])
    serve_lm._check_args(args)
    assert not hasattr(serve_lm, "TP_REFUSED")
