"""``serve_lm --tp 2 --stdin`` kept alive on the CPU (gloo ranks, each
run a fresh interpreter): a source that stays quiet for longer than the
group's timeout serves on, a rank lost while the source is quiet is
named by the liveness gate, and a follower whose engine leaves rank 0's
lockstep raises."""

import queue
import subprocess
import sys
import threading
import time

import pytest

from cli_procs import REPO, cli_env, free_port

MODULE = "pytorch_multiprocessing_distributed_tpu_torch.serve_lm"
BASE = ["--device", "cpu", "--model", "gpt_tiny", "--random_init",
        "--max_new_tokens", "8", "--max_slots", "3", "--stdin"]
LINES = ["hello tensor parallel\n", "second line\n"]
HEARTBEAT = "1:3:0.1"  # soft, hard, interval (s)


def _start(argv, **env):
    return subprocess.Popen([sys.executable, "-u", "-m", MODULE, *argv],
                            cwd=REPO, env=cli_env(**env),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _lines(stream) -> queue.Queue:
    box: queue.Queue = queue.Queue()

    def pump():
        for line in stream:
            box.put(line)
        box.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return box


def _await_token(box: queue.Queue, seen: list, timeout: float = 120):
    """Read ``box`` into ``seen`` up to the first streamed token (the
    CLI steps once a line read: the request finishes at the drain)."""
    deadline = time.monotonic() + timeout
    while True:
        line = box.get(timeout=max(0.0, deadline - time.monotonic()))
        assert line is not None, "".join(seen)[-3000:]
        seen.append(line)
        if line.startswith("req="):
            return


def _transcripts(out: str) -> dict:
    return dict(line.split(" ", 1) for line in out.splitlines()
                if " tokens=" in line)


def _stop(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def test_quiet_stdin_outlasts_the_group_timeout():
    """The second line comes 7 s after the first with ``PMDT_INIT_TIMEOUT
    =4`` (the group's collective timeout) and the heartbeat's hard
    timeout of 3 s: rank 1 waits on the store, both ranks keep beating,
    and the run serves both lines as ``--tp 1`` does."""
    ref = subprocess.run([sys.executable, "-m", MODULE, *BASE], cwd=REPO,
                         env=cli_env(), input="".join(LINES),
                         capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr[-3000:]
    proc = _start(BASE + ["--tp", "2"], PMDT_INIT_TIMEOUT="4",
                  PMDT_HEARTBEAT=HEARTBEAT)
    try:
        box, seen = _lines(proc.stdout), []
        proc.stdin.write(LINES[0])
        proc.stdin.flush()
        _await_token(box, seen)
        time.sleep(7)
        proc.stdin.write(LINES[1])
        proc.stdin.close()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()[-3000:]
        while (line := box.get(timeout=30)) is not None:
            seen.append(line)
    finally:
        _stop(proc)
    got = _transcripts("".join(seen))
    assert len(got) == 2 and got == _transcripts(ref.stdout)


def test_rank_lost_while_stdin_is_quiet_is_named():
    """Two ranks joined through the env under ``PMDT_HEARTBEAT``: rank 1
    is killed after the first token while rank 0 waits on its
    ``--stdin``; rank 0's gate, beating while it waits, raises a
    ``PeerLostError`` naming rank 1 within the hard timeout."""
    port = free_port()
    env = dict(PMDT_MASTER_ADDR=f"127.0.0.1:{port}", PMDT_WORLD_SIZE="2",
               PMDT_HEARTBEAT=HEARTBEAT)
    rank0 = _start(BASE + ["--tp", "2"], PMDT_RANK="0", **env)
    rank1 = _start(BASE + ["--tp", "2"], PMDT_RANK="1", **env)
    try:
        rank1.stdin.close()
        box, seen = _lines(rank0.stdout), []
        rank0.stdin.write(LINES[0])
        rank0.stdin.flush()
        _await_token(box, seen)
        rank1.kill()
        rank1.wait()
        t0 = time.monotonic()
        rc = rank0.wait(timeout=60)
        waited = time.monotonic() - t0
        err = rank0.stderr.read()
    finally:
        _stop(rank0, rank1)
    assert rc != 0
    assert "PeerLostError" in err and "peer '1' lost" in err, err[-3000:]
    assert waited < 30


@pytest.mark.parametrize("want", ["rejected", "queue full"])
def test_follower_raises_when_it_leaves_the_lockstep(want):
    """A follower replays rank 0's submissions and raises where its
    outcome differs from rank 0's (here rank 0 is said to have refused a
    request this rank's engine accepts)."""
    import torch

    from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
    from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)

    model = get_model("gpt_tiny", dtype=torch.float32)
    model.load_state_dict(init_params(model, 0, "cpu"), assign=True)

    class Channel:
        def recv(self, idle=None):
            # a submission: its prompt, max_new_tokens, uid, deadline
            # and rank 0's outcome
            return {"tried": [["submit", [1, 2, 3], 4, "src-0", None,
                               want]], "final": False}

    feed = serve_lm._Lockstep(ServingEngine(model, max_slots=2), Channel())
    with pytest.raises(RuntimeError, match=(
            f"left rank 0's lockstep: request src-0 was accepted here "
            f"and {want} on rank 0")):
        feed.follow()
