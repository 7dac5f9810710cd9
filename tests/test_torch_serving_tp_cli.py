"""``serve_lm --tp M`` on the CPU, each run a fresh interpreter
(``tests/cli_procs.py``): M gloo ranks spawned by the CLI itself, or
joined through the ``PMDT_*`` env, serve the transcripts of the ``--tp
1`` run; rank 0 alone streams them (and reads ``--stdin``); the summary
carries ``tp`` and a rank's bytes; ``PMDT_WORLD_SIZE`` must be M."""

import json
import subprocess
import sys

import pytest

from cli_procs import REPO, cli_env, free_port, start_cli

MODULE = "pytorch_multiprocessing_distributed_tpu_torch.serve_lm"
BASE = ["--device", "cpu", "--model", "gpt_tiny", "--random_init",
        "--max_new_tokens", "8", "--max_slots", "3"]


def _run(argv, timeout=240, stdin=None, **env):
    return subprocess.run([sys.executable, "-m", MODULE, *argv], cwd=REPO,
                          env=cli_env(**env), input=stdin,
                          capture_output=True, text=True, timeout=timeout)


def _transcripts(out: str) -> dict:
    lines = [line for line in out.splitlines() if " tokens=" in line]
    got = dict(line.split(" ", 1) for line in lines)
    assert len(got) == len(lines), "a request streamed twice"
    return got


def _metrics(out: str) -> dict:
    lines = [line for line in out.splitlines()
             if line.startswith("metrics: ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("metrics: "):])


@pytest.fixture(scope="module")
def one_rank():
    proc = _run(BASE + ["--synthetic", "4"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_spawned_ranks_stream_rank0_only(one_rank):
    proc = _run(BASE + ["--synthetic", "4", "--tp", "2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = _transcripts(proc.stdout)
    assert len(got) == 4 and got == _transcripts(one_rank)
    snap, single = _metrics(proc.stdout), _metrics(one_rank)
    assert snap["tp"] == 2 and single["tp"] == 1
    assert snap["kv_pool_bytes"] * 2 == single["kv_pool_bytes"]
    assert (snap["param_bytes"] - snap["small_leaf_bytes"]
            == snap["jax_param_bytes"] - snap["small_leaf_bytes"] // 2)
    steps = sum(snap["decode_passes_by_k"].values())
    assert snap["tp_decode_gathers"] == steps * (1 + 4 * 4)


def test_ranks_joined_through_the_env(one_rank):
    port = free_port()
    procs = [start_cli("serve_lm", BASE + ["--synthetic", "4", "--tp", "2"],
                       cli_env(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                               PMDT_WORLD_SIZE="2", PMDT_RANK=str(rank)))
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:]
    assert _transcripts(outs[0]) == _transcripts(one_rank)
    assert "req=" not in outs[1] and "metrics: " not in outs[1]


def test_rank0_reads_stdin():
    text = "hello tensor parallel\nsecond line\n"
    ref = _run(BASE + ["--stdin"], stdin=text)
    got = _run(BASE + ["--stdin", "--tp", "2"], stdin=text)
    assert ref.returncode == 0 and got.returncode == 0, got.stderr[-3000:]
    assert len(_transcripts(ref.stdout)) == 2
    assert _transcripts(got.stdout) == _transcripts(ref.stdout)


def test_world_size_must_be_tp():
    proc = _run(BASE + ["--tp", "2"], PMDT_MASTER_ADDR="127.0.0.1:1",
                PMDT_WORLD_SIZE="4", PMDT_RANK="0", timeout=60)
    assert proc.returncode != 0
    assert "--tp 2 serves on 2 ranks but PMDT_WORLD_SIZE=4" in proc.stderr
