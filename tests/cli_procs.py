"""The port's CLIs in subprocesses, for the fault-tolerance tests
(``tests/test_torch_sharded_ckpt.py``, ``test_torch_restart_cli.py``):
each process gets its own ``PMDT_*`` env (never the pytest process's)
and one intra-op thread."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "pytorch_multiprocessing_distributed_tpu_torch"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMDT_")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def start_cli(module: str, argv, env: dict) -> subprocess.Popen:
    """``python -u -m {PORT}.{module} argv``, its output merged and piped."""
    return subprocess.Popen(
        [sys.executable, "-u", "-m", f"{PORT}.{module}", *argv], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def run_cli(module: str, argv, ranks: int = 0, timeout: float = 240,
            **env) -> str:
    """Run a CLI to its end: one process, or ``ranks`` processes of one
    gloo group (``PMDT_MASTER_ADDR``/``WORLD_SIZE``/``RANK``). Asserts
    every exit code is 0; returns the first process's output."""
    port = free_port()
    procs = [start_cli(module, argv, cli_env(
        **env, **({} if not ranks else dict(
            PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
            PMDT_WORLD_SIZE=str(ranks), PMDT_RANK=str(rank)))))
        for rank in range(max(1, ranks))]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs[0]
