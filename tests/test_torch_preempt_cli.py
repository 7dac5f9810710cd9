"""The SIGTERM drill of the port's image CLI, in subprocesses on the CPU
(each with its own ``PMDT_*`` env, one intra-op thread: deterministic),
the port of JAX ``train/trainer.py:191-260``: a SIGTERM during epoch 2
exits 0 at the next window boundary, keeping the real end-of-epoch
``model_1.pth`` (no mid-epoch ``model_2.pth``), and ``--resume auto``
(traced with ``--profile``, which writes a TensorBoard trace) finishes
at the uninterrupted run's ``model_3.pth``, bit for bit. Also the
sharded backend's ``--resume``, which must be ``auto`` or an epoch.
"""

import os
import re
import signal
import threading
import time

import pytest

from cli_procs import cli_env, run_cli, start_cli

IMAGE = ["--device", "cpu", "--world_size", "1", "--synthetic",
         "--batch_size", "8", "--lr", "0.01", "--seed", "0", "--epochs",
         "3", "--save_every", "1"]
SYNTH = "16"  # 2 steps of 8 images an epoch


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    root = tmp_path_factory.mktemp("plain")
    run_cli("main", IMAGE + ["--save_path", str(root)],
            PMDT_SMALL_SYNTH=SYNTH)
    return root


def test_sigterm_drill_resumes_to_plain(plain, tmp_path):
    proc = start_cli("main", IMAGE + ["--print-freq", "1", "--save_path",
                                      str(tmp_path)],
                     cli_env(PMDT_SMALL_SYNTH=SYNTH))
    lines, sent = [], False
    watchdog = threading.Timer(180, proc.kill)  # a hung child fails
    watchdog.start()
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and line.startswith("Epoch: [2][0/"):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    assert sent and rc == 0, out[-3000:]
    # noticed at the next window boundary: epoch 2's second step, or
    # under load a later window; either way the epoch before it holds
    (epoch,) = re.findall(r"^SIGTERM received: checkpointing at epoch "
                          r"(\d)", out, re.M)
    epoch = int(epoch)
    assert epoch in (2, 3)
    assert f"keeping existing {tmp_path / f'model_{epoch - 1}.pth'}" in out
    assert not (tmp_path / f"model_{epoch}.pth").exists()
    prof = tmp_path / "prof"
    t0 = time.time()
    out = run_cli("main", IMAGE + ["--resume", "auto", "--profile",
                                   str(prof), "--save_path", str(tmp_path)],
                  PMDT_SMALL_SYNTH=SYNTH)
    assert f"continuing at epoch {epoch}" in out
    assert _same_bytes(tmp_path / "model_3.pth", plain / "model_3.pth")
    traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getmtime(prof / traces[0]) >= t0


def test_orbax_resume_flag_needs_an_epoch(tmp_path):
    """``main``'s sharded resume (JAX ``main.py:338-373``): ``auto`` with
    nothing saved starts fresh; anything but ``auto`` or an epoch
    number is refused, naming both."""
    from pytorch_multiprocessing_distributed_tpu_torch import main as port_main

    args = port_main.build_parser().parse_args(
        ["--ckpt_backend", "orbax", "--resume", "auto", "--save_path",
         str(tmp_path)])
    assert port_main._orbax_resume(args, None, True) == 1
    args.resume = "last"
    with pytest.raises(SystemExit, match="--ckpt_backend orbax: --resume "
                                         "must be 'auto' or an epoch number"):
        port_main._orbax_resume(args, None, True)


def test_profiler_helpers(tmp_path):
    """``utils/profiler.py``: ``trace`` writes one TensorBoard trace of
    the region under the log dir (CPU activity here), ``annotate`` names
    a region in it, and ``StepTimer`` keeps its warmup ticks apart."""
    import json

    import torch

    from pytorch_multiprocessing_distributed_tpu_torch.utils.profiler import (
        StepTimer, annotate, trace)

    with trace(str(tmp_path / "prof"), worker_name="w"):
        with annotate("pmdt-region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    (name,) = os.listdir(tmp_path / "prof")
    assert name.startswith("w.") and name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / "prof" / name))["traceEvents"]
    assert any(e.get("name") == "pmdt-region" for e in events)
    timer = StepTimer(warmup=1)
    assert timer.tick() == 0.0  # the first tick starts the clock
    for _ in range(3):
        timer.tick()
    assert len(timer.warmup_times) == 1 and len(timer.times) == 2
    assert timer.mean >= 0.0 and timer.images_per_sec(8) >= 0.0
