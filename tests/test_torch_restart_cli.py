"""The port's CLIs under faults, in subprocesses on the CPU (each with its
own ``PMDT_*`` env, one intra-op thread: the runs are deterministic):

- ``main --max_restarts 1`` with epoch 2's checkpoint write failing once
  (``PMDT_FAULT_PLAN``) restarts, resumes from ``model_1.pth`` and ends
  with the rows and the ``model_3.pth`` payload of the port's
  uninterrupted run, which ``tests/test_torch_main_cli.py`` holds
  against the JAX CLI; the same for ``train_lm`` (against the run
  ``tests/test_torch_train_lm_cli.py`` holds);
- the JAX CLIs' checks of the restart and checkpoint flags, and a
  restart budget that runs out.

The SIGTERM drill is in ``tests/test_torch_preempt_cli.py``.
"""

import re

import pytest

from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch import train_lm

from cli_procs import cli_env, run_cli, start_cli

PLAN = "seed=0;train.checkpoint_write=error:1:1"  # epoch 2's save, once
IMAGE = ["--device", "cpu", "--world_size", "1", "--synthetic",
         "--batch_size", "8", "--lr", "0.01", "--seed", "0", "--epochs",
         "3", "--save_every", "1"]
LM = ["--device", "cpu", "--model", "gpt_tiny", "--seq_len", "32",
      "--batch_size", "8", "--corpus_tokens", "2000", "--lr", "0.01",
      "--epochs", "3", "--save_every", "1"]
SYNTH = "16"  # 2 steps of 8 images an epoch


def _rows(path):
    """``{epoch: row text}`` (a restarted epoch's row repeats; both are
    kept in the count) and the number of rows."""
    lines = [line.split() for line in open(path) if line.strip()]
    return {int(r[0]): r for r in lines}, len(lines)


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The uninterrupted runs of both CLIs."""
    root = tmp_path_factory.mktemp("plain")
    run_cli("main", IMAGE + ["--save_path", str(root / "image")],
            PMDT_SMALL_SYNTH=SYNTH)
    run_cli("train_lm", LM + ["--save_path", str(root / "lm")])
    return root


@pytest.mark.parametrize("cli", ["main", "train_lm"])
def test_restart_after_checkpoint_fault_matches_plain(cli, plain,
                                                      tmp_path):
    argv = (IMAGE if cli == "main" else LM) + [
        "--max_restarts", "1", "--restart_backoff", "0", "--save_path",
        str(tmp_path)]
    out = run_cli(cli, argv, PMDT_FAULT_PLAN=PLAN, PMDT_SMALL_SYNTH=SYNTH)
    assert re.search(r"graftheal: restart 1/1 after FaultInjected: .*"
                     r"'train\.checkpoint_write'", out)
    assert re.findall(r"^Resumed from (.*) \(continuing at epoch (\d)\)$",
                      out, re.M) == [(str(tmp_path / "model_1.pth"), "2")]
    ref_dir = plain / ("image" if cli == "main" else "lm")
    ours, n = _rows(tmp_path / "train.log")
    ref, n_ref = _rows(ref_dir / "train.log")
    assert ours == ref and (n, n_ref) == (4, 3)  # epoch 2's row twice
    if cli == "main":
        assert _rows(tmp_path / "test.log")[0] == _rows(
            ref_dir / "test.log")[0]
    assert _same_bytes(tmp_path / "model_3.pth", ref_dir / "model_3.pth")


def test_restart_budget_runs_out(tmp_path):
    """Every checkpoint write fails: one restart, then the named
    ``RestartBudgetExhausted`` chained to the last fault."""
    proc = start_cli("train_lm", LM + [
        "--epochs", "1", "--max_restarts", "1", "--restart_backoff", "0",
        "--save_path", str(tmp_path)],
        cli_env(PMDT_FAULT_PLAN="train.checkpoint_write=error:0"))
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode != 0
    assert "RestartBudgetExhausted: restart budget exhausted: 1 " \
           "restart(s) allowed" in out
    assert "The above exception was the direct cause" in out


def test_flag_checks_in_jax_order(tmp_path):
    """The JAX CLIs' checks of the restart and checkpoint flags; the
    pure-flag ones before any device or data work."""
    base = ["--device", "cpu", "--save_path", str(tmp_path / "run")]
    with pytest.raises(SystemExit, match="--ckpt_async applies to "
                                         "--ckpt_backend orbax"):
        train_lm.main(base + ["--ckpt_async"])
    with pytest.raises(SystemExit, match="--resume must be 'auto' or an "
                                         "epoch number"):
        train_lm.main(base + ["--ckpt_backend", "orbax", "--resume",
                              "model_1.pth"])
    with pytest.raises(SystemExit, match="--zero checkpoints via msgpack"):
        train_lm.main(base + ["--zero", "--ckpt_backend", "orbax"])
    with pytest.raises(SystemExit, match="--zero checkpoints via msgpack"):
        port_main.main(base + ["--zero", "--ckpt_backend", "orbax",
                               "--world_size", "1"])
    assert not (tmp_path / "run" / "train.log").exists()
