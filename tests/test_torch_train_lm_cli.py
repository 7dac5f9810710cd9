"""The port's ``train_lm`` CLI on the CPU (``--device cpu``, gpt_tiny)
against the JAX package's ``train_lm.py`` run on the same seed.

The JAX CLI initialises with ``jax.random``; the port's CLI draws its
own init from a torch generator. So the port's run here starts from the
JAX run's initial params (its ``init_params`` is replaced by the carried
JAX tree), and both then read the same synthetic stream through the same
loader. Logged losses agree within 1e-4 after 2 epochs of f32 SGD (two
frameworks' f32 sums in different orders, compounded over ~40 steps).
"""

import importlib.util
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch import (
    CudaUnavailableError)
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--model", "gpt_tiny", "--batch_size", "8", "--seq_len", "32",
         "--corpus_tokens", "6000", "--val_frac", "0.1", "--print_freq",
         "5", "--seed", "0"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after:
    under the suite's parallel workers, torch's default of one thread
    per core oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_cli", os.path.join(REPO, "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    lines = path.read_text().splitlines()
    assert all(ROW.match(line) for line in lines), lines
    return [[float(x) for x in line.split()] for line in lines]


@pytest.fixture
def jax_init_params(monkeypatch):
    """Make the port's CLI start from the JAX CLI's initial params."""
    model = jax_models.get_model("gpt_tiny", dtype=jnp.float32, n_experts=0)
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1)).params)
    monkeypatch.setattr(
        train_lm, "init_params",
        lambda model, seed, device: {k: v.to(device) for k, v in
                                     from_jax_params(params).items()})


def test_logs_match_jax_cli(tmp_path, jax_init_params, capsys):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli()
    cli.main(cli.parser.parse_args(
        FLAGS + ["--epochs", "2", "--save_path", str(jax_dir)]))
    summary = train_lm.main(FLAGS + ["--epochs", "2", "--device", "cpu",
                                     "--save_path", str(port_dir)])
    out = capsys.readouterr().out
    assert "Epoch: [2][20/21]\tLoss " in out and "Val: [2]\tLoss " in out
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < 1e-4, (name, a, b)
            assert a[2] == pytest.approx(math.exp(a[1]), rel=1e-5)
    assert summary["epoch_losses"] == pytest.approx(
        [r[1] for r in _rows(port_dir / "train.log")], abs=1e-6)
    for name in ("model_2.pth", "model_2.pth.sha256"):
        assert (port_dir / name).exists()
    assert summary["steps"] == 42 and summary["launches"] == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert summary["tokens_per_sec_per_card"] == summary["tokens_per_sec"]


def test_resume_auto_continues_at_epoch_3(tmp_path, capsys):
    straight, split = tmp_path / "straight", tmp_path / "split"
    train_lm.main(FLAGS + ["--epochs", "3", "--device", "cpu",
                           "--save_path", str(straight)])
    train_lm.main(FLAGS + ["--epochs", "2", "--device", "cpu",
                           "--save_every", "1", "--save_path", str(split)])
    capsys.readouterr()
    train_lm.main(FLAGS + ["--epochs", "3", "--device", "cpu",
                           "--resume", "auto", "--save_path", str(split)])
    assert "continuing at epoch 3" in capsys.readouterr().out
    ours, ref = _rows(split / "train.log"), _rows(straight / "train.log")
    assert len(ours) == 3
    # the same run resumed: equal up to the CPU's run-to-run f32 noise
    assert sum(ours, []) == pytest.approx(sum(ref, []), rel=1e-5)
    assert (split / "model_3.pth").exists()


# The CLI rejects no flag of the JAX CLI by name: --parallel sp, --degree
# and --vocab_chunks, --parallel tp|pp, --zero, --zero1, --fsdp and
# --remat (tests/test_torch_mp_cli.py), --n_experts and --moe_top_k
# (tests/test_torch_moe_cli.py), --ckpt_backend, --ckpt_async and
# --max_restarts (tests/test_torch_restart_cli.py,
# test_torch_sharded_ckpt.py), --stats_port, --trace_out and --events_out
# (test_observability_flags_run below), --hf_init, --hf_export and
# --sample_beams (tests/test_torch_lm_hf_cli*.py,
# test_torch_lm_beams_cli.py) are all ported.


@pytest.mark.parametrize("flag", ["--stats_port", "--trace_out",
                                  "--events_out"])
def test_observability_flags_run(tmp_path, capsys, flag):
    """Each observability flag runs (it was rejected before this port
    had it) and leaves its artifact: the stats line of a server that
    bound and was closed again, a Chrome trace, the JSONL event log."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.dist import (
        free_port)
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
        fleet, hbm, scope)

    value = {"--stats_port": str(free_port()),
             "--trace_out": str(tmp_path / "t.json"),
             "--events_out": str(tmp_path / "e.jsonl")}[flag]
    try:
        train_lm.main(FLAGS + ["--device", "cpu", "--epochs", "1",
                               "--save_path", str(tmp_path), flag, value])
    finally:
        scope.disarm()
        hbm.disarm()
        fleet.disarm_goodput()
    out = capsys.readouterr().out
    if flag == "--stats_port":
        assert f"stats: http://127.0.0.1:{value}/metrics" in out
        import socket

        with socket.socket() as sock:  # the listener was closed
            sock.bind(("127.0.0.1", int(value)))
    elif flag == "--trace_out":
        trace = json.loads((tmp_path / "t.json").read_text())
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"train.window", "train.metrics_fetch",
                "train.checkpoint"} <= names
    else:
        rows = [json.loads(line) for line in
                (tmp_path / "e.jsonl").read_text().splitlines()]
        assert sum(r["name"] == "train.window" for r in rows) >= 2


def test_flag_checks_in_jax_order(tmp_path):
    with pytest.raises(SystemExit, match="max_seq_len"):
        train_lm.main(["--seq_len", "4096", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--warmup_epochs"):
        train_lm.main(["--warmup_epochs", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--val_frac"):
        train_lm.main(["--val_frac", "1.5", "--device", "cpu"])


def test_sample_and_text_corpus(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    train_lm.main(["--model", "gpt_tiny", "--batch_size", "4",
                   "--seq_len", "32", "--epochs", "1", "--device", "cpu",
                   "--corpus", str(corpus), "--sample", "4",
                   "--save_path", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert re.search(r"^sample: \[\d+, \d+, \d+, \d+\]$", out, re.M)
    assert "sample text:" in out


def test_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(CudaUnavailableError):
        train_lm.main(FLAGS + ["--save_path", str(tmp_path)])
