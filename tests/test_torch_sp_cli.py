"""The port's ``train_lm --parallel sp`` against the JAX CLI, and the
SP flag checks in the JAX CLI's order.

The port's CLI runs ``--device cpu --parallel sp --degree 2 --sp_mode
zigzag`` on two gloo ranks (``tests/torch_sp_worker.py:cli_rank``), the
JAX CLI the same flags on two of the conftest's virtual devices. Both
build gpt_tiny cut to one block (JAX's SP steps take seconds each in
interpret mode) and the port starts from the JAX CLI's initial params,
as ``tests/test_torch_train_lm_cli.py`` does; ``train.log`` rows agree
within 1e-4.
"""

import importlib.util
import math
import os
import re
import socket

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from torch_sp_worker import cli_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 1
FLAGS = ["--model", "gpt_tiny", "--batch_size", "2", "--seq_len", "32",
         "--corpus_tokens", "64", "--epochs", "2", "--print_freq", "1",
         "--seed", "0", "--parallel", "sp", "--degree", "2", "--sp_mode",
         "zigzag"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    lines = path.read_text().splitlines()
    assert all(ROW.match(line) for line in lines), lines
    return [[float(x) for x in line.split()] for line in lines]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sp_cli_logs_match_jax_cli(tmp_path, monkeypatch):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    jax_get = jax_models.get_model
    monkeypatch.setattr(jax_models, "get_model", lambda name, **kw: jax_get(
        name, num_layers=LAYERS, **kw))
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_cli", os.path.join(REPO, "train_lm.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli.main(cli.parser.parse_args(FLAGS + ["--save_path", str(jax_dir)]))

    model = jax_get("gpt_tiny", num_layers=LAYERS, dtype=jnp.float32)
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1)).params)
    params_path = tmp_path / "params.pt"
    torch.save(from_jax_params(params), params_path)
    port_dir.mkdir()
    argv = FLAGS + ["--device", "cpu", "--sample", "3", "--save_path",
                    str(port_dir)]
    mp.spawn(cli_rank, args=(2, _free_port(), argv, str(params_path),
                             LAYERS), nprocs=2, join=True)
    summary = torch.load(port_dir / "summary.pt", weights_only=False)
    ours, ref = _rows(port_dir / "train.log"), _rows(jax_dir / "train.log")
    assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
    for a, b in zip(ours, ref):
        assert abs(a[1] - b[1]) < 1e-4, (a, b)
        assert a[2] == pytest.approx(math.exp(a[1]), rel=1e-5)
    assert summary["grid"] == [1, 2] and summary["world_size"] == 2
    assert summary["steps"] == 2
    for name in ("model_2.pth", "model_2.pth.sha256"):
        assert (port_dir / name).exists()


def _args(*extra):
    return train_lm.build_parser().parse_args(
        ["--model", "gpt_tiny", "--parallel", "sp", *extra])


@pytest.mark.parametrize("extra,world,words", [
    (["--degree", "2"], 3, "3 ranks not divisible by --degree 2"),
    (["--degree", "4", "--seq_len", "30"], 4,
     "seq_len 30 is not divisible by the sequence-axis size 4 (mesh axis "
     "'seq')"),
    (["--degree", "3", "--seq_len", "48", "--sp_mode", "ulysses"], 3,
     "ulysses_attention needs heads (4) divisible by the sequence-axis "
     "size (3); use ring_attention for head counts that do not divide"),
    (["--degree", "4", "--seq_len", "36", "--sp_mode", "zigzag"], 4,
     "zigzag needs seq_len divisible by 2 x n_shards (36 vs 2 x 4)"),
])
def test_grid_checks_keep_jax_words(extra, world, words):
    """The checks of the ranks and the sequence against ``--degree``, as
    the JAX CLI and its step word them."""
    args = _args(*extra)
    model = get_model("gpt_tiny", seq_axis="seq", sp_mode=args.sp_mode)
    with pytest.raises(SystemExit) as err:
        train_lm._check_grid(args, model, world)
    assert str(err.value) == words


def test_sp_degree_one_rank_is_refused_before_the_run(tmp_path):
    """One process cannot hold --degree 2: it raises before any file is
    written (the run never quietly takes degree 1)."""
    with pytest.raises(SystemExit, match="1 ranks not divisible by "
                                         "--degree 2"):
        train_lm.main(["--parallel", "sp", "--degree", "2", "--device",
                       "cpu", "--save_path", str(tmp_path)])
    assert not (tmp_path / "train.log").exists()


@pytest.mark.parametrize("extra,words", [
    (["--parallel", "tp", "--vocab_chunks", "4"],
     "--vocab_chunks streams the head inside the dp/sp step"),
    (["--parallel", "pp", "--vocab_chunks", "4"],
     "--vocab_chunks streams the head inside the dp/sp step"),
    (["--parallel", "tp"], "--parallel is not ported"),
    (["--parallel", "pp", "--pp_schedule", "1f1b"],
     "--parallel is not ported"),
    (["--parallel", "sp", "--pp_schedule", "1f1b"],
     "--pp_schedule 1f1b only applies to --parallel pp"),
    (["--parallel", "sp", "--seq_len", "4096"], "max_seq_len"),
])
def test_flag_checks_in_jax_order(tmp_path, extra, words):
    with pytest.raises(SystemExit, match=re.escape(words)):
        train_lm.main(["--device", "cpu", "--save_path", str(tmp_path)]
                      + extra)


@pytest.mark.parametrize("extra", [["--degree", "2"],
                                   ["--parallel", "sp", "--sp_mode",
                                    "ulysses"],
                                   ["--vocab_chunks", "4"]])
def test_one_process_runs(tmp_path, extra):
    """``--degree`` under ``--parallel dp`` is ignored as JAX ignores it;
    SP at degree 1 and ``--vocab_chunks`` train in one process."""
    summary = train_lm.main(
        ["--model", "gpt_tiny", "--batch_size", "4", "--seq_len", "32",
         "--corpus_tokens", "512", "--epochs", "1", "--device", "cpu",
         "--save_path", str(tmp_path)] + extra)
    assert summary["steps"] == 4 and math.isfinite(
        summary["epoch_losses"][0])
    assert (tmp_path / "train.log").exists()
