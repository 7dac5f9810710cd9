"""The LM trainer's spans against the JAX ``train_lm``'s.

Both LM CLIs (1 epoch of gpt_tiny with a validation split) run in this
process with ``--events_out``: the span names and their counts are
equal (``train.data``, ``train.window``, ``train.metrics_fetch``,
``train.validate``, ``train.checkpoint``, ``checkpoint.write``). JAX's
compile spans, which time XLA's lowering, have no twin. Each run's
scope is disarmed after it.
"""

import importlib.util
import json
import os
from collections import Counter

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.runtime import scope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_FLAGS = ["--model", "gpt_tiny", "--batch_size", "8", "--seq_len", "32",
            "--corpus_tokens", "3000", "--val_frac", "0.1", "--print_freq",
            "5", "--seed", "0", "--epochs", "1"]


def _counts(path):
    names = Counter(json.loads(line)["name"] for line in
                    open(path).read().splitlines())
    return {n: c for n, c in names.items() if not n.startswith("compile")}


@pytest.fixture(autouse=True)
def _disarm():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    scope.disarm()
    jscope.disarm()


def test_lm_trainer_spans_equal_jax(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_cli", os.path.join(REPO, "train_lm.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli.main(cli.parser.parse_args(
        LM_FLAGS + ["--save_path", str(tmp_path / "jax"),
                    "--events_out", str(tmp_path / "jax.jsonl")]))
    train_lm.main(LM_FLAGS + ["--device", "cpu", "--save_path",
                              str(tmp_path / "port"), "--events_out",
                              str(tmp_path / "port.jsonl")])
    got, want = _counts(tmp_path / "port.jsonl"), _counts(
        tmp_path / "jax.jsonl")
    assert got == want
    assert got["train.validate"] == 1 and got["train.window"] >= 2
