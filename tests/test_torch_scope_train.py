"""The image trainer's spans against the JAX trainer's.

Both image CLIs (2 epochs of the tiny synthetic CIFAR set, the shared
init of ``tests/main_cli_cases.py``) run in this process with
``--events_out``: the span names and their counts are equal
(``train.data``, ``train.window``, ``train.metrics_fetch``,
``train.eval_fetch``, ``train.checkpoint``, ``checkpoint.write``). JAX's
compile spans, which time XLA's lowering, have no twin. Each run's
scope is disarmed after it (``tests/test_torch_scope_train_lm.py``
holds the LM trainer's).
"""

import json
from collections import Counter

import pytest

from pytorch_multiprocessing_distributed_tpu.runtime import scope as jscope
from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch.runtime import scope

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    FLAGS, _jax_cli, _torch_cpu_state, same_init, variables)


def _counts(path):
    names = Counter(json.loads(line)["name"] for line in
                    open(path).read().splitlines())
    return {n: c for n, c in names.items() if not n.startswith("compile")}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    scope.disarm()
    jscope.disarm()


def test_image_trainer_spans_equal_jax(tmp_path, same_init, capsys):
    cli = _jax_cli()
    cli.run_model(cli.parser.parse_args(
        FLAGS + ["--epochs", "2", "--save_path", str(tmp_path / "jax"),
                 "--events_out", str(tmp_path / "jax.jsonl")]))
    port_main.main(FLAGS + ["--epochs", "2", "--device", "cpu",
                            "--save_path", str(tmp_path / "port"),
                            "--events_out", str(tmp_path / "port.jsonl")])
    got, want = _counts(tmp_path / "port.jsonl"), _counts(
        tmp_path / "jax.jsonl")
    assert got == want
    assert got["train.window"] == got["train.metrics_fetch"] == 4
    assert got["train.eval_fetch"] == 2 and got["train.checkpoint"] == 1
