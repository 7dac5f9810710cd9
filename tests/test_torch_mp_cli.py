"""The port's ``train_lm --parallel tp|pp`` against the JAX CLI, and the
model-parallel flag checks in the JAX CLI's order.

The port's CLI runs ``--device cpu --degree 2`` on two gloo ranks
(``tests/torch_mp_worker.py:cli_rank``), the JAX CLI the same flags on
two of the conftest's virtual devices; both build gpt_tiny cut to two
blocks and the port starts from the JAX CLI's initial params, as
``tests/test_torch_sp_cli.py`` does. ``train.log`` and ``test.log``
rows agree within 1e-4 and ``--sample`` prints JAX's greedy tokens. A
pipelined checkpoint holds JAX's stacked tree and resumes in pp mode;
at degree 1, ``tp`` is bit-equal to ``dp`` in one process.
"""

import importlib.util
import math
import os
import re

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from sp_cases import free_port
from torch_mp_worker import cli_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 2
FLAGS = ["--model", "gpt_tiny", "--batch_size", "4", "--seq_len", "32",
         "--corpus_tokens", "1500", "--epochs", "2", "--print_freq", "1",
         "--seed", "0", "--val_frac", "0.1"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")
SAMPLE = re.compile(r"^sample: (\[.*\])$", re.M)
MODES = {"pp_gpipe": ["--parallel", "pp", "--degree", "2"],
         "pp_1f1b": ["--parallel", "pp", "--degree", "2", "--pp_schedule",
                     "1f1b"],
         "tp": ["--parallel", "tp", "--degree", "2"],
         "tp_fsdp": ["--parallel", "tp", "--degree", "2", "--fsdp"]}


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


def _jax_cli(monkeypatch, n_devices=2):
    devices = jax.devices()[:n_devices]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    jax_get = jax_models.get_model
    monkeypatch.setattr(jax_models, "get_model", lambda name, **kw: jax_get(
        name, num_layers=LAYERS, **kw))
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_cli", os.path.join(REPO, "train_lm.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The JAX CLI's initial params (seed 0, two blocks)."""
    model = jax_models.get_model("gpt_tiny", num_layers=LAYERS,
                                 dtype=jnp.float32)
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1)).params)
    path = tmp_path_factory.mktemp("init") / "params.pt"
    torch.save(from_jax_params(params), path)
    return path


def _port(argv, params_path, world=2):
    mp.spawn(cli_rank, args=(world, free_port(), argv, str(params_path),
                             LAYERS), nprocs=world, join=True)
    save = argv[argv.index("--save_path") + 1]
    return [torch.load(os.path.join(save, f"summary.{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.mark.parametrize("mode", list(MODES))
def test_mp_cli_logs_and_sample_match_jax_cli(tmp_path, monkeypatch, capsys,
                                              params_path, mode):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli(monkeypatch)
    flags = FLAGS + MODES[mode] + ["--sample", "4"]
    cli.main(cli.parser.parse_args(flags + ["--save_path", str(jax_dir)]))
    jax_sample = SAMPLE.search(capsys.readouterr().out).group(1)
    port_dir.mkdir()
    ranks = _port(flags + ["--device", "cpu", "--save_path", str(port_dir)],
                  params_path)
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < 1e-4, (name, a, b)
            assert a[2] == pytest.approx(math.exp(a[1]), rel=1e-5)
    assert SAMPLE.search(ranks[0]["stdout"]).group(1) == jax_sample
    assert "sample:" not in ranks[1]["stdout"]
    for r, summary in enumerate(ranks):
        assert summary["grid"] == [1, 2] and summary["rank"] == r
        assert summary["parallel"] == mode.split("_")[0]
    # each rank holds its share: pp a stage, tp --fsdp a slice of all
    per_rank = [s["resident_bytes"]["params"] for s in ranks]
    dense = sum(t.numel() * 4 for t in torch.load(
        params_path, weights_only=True).values())
    assert all(b < dense for b in per_rank)
    for name in ("model_2.pth", "model_2.pth.sha256"):
        assert (port_dir / name).exists()


def test_pp_checkpoint_is_stacked_and_resumes(tmp_path, params_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    base = FLAGS + MODES["pp_1f1b"] + ["--device", "cpu"]
    for d in (straight, split):
        d.mkdir()
    _port(base + ["--save_path", str(straight)], params_path)
    one_epoch = list(base)
    one_epoch[one_epoch.index("--epochs") + 1] = "1"
    _port(one_epoch + ["--save_path", str(split)], params_path)
    payload = torch.load(split / "model_1.pth", weights_only=True)
    assert tuple(payload["params/embed"].shape) == (2, 129, 128)
    assert tuple(payload["params/blocks/attn/wqkv/kernel"].shape) == (
        2, 1, 128, 384)
    assert tuple(payload["opt_state/momentum/head_k"].shape) == (2, 128, 129)
    ranks = _port(base + ["--resume", "auto", "--save_path", str(split)],
                  params_path)
    assert "continuing at epoch 2" in ranks[0]["stdout"]
    ours, ref = _rows(split / "train.log"), _rows(straight / "train.log")
    assert len(ours) == 2
    assert sum(ours, []) == pytest.approx(sum(ref, []), rel=1e-6)


@pytest.mark.parametrize("extra", [
    ["--parallel", "sp", "--zero1"], ["--fsdp"], ["--zero1", "--zero"],
    ["--parallel", "tp", "--zero"], ["--parallel", "pp", "--zero",
                                     "--remat"],
    ["--parallel", "pp", "--remat", "--vocab_chunks", "4"],
    ["--parallel", "pp", "--pp_schedule", "1f1b", "--grad_accum", "2"],
    ["--parallel", "tp", "--grad_accum", "2"],
    ["--parallel", "tp", "--pp_schedule", "1f1b", "--remat"],
])
def test_mp_flag_checks_in_jax_order(tmp_path, monkeypatch, extra):
    """Each combination exits before the run with the JAX CLI's words
    (the first check JAX runs that it fails)."""
    cli = _jax_cli(monkeypatch)
    with pytest.raises(SystemExit) as theirs:
        cli.main(cli.parser.parse_args(FLAGS + extra + [
            "--save_path", str(tmp_path / "jax")]))
    with pytest.raises(SystemExit) as ours:
        train_lm.main(FLAGS + extra + ["--device", "cpu", "--save_path",
                                       str(tmp_path / "port")])
    assert str(ours.value) == str(theirs.value)
    assert not (tmp_path / "port" / "train.log").exists()


def _one(tmp_path, name, *extra):
    out = tmp_path / name
    return train_lm.main(["--model", "gpt_tiny", "--batch_size", "4",
                          "--seq_len", "32", "--corpus_tokens", "700",
                          "--epochs", "1", "--device", "cpu",
                          "--save_path", str(out), *extra]), out


def test_degree_one_runs_in_one_process(tmp_path):
    """pp and tp at degree 1 train in one process: tp (plain, --zero1,
    --fsdp) and --remat bit-equal to dp, sp --remat to sp; gpipe and
    1f1b within f32 rounding of dp (their final LayerNorm and
    vocab-parallel CE order their sums otherwise)."""
    dp, _ = _one(tmp_path, "dp")
    for extra in (["--parallel", "tp"], ["--parallel", "tp", "--zero1"],
                  ["--parallel", "tp", "--fsdp"], ["--remat"],
                  ["--parallel", "tp", "--remat"]):
        got, out = _one(tmp_path, "_".join(extra), *extra)
        assert got["epoch_losses"] == dp["epoch_losses"], extra
        assert (out / "model_1.pth").exists()
    sp, _ = _one(tmp_path, "sp", "--parallel", "sp")
    sp_remat, _ = _one(tmp_path, "sp_remat", "--parallel", "sp", "--remat")
    assert sp_remat["epoch_losses"] == sp["epoch_losses"]
    for sched in ("gpipe", "1f1b"):
        got, _ = _one(tmp_path, sched, "--parallel", "pp", "--pp_schedule",
                      sched)
        assert got["epoch_losses"] == pytest.approx(dp["epoch_losses"],
                                                    abs=1e-5)
        assert got["grid"] == [1, 1] and got["steps"] == dp["steps"]
