"""The port's ``train_lm --n_experts`` against the JAX CLI, its MoE flag
checks in the JAX CLI's order, and MoE checkpoints.

gpt_tiny cut to two blocks with 4 experts (top-1, and top-2 under pp),
started from the JAX CLI's initial params; the port runs ``--parallel
dp`` in this process and ``--parallel pp --degree 2`` on two gloo ranks
(``tests/torch_mp_worker.py:cli_rank``), the JAX CLI the same flags on
one and two of the conftest's virtual devices. ``train.log`` and
``test.log`` rows agree within 1e-4, every printed ``Aux`` value within
1e-4 of JAX's (printed to 3 decimals: within 5e-4 + 1e-4 of the
printed figure), and ``--sample`` prints JAX's greedy tokens, decoded
droplessly. A dp checkpoint holds the MoE leaves under JAX's names and
shapes, a pp checkpoint JAX's stacked tree of them, and both resume to
the straight run.

At lr 0.01: at the CLI's default 0.1 this run diverges (its loss climbs
from 5.6 to 8.7 by step 9 in both CLIs) and its routing turns chaotic,
so the two frameworks' f32 sums, which agree on every printed balance
loss for 17 steps, part when a token near a routing tie flips expert
(step 18): a property of the discontinuous router, not of either
framework.
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
from pytorch_multiprocessing_distributed_tpu.parallel import gpt_pipeline as jgp
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from sp_cases import free_port
from torch_mp_worker import cli_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 2
FLAGS = ["--model", "gpt_tiny", "--batch_size", "4", "--seq_len", "32",
         "--corpus_tokens", "1500", "--epochs", "2", "--print_freq", "1",
         "--seed", "0", "--val_frac", "0.1", "--lr", "0.01",
         "--n_experts", "4"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")
AUX = re.compile(r"^Epoch: \[\d+\]\[\d+/\d+\]\tLoss \S+\tTok/s \d+\tAux "
                 r"(\d+\.\d{3})$", re.M)
SAMPLE = re.compile(r"^sample: (\[.*\])$", re.M)
MODES = {"dp": [], "pp_1f1b_top2": ["--parallel", "pp", "--degree", "2",
                                    "--pp_schedule", "1f1b",
                                    "--moe_top_k", "2"]}


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


def _jax_cli(monkeypatch, n_devices):
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


def _jax_params(top_k=1):
    model = jax_models.get_model("gpt_tiny", num_layers=LAYERS,
                                 dtype=jnp.float32, n_experts=4,
                                 moe_top_k=top_k)
    return jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1)).params)


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The JAX CLI's initial params (seed 0, two MoE blocks)."""
    path = tmp_path_factory.mktemp("init") / "params.pt"
    torch.save(from_jax_params(_jax_params()), path)
    return path


def _port_in_process(monkeypatch, argv, params_path):
    params = torch.load(params_path, weights_only=True)
    monkeypatch.setattr(train_lm, "get_model", lambda name, **kw: get_model(
        name, num_layers=LAYERS, **kw))
    monkeypatch.setattr(train_lm, "init_params", lambda model, seed, device: {
        k: v.clone() for k, v in params.items()})
    return train_lm.main(argv)


def _port_ranks(argv, params_path, world=2):
    mp.spawn(cli_rank, args=(world, free_port(), argv, str(params_path),
                             LAYERS), nprocs=world, join=True)
    save = argv[argv.index("--save_path") + 1]
    return [torch.load(os.path.join(save, f"summary.{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_cli_rows_aux_and_sample_match_jax_cli(tmp_path, monkeypatch,
                                                   capsys, params_path,
                                                   mode):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    world = 1 if mode == "dp" else 2
    cli = _jax_cli(monkeypatch, world)
    flags = FLAGS + MODES[mode] + ["--sample", "4"]
    cli.main(cli.parser.parse_args(flags + ["--save_path", str(jax_dir)]))
    jax_out = capsys.readouterr().out
    port_dir.mkdir()
    argv = flags + ["--device", "cpu", "--save_path", str(port_dir)]
    if mode == "dp":
        summary = _port_in_process(monkeypatch, argv, params_path)
        out = capsys.readouterr().out
    else:
        ranks = _port_ranks(argv, params_path)
        summary, out = ranks[0], ranks[0]["stdout"]
        assert "Aux" not in ranks[1]["stdout"]
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < 1e-4, (name, a, b)
            assert a[2] == pytest.approx(math.exp(a[1]), rel=1e-5)
    jax_aux = [float(v) for v in AUX.findall(jax_out)]
    assert len(jax_aux) == len(summary["moe_aux"]) == summary["steps"] > 0
    assert AUX.findall(out) == [f"{v:.3f}" for v in summary["moe_aux"]]
    for ours, ref in zip(summary["moe_aux"], jax_aux):
        assert abs(ours - ref) <= 5e-4 + 1e-4, (ours, ref)
    assert SAMPLE.search(out).group(1) == SAMPLE.search(jax_out).group(1)


@pytest.mark.parametrize("extra", [
    ["--moe_top_k", "2"], ["--moe_top_k", "2", "--hf_export"],
    ["--n_experts", "2", "--hf_init", "x.pth"],
    ["--n_experts", "2", "--hf_export", "--sample_beams", "2"],
])
def test_moe_flag_checks_in_jax_order(tmp_path, monkeypatch, extra):
    """Each combination exits before the run with the JAX CLI's words."""
    cli = _jax_cli(monkeypatch, 1)
    base = FLAGS[:FLAGS.index("--n_experts")]
    with pytest.raises(SystemExit) as theirs:
        cli.main(cli.parser.parse_args(base + extra + [
            "--save_path", str(tmp_path / "jax")]))
    with pytest.raises(SystemExit) as ours:
        train_lm.main(base + extra + ["--device", "cpu", "--save_path",
                                      str(tmp_path / "port")])
    assert str(ours.value) == str(theirs.value)
    assert not (tmp_path / "port").exists()


def test_dense_hf_flags_are_still_rejected_by_name(tmp_path):
    """The name is from before ``--hf_init`` was ported: a dense run
    started from a GPT-2 file now trains (only an MoE one is refused,
    as in JAX), its first loss that of the file's weights."""
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)
    from pytorch_multiprocessing_distributed_tpu_torch.utils import (
        gpt_interop)

    model = get_model("gpt_tiny", num_layers=LAYERS, ln_eps=1e-5,
                      head_bias=False)
    path = str(tmp_path / "dense.hf.pth")
    gpt_interop.save_gpt2_checkpoint(path, init_params(model, 3, "cpu"))
    base = FLAGS[:FLAGS.index("--n_experts")]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(train_lm, "get_model", lambda name, **kw: get_model(
            name, num_layers=LAYERS, **kw))
        summary = train_lm.main(base + ["--hf_init", path, "--epochs", "1",
                                        "--device", "cpu", "--save_path",
                                        str(tmp_path / "run")])
    assert summary["steps"] > 0 and math.isfinite(summary["first_loss"])
    assert (tmp_path / "run" / "model_1.pth").exists()


def test_moe_dp_checkpoint_holds_jax_leaves_and_resumes(tmp_path,
                                                        monkeypatch,
                                                        params_path):
    base = FLAGS + ["--device", "cpu"]
    straight = _port_in_process(monkeypatch, base + [
        "--save_path", str(tmp_path / "straight")], params_path)
    one = list(base)
    one[one.index("--epochs") + 1] = "1"
    _port_in_process(monkeypatch, one + ["--save_path",
                                         str(tmp_path / "split")],
                     params_path)
    payload = torch.load(tmp_path / "split" / "model_1.pth",
                         weights_only=True)
    want = from_jax_params(_jax_params())
    for name, t in want.items():
        if ".moe." in name:
            key = name.replace(".", "/")
            assert tuple(payload[f"params/{key}"].shape) == tuple(t.shape)
            assert tuple(payload[f"opt_state/momentum/{key}"].shape) == \
                tuple(t.shape)
    assert "params/block_1/moe/w2" in payload
    resumed = _port_in_process(monkeypatch, base + [
        "--resume", "auto", "--save_path", str(tmp_path / "split")],
        params_path)
    assert resumed["epoch_losses"] == pytest.approx(
        straight["epoch_losses"][1:], rel=1e-6)


def test_moe_pp_checkpoint_is_jax_stacked_tree(tmp_path, monkeypatch,
                                               params_path):
    """A pipelined MoE run at degree 1 in this process: its checkpoint's
    MoE leaves are JAX's stacked tree (``stack_pipeline_params``'s
    names and shapes), and it resumes to the straight run."""
    base = FLAGS + ["--device", "cpu", "--parallel", "pp"]
    straight = _port_in_process(monkeypatch, base + [
        "--save_path", str(tmp_path / "straight")], params_path)
    one = list(base)
    one[one.index("--epochs") + 1] = "1"
    _port_in_process(monkeypatch, one + ["--save_path",
                                         str(tmp_path / "split")],
                     params_path)
    payload = torch.load(tmp_path / "split" / "model_1.pth",
                         weights_only=True)
    stacked = jax.eval_shape(lambda p: jgp.stack_pipeline_params(p, 1),
                             _jax_params())
    for leaf in ("gate", "w1", "b1", "w2", "b2"):
        assert tuple(payload[f"params/blocks/moe/{leaf}"].shape) == tuple(
            stacked["blocks"]["moe"][leaf].shape), leaf
    resumed = _port_in_process(monkeypatch, base + [
        "--resume", "auto", "--save_path", str(tmp_path / "split")],
        params_path)
    assert resumed["epoch_losses"] == pytest.approx(
        straight["epoch_losses"][1:], rel=1e-6)
