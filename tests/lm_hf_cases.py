"""Shared cases of ``tests/test_torch_lm_hf_cli*.py`` and
``test_torch_lm_beams_cli.py``: the port's ``train_lm --hf_init``,
``--hf_export`` and ``--sample_beams`` against the JAX CLI
(``train_lm.py``) on the CPU.

gpt_tiny cut to two blocks, f32, lr 0.01; where neither run imports a
file, the port starts from the JAX CLI's initial params (its GPT-2
configuration under ``--hf_export``: LayerNorm eps 1e-5, no head bias).
The port runs ``--parallel dp`` in the test's process and ``--parallel
pp --degree 2`` on two gloo ranks (``tests/torch_mp_worker.py:
cli_rank``), the JAX CLI the same flags on one and two of the
conftest's virtual devices. ``train.log`` rows agree within 1e-4, the
``--hf_export`` files' tensors within 1e-5 (both ran the same SGD
steps; pp's are JAX's unstacked tree), and the printed samples of
``--hf_init`` and ``--sample_beams`` runs are equal.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch import train_lm
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT, get_model
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params, init_params)
from pytorch_multiprocessing_distributed_tpu_torch.utils import gpt_interop

from sp_cases import free_port
from torch_mp_worker import cli_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 2
FLAGS = ["--model", "gpt_tiny", "--batch_size", "4", "--seq_len", "32",
         "--corpus_tokens", "1500", "--epochs", "1", "--print_freq", "1",
         "--seed", "0", "--lr", "0.01"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")
SAMPLE = re.compile(r"^sample: (\[.*\])$", re.M)
GPT2 = dict(ln_eps=1e-5, head_bias=False)


def rows(path):
    lines = path.read_text().splitlines()
    assert all(ROW.match(line) for line in lines), lines
    return [[float(x) for x in line.split()] for line in lines]


def jax_cli(monkeypatch, n_devices=1):
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


def jax_init(path, gpt2):
    """The JAX CLI's initial params (seed 0, two blocks; GPT-2's
    LayerNorm eps and no head bias where ``gpt2``), saved at ``path``
    under the port's names."""
    model = jax_models.get_model("gpt_tiny", num_layers=LAYERS,
                                 dtype=jnp.float32,
                                 **(GPT2 if gpt2 else {}))
    params = jax.device_get(jax_lm.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1)).params)
    torch.save(from_jax_params(params), path)
    return path


def hf_file(path, mlp_dim=512, seed=3):
    """A GPT-2 ``state_dict`` file of the two-block gpt_tiny geometry
    (another ``mlp_dim`` for a geometry that is not gpt_tiny's), from
    ``seed``'s random weights."""
    model = GPT(vocab_size=257, max_seq_len=256, hidden_size=128,
                num_layers=LAYERS, num_heads=4, mlp_dim=mlp_dim, **GPT2)
    gpt_interop.save_gpt2_checkpoint(str(path),
                                     init_params(model, seed, "cpu"))
    return str(path)


def cut_model(monkeypatch):
    """The port's CLI builds its models with ``LAYERS`` blocks."""
    monkeypatch.setattr(train_lm, "get_model", lambda name, **kw: get_model(
        name, num_layers=LAYERS, **kw))


def both(tmp_path, monkeypatch, capsys, extra, init_path, world=1):
    """The JAX CLI and the port on ``FLAGS + extra``: (JAX's stdout, the
    port's stdout and summary), after their train.log rows are held
    within 1e-4."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = jax_cli(monkeypatch, world)
    cli.main(cli.parser.parse_args(FLAGS + extra + [
        "--save_path", str(jax_dir)]))
    jax_out = capsys.readouterr().out
    argv = FLAGS + extra + ["--device", "cpu", "--save_path", str(port_dir)]
    if world == 1:
        cut_model(monkeypatch)
        if init_path is not None:  # None: --hf_init gives the params
            params = torch.load(init_path, weights_only=True)
            monkeypatch.setattr(
                train_lm, "init_params",
                lambda model, seed, device: {k: v.clone()
                                             for k, v in params.items()})
        summary = train_lm.main(argv)
        out = capsys.readouterr().out
    else:
        port_dir.mkdir()
        mp.spawn(cli_rank, args=(world, free_port(), argv, str(init_path),
                                 LAYERS), nprocs=world, join=True)
        summary = torch.load(port_dir / "summary.0.pt", weights_only=False)
        out = summary["stdout"]
    ours, ref = rows(port_dir / "train.log"), rows(jax_dir / "train.log")
    assert len(ours) == len(ref) == 1
    assert abs(ours[0][1] - ref[0][1]) < 1e-4, (ours, ref)
    return jax_out, out, summary


def same_sample(jax_out, out, summary):
    assert SAMPLE.search(out).group(1) == SAMPLE.search(jax_out).group(1)
    assert str(summary["sample"]) == SAMPLE.search(out).group(1)


def same_export(tmp_path, summary):
    """The port's ``--hf_export`` file against the JAX CLI's: JAX's keys
    in JAX's order, each tensor within 1e-5."""
    name = "model_1.hf.pth"
    assert summary["hf_export"] == str(tmp_path / "port" / name)
    ours = torch.load(tmp_path / "port" / name, weights_only=True)
    theirs = torch.load(tmp_path / "jax" / name, weights_only=True)
    assert list(ours) == list(theirs)
    for key, t in theirs.items():
        torch.testing.assert_close(ours[key], t, atol=1e-5, rtol=0,
                                   msg=key)
