"""Serving the port's own training checkpoints: ``load_params(model,
path, backend, epoch)`` (the JAX package's signature) and ``serve_lm
--ckpt`` on what the port's ``train_lm`` writes on the CPU: the
msgpack-named ``model_<epoch>.pth`` (its sidecar checked), the orbax
tree (the latest epoch, or ``--ckpt_epoch``), and a pipelined run's
stacked tree, unstacked as JAX's ``unstack_pipeline_params`` does. Each
transcript equals an engine's on the same params bound in memory.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.parallel.gpt_pipeline import (
    unstack_pipeline_params as jax_unstack)
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm, train_lm
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, from_jax_params, load_params)
from pytorch_multiprocessing_distributed_tpu_torch.train.checkpoint import (
    CheckpointCorruptError)
from pytorch_multiprocessing_distributed_tpu_torch.train.orbax_ckpt import (
    OrbaxCheckpointer)

from cli_procs import run_cli

LM = ["--device", "cpu", "--model", "gpt_tiny", "--batch_size", "8",
      "--seq_len", "32", "--corpus_tokens", "6000", "--lr", "0.01",
      "--seed", "0"]
SERVE = ["--device", "cpu", "--model", "gpt_tiny", "--synthetic", "4",
         "--max_slots", "2", "--decode_horizon", "4", "--max_new_tokens",
         "8"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three train_lm runs: msgpack (2 epochs), orbax (2 epochs, each
    saved) and pp on two gloo ranks (1 epoch, in subprocesses)."""
    root = tmp_path_factory.mktemp("ckpt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_lm.main(LM + ["--epochs", "2", "--save_path",
                            str(root / "msgpack")])
        train_lm.main(LM + ["--epochs", "2", "--save_every", "1",
                            "--ckpt_backend", "orbax", "--save_path",
                            str(root / "orbax")])
    finally:
        torch.set_num_threads(threads)
    run_cli("train_lm", LM + ["--epochs", "1", "--parallel", "pp",
                              "--degree", "2", "--save_path",
                              str(root / "pp")], ranks=2)
    return root


def _model():
    return get_model("gpt_tiny")


def _payload_params(payload):
    return {k[len("params/"):].replace("/", "."): v.float()
            for k, v in payload.items() if k.startswith("params/")}


def _nested(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (numpy leaves)."""
    out = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.numpy()
    return out


def _jax_unstacked(path):
    """The pp checkpoint's stacked tree unstacked by JAX's function."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    tree = _nested({k[len("params/"):]: v for k, v in payload.items()
                    if k.startswith("params/")})
    return from_jax_params(jax_unstack(tree, _model().vocab_size))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        torch.testing.assert_close(a[name], b[name], atol=0, rtol=0)


def test_msgpack_params_are_the_payload(runs):
    path = str(runs / "msgpack" / "model_2.pth")
    want = _payload_params(torch.load(path, map_location="cpu",
                                      weights_only=True))
    _equal(load_params(_model(), path), want)
    _equal(load_params(_model(), path, "msgpack"), want)
    _equal(load_params(_model(), path, "auto"), want)


def test_orbax_latest_and_pinned_epoch(runs):
    ckpt = OrbaxCheckpointer(str(runs / "orbax"))
    assert ckpt.committed_epochs() == [1, 2]
    for path in (str(runs / "orbax"), str(runs / "orbax" / "orbax")):
        _equal(load_params(_model(), path),
               _payload_params(ckpt.load_payload(2)))
        _equal(load_params(_model(), path, "orbax", epoch=1),
               _payload_params(ckpt.load_payload(1)))
    one, two = (load_params(_model(), str(runs / "orbax"), epoch=e)
                for e in (1, 2))
    assert not torch.equal(one["embed"], two["embed"])  # trained on


def test_pp_stacked_tree_unstacked_as_jax(runs):
    path = str(runs / "pp" / "model_1.pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["params/embed"].dim() == 3  # JAX's stacked layout
    _equal(load_params(_model(), path), _jax_unstacked(path))


def test_flipped_byte_raises_named(runs, tmp_path):
    src = runs / "msgpack" / "model_2.pth"
    path = tmp_path / "model_2.pth"
    shutil.copy(src, path)
    shutil.copy(str(src) + ".sha256", str(path) + ".sha256")
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x40
    path.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        load_params(_model(), str(path))


def test_npz_keeps_loading(runs, tmp_path):
    params = load_params(_model(), str(runs / "msgpack" / "model_2.pth"))
    path = tmp_path / "p.npz"
    np.savez(path, **{k.replace(".", "/"): v.numpy()
                      for k, v in params.items()})
    _equal(load_params(_model(), str(path)), params)


def test_load_params_refusals(runs, tmp_path):
    path = str(runs / "msgpack" / "model_2.pth")
    with pytest.raises(ValueError, match="epoch"):
        load_params(_model(), path, epoch=1)
    with pytest.raises(ValueError, match="backend"):
        load_params(_model(), path, "flax")
    other = GPT(vocab_size=61, max_seq_len=64, hidden_size=32,
                num_layers=2, num_heads=2, mlp_dim=64)
    with pytest.raises(ValueError, match="does not hold"):
        load_params(other, path)
    with pytest.raises(FileNotFoundError, match="no orbax"):
        load_params(_model(), str(tmp_path), "orbax")


CASES = {
    "msgpack": (["msgpack", "model_2.pth"], []),
    "msgpack_named": (["msgpack", "model_2.pth"],
                      ["--ckpt_backend", "msgpack"]),
    "orbax_latest": (["orbax"], []),
    "orbax_epoch1": (["orbax"], ["--ckpt_epoch", "1"]),
    "pp": (["pp", "model_1.pth"], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_lm_ckpt_matches_params_in_memory(runs, capsys, case):
    parts, flags = CASES[case]
    path = str(runs.joinpath(*parts))
    serve_lm.main(SERVE + ["--ckpt", path] + flags)
    got = dict(re.findall(r"^req=(\S+) tokens=(\[.*\])$",
                          capsys.readouterr().out, re.M))
    if case == "pp":
        params = _jax_unstacked(path)
    elif case.startswith("orbax"):
        epoch = 1 if case == "orbax_epoch1" else 2
        params = _payload_params(
            OrbaxCheckpointer(path).load_payload(epoch))
    else:
        params = _payload_params(torch.load(path, map_location="cpu",
                                            weights_only=True))
    model = _model()
    model.load_state_dict(params, assign=True)
    args = serve_lm.build_parser().parse_args(SERVE + ["--random_init"])
    requests = list(serve_lm._load_requests(args, model.vocab_size, []))
    want = {f"src-{i}": str(r.tokens) for i, r in enumerate(
        ServingEngine(model, max_slots=2, decode_horizon=4).serve(
            requests))}
    assert got == want and len(got) == 4


def test_ckpt_flags_are_ported():
    args = serve_lm.build_parser().parse_args(
        ["--ckpt", "x", "--ckpt_backend", "orbax", "--ckpt_epoch", "3"])
    assert (args.ckpt_backend, args.ckpt_epoch) == ("orbax", 3)
    serve_lm._reject_not_ported(["--ckpt_backend", "orbax",
                                 "--ckpt_epoch=1"])
    assert os.path.basename(serve_lm.__file__) == "serve_lm.py"
