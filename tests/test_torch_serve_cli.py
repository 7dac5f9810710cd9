"""The port's ``serve_lm`` CLI against the JAX CLI and engine.

The port's CLI runs as its users run it (``python -m
pytorch_multiprocessing_distributed_tpu_torch.serve_lm``, here with
``--device cpu``); with ``--ckpt`` pointing at an ``.npz`` exported from
JAX ``init_params(gpt_tiny, 0)`` its ``req=src-i tokens=[...]`` lines
equal an in-process JAX engine's transcripts on the same prompts.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import serve_lm as jax_serve_lm
from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    Request as JaxRequest, ServingEngine as JaxEngine,
    init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch import (
    CudaUnavailableError, serve_lm)

REPO = Path(__file__).resolve().parents[1]
MODULE = "pytorch_multiprocessing_distributed_tpu_torch.serve_lm"


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", MODULE, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_random_init_completes(tmp_path):
    out = tmp_path / "m.json"
    proc = _run("--device", "cpu", "--model", "gpt_tiny", "--random_init",
                "--synthetic", "6", "--max_slots", "3", "--quiet",
                "--metrics_out", str(out))
    assert proc.returncode == 0, proc.stderr
    snap = json.loads(out.read_text())
    assert snap["requests_completed"] == 6 and snap["rejected"] == 0
    assert snap["tokens_generated"] == 6 * 32
    assert snap["device"] == "cpu"
    assert "req=" not in proc.stdout  # --quiet


def _flat(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            yield from _flat(val, path)
        else:
            yield path, np.asarray(val)


def test_cli_ckpt_transcripts_equal_jax_engine(tmp_path):
    jmodel = jax_models.get_model("gpt_tiny", attn_impl="xla")
    jparams = jax_init_params(jmodel, 0)
    ckpt = tmp_path / "gpt_tiny.npz"
    np.savez(ckpt, **dict(_flat(jparams)))
    proc = _run("--device", "cpu", "--model", "gpt_tiny", "--ckpt",
                str(ckpt), "--synthetic", "6", "--max_slots", "3",
                "--max_new_tokens", "8", "--decode_horizon", "4",
                "--seed", "3")
    assert proc.returncode == 0, proc.stderr
    got = dict(re.findall(r"^req=(src-\d+) tokens=(\[.*\])$", proc.stdout,
                          re.M))

    args = argparse.Namespace(requests="", stdin=False, synthetic=6,
                              seed=3, max_new_tokens=8)
    engine = JaxEngine(jmodel, jparams, max_slots=3)
    reqs = [JaxRequest(p, n, None, uid=f"src-{i}") for i, (p, n) in
            enumerate(jax_serve_lm._load_requests(args, 257, []))]
    for r in reqs:
        engine.enqueue(r)
    for _ in engine.run():
        pass
    want = {r.uid: str(r.tokens) for r in reqs}
    assert len(got) == 6 and got == want


@pytest.mark.parametrize("source", ["synthetic", "requests"])
def test_request_sources_match_jax_cli(tmp_path, source):
    path = tmp_path / "r.jsonl"
    path.write_text('{"prompt": [1, 2, 3]}\n\nnot json\n'
                    '{"text": "hi", "max_new_tokens": 4}\n{"x": 1}\n')
    args = argparse.Namespace(
        requests=str(path) if source == "requests" else "", stdin=False,
        synthetic=5, seed=11, max_new_tokens=7)
    skipped_port, skipped_jax = [], []
    port = list(serve_lm._load_requests(args, 61, skipped_port))
    ref = list(jax_serve_lm._load_requests(args, 61, skipped_jax))
    assert port == ref and skipped_port == skipped_jax


# --trace_out and --stats_port (cases 2 and 5) are ported:
# tests/test_torch_scope_cli.py runs them; so are --replicas and --role
# (cases 1 and 3, tests/test_torch_serve_fleet_cli.py): flags of the
# processes fleet take each place
@pytest.mark.parametrize("argv", [
    ["--rid", "r1"], ["--listen", "0"], ["--connect", "127.0.0.1:1"],
    ["--rollout", "seed:7"], ["--autoscale", "1,2"],
    ["--fleet_store", "127.0.0.1:1"]])
def test_unported_flags_rejected(argv):
    with pytest.raises(SystemExit, match="not ported"):
        serve_lm.main(["--device", "cpu", "--random_init", *argv])


def test_rejected_flag_exits_nonzero_from_the_shell():
    proc = _run("--device", "cpu", "--random_init", "--autoscale", "1,2")
    assert proc.returncode != 0 and "ROADMAP" in proc.stderr


def test_params_source_is_required():
    with pytest.raises(SystemExit, match="--random_init"):
        serve_lm.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="exclusive"):
        serve_lm.main(["--device", "cpu", "--random_init", "--ckpt", "x"])


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(CudaUnavailableError):
        serve_lm.main(["--random_init", "--synthetic", "1"])

