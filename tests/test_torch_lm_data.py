"""The port's LM data, log rows and checkpoints against the JAX package's:
``synthetic_tokens`` and ``TokenLoader`` index-identical, the byte-level
text corpus identical, ``Logger`` rows byte-identical; and the port's
checkpoint contract (payload + sha256 sidecar, corruption caught, auto
resume, pruning)."""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.data import lm as jax_lm_data
from pytorch_multiprocessing_distributed_tpu.data import text as jax_text
from pytorch_multiprocessing_distributed_tpu.utils import Logger as JaxLogger
from pytorch_multiprocessing_distributed_tpu_torch.data import (
    TokenLoader, detokenize, load_text_corpus, sniff_bytes,
    synthetic_tokens, tokenize)
from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    init_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, make_lm_train_step, sgd)
from pytorch_multiprocessing_distributed_tpu_torch.train.checkpoint import (
    CheckpointCorruptError, checkpoint_path, digest_path, load_checkpoint,
    load_with_fallback, prune_checkpoints, resolve_auto_resume,
    save_checkpoint, verify_checkpoint)
from pytorch_multiprocessing_distributed_tpu_torch.utils import Logger


@pytest.mark.parametrize("n,vocab,seed", [(5000, 257, 0), (777, 61, 3)])
def test_synthetic_tokens_identical(n, vocab, seed):
    np.testing.assert_array_equal(
        synthetic_tokens(n, vocab_size=vocab, seed=seed),
        jax_lm_data.synthetic_tokens(n, vocab_size=vocab, seed=seed))


@pytest.mark.parametrize("kw", [dict(shuffle=True), dict(shuffle=False),
                                dict(drop_last=False, world_size=2)])
def test_token_loader_index_identical(kw):
    tokens = synthetic_tokens(3000, seed=1)
    ours = TokenLoader(tokens, batch_size=6, seq_len=32, seed=4, **kw)
    ref = jax_lm_data.TokenLoader(tokens, batch_size=6, seq_len=32, seed=4,
                                  **kw)
    assert len(ours) == len(ref)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_token_loader_errors_match():
    with pytest.raises(ValueError, match="fewer than one global batch"):
        TokenLoader(np.zeros(50, np.int32), batch_size=4, seq_len=16)
    with pytest.raises(ValueError, match="divide by world_size"):
        TokenLoader(np.zeros(500, np.int32), batch_size=3, seq_len=16,
                    world_size=2)


def test_logger_rows_byte_identical(tmp_path):
    rows = [[1, 4.661665123, 105.8121], [12, 0.5, float("inf")],
            [3, "tag", 7]]
    ours, ref = tmp_path / "ours.log", tmp_path / "ref.log"
    for row in rows:
        Logger(str(ours)).write(row)
        JaxLogger(str(ref)).write(row)
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_bytes().startswith(b"0001 4.661665 105.812100\n")
    assert Logger(str(ours)).read() == JaxLogger(str(ref)).read()
    assert len(Logger(str(tmp_path / "missing.log"))) == 0


def test_text_corpus_identical(tmp_path):
    (tmp_path / "a.txt").write_text("héllo\nworld")
    (tmp_path / "b.txt").write_bytes(b"\x00\xffbytes")
    np.testing.assert_array_equal(load_text_corpus(str(tmp_path)),
                                  jax_text.load_text_corpus(str(tmp_path)))
    ids = tokenize("naïve ☃")
    np.testing.assert_array_equal(ids, jax_text.tokenize("naïve ☃"))
    assert detokenize(ids) == "naïve ☃"
    assert detokenize([65, 256, -1]) == jax_text.detokenize([65, 256, -1])
    for head in (b"\x93NUMPY", b"PK\x03\x04", b"text"):
        assert sniff_bytes(head) == jax_text.sniff_bytes(head)
    np.save(tmp_path / "c.npy", np.arange(3))
    with pytest.raises(ValueError, match="numpy tooling output"):
        load_text_corpus(str(tmp_path))


def _trained_state(seed=0):
    model = get_model("gpt_tiny")
    state = create_lm_train_state(model, init_params(model, seed, "cpu"))
    step = make_lm_train_step(model, sgd(0.1))
    tokens = torch.from_numpy(synthetic_tokens(256, seed=seed)).view(8, 32)
    step(state, tokens)
    return state


def test_checkpoint_roundtrip_and_sidecar(tmp_path):
    state = _trained_state()
    state.epoch = 3
    path = save_checkpoint(str(tmp_path), state, 3)
    assert path == checkpoint_path(str(tmp_path), 3)
    assert verify_checkpoint(path)
    with open(digest_path(path)) as f:
        assert len(f.read().strip()) == 64
    fresh = create_lm_train_state(get_model("gpt_tiny"),
                                  init_params(get_model("gpt_tiny"), 9,
                                              "cpu"))
    load_checkpoint(path, fresh)
    assert fresh.epoch == 3 and int(fresh.count) == 1
    assert bool(fresh.initialized)
    assert torch.equal(fresh.params, state.params)
    assert torch.equal(fresh.momentum, state.momentum)


def test_corrupt_checkpoint_falls_back_and_prunes(tmp_path):
    state = _trained_state()
    for epoch in (1, 2, 3):
        state.epoch = epoch
        save_checkpoint(str(tmp_path), state, epoch)
    assert resolve_auto_resume(str(tmp_path)).endswith("model_3.pth")
    path3 = checkpoint_path(str(tmp_path), 3)
    data = bytearray(open(path3, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path3, "wb").write(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="corrupt"):
        load_checkpoint(path3, state)
    restored, used = load_with_fallback(str(tmp_path), state, anchor=3)
    assert used.endswith("model_2.pth") and restored.epoch == 2
    prune_checkpoints(str(tmp_path), 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_3.pth", "model_3.pth.sha256"]
    assert resolve_auto_resume(str(tmp_path / "none")) is None
