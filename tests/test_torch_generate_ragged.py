"""The port's ragged ``generate`` (``prompt_lengths``: left-padded rows)
against the JAX package's, in f32 on the CPU.

The same numpy weights (carried across by ``from_jax_params``) and the
same left-padded prompts go through both: the tokens are equal, and each
ragged row equals the port's one-row call on its unpadded prompt, for a
dense and an MoE model, and under ``mesh=`` on 2 gloo ranks. The ragged
prefill's activations and caches match JAX's ``_prefill`` within 1e-5.
The checks speak JAX's words. The plain ``torch_decode_attention`` with
``starts`` is held against a masked float64 softmax in numpy, and
``decode_split_ranges`` with a start against the columns it must cover.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference import (
    generate as jax_generate)
from pytorch_multiprocessing_distributed_tpu.inference.generate import (
    _prefill as jax_prefill)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.inference.generate import (
    _prefill)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

from serving_tp_cases import _tree
from sp_cases import free_port
from torch_serving_tp_worker import serve_rank

# the module (the package's ``decode_attention`` name is the function)
da = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
MOE = dict(GEOM, n_experts=2, moe_top_k=2, moe_capacity_factor=2.0)
LENGTHS = [5, 9, 12, 1]
NEW = 6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(geometry, seed=1):
    tree = _tree(geometry, seed)
    model = GPT(**geometry)
    model.load_state_dict(from_jax_params(tree), assign=True)
    return jax_models.GPT(attn_impl="xla", **geometry), tree, model


@pytest.fixture(scope="module")
def dense():
    return _pair(GEOM)


def _prompts(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GEOM["vocab_size"], (n,)) for n in LENGTHS]


def _padded(prompts, pad_id):
    t = max(len(p) for p in prompts)
    return np.stack([np.concatenate([np.full(t - len(p), pad_id), p])
                     for p in prompts])


def _jax_ragged(jmodel, tree, padded, lengths):
    return np.asarray(jax_generate(
        jmodel, tree, jnp.asarray(padded), max_new_tokens=NEW,
        prompt_lengths=jnp.asarray(lengths))).tolist()


def test_ragged_generate_matches_jax_and_one_row_calls(dense):
    """Token-exact with JAX on two pad ids; every row's tail equals the
    one-row call on its unpadded prompt (length 1 included)."""
    jmodel, tree, model = dense
    prompts = _prompts()
    tails = []
    for pad_id in (0, 7):
        padded = _padded(prompts, pad_id)
        ours = generate(model, torch.from_numpy(padded), max_new_tokens=NEW,
                        prompt_lengths=torch.tensor(LENGTHS)).tolist()
        assert ours == _jax_ragged(jmodel, tree, padded, LENGTHS)
        tails.append([row[-NEW:] for row in ours])
    assert tails[0] == tails[1]
    for i, p in enumerate(prompts):
        one = generate(model, torch.from_numpy(p[None]), max_new_tokens=NEW)
        assert tails[0][i] == one[0, -NEW:].tolist(), f"row {i}"


def test_ragged_prefill_matches_jax(dense):
    """The ragged prefill (pad columns masked, a pad query attending
    itself, positions re-based) against JAX's: activations and caches
    within 1e-5."""
    jmodel, tree, model = dense
    padded = _padded(_prompts(), 3)
    t = padded.shape[1]
    s_max = t + NEW
    offsets = t - np.asarray(LENGTHS, np.int32)
    kv_valid = jnp.arange(s_max)[None, :] >= jnp.asarray(offsets)[:, None]
    jx, jk, jv = jax_prefill(jmodel, tree, jnp.asarray(padded), s_max,
                             offsets=jnp.asarray(offsets), kv_valid=kv_valid)
    x, k, v = _prefill(model, torch.from_numpy(padded), s_max,
                       torch.from_numpy(offsets))
    for got, ref in ((x, jx), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_ragged_moe_generate_matches_jax():
    """A top-2 MoE model decodes a ragged batch droplessly, as JAX's."""
    jmodel, tree, model = _pair(MOE, seed=3)
    prompts = _prompts(seed=4)
    padded = _padded(prompts, 0)
    ours = generate(model, torch.from_numpy(padded), max_new_tokens=NEW,
                    prompt_lengths=torch.tensor(LENGTHS)).tolist()
    assert ours == _jax_ragged(jmodel, tree, padded, LENGTHS)
    for i, p in enumerate(prompts):
        one = generate(model, torch.from_numpy(p[None]), max_new_tokens=NEW)
        assert ours[i][-NEW:] == one[0, -NEW:].tolist(), f"row {i}"


def test_ragged_checks_speak_jax_words(dense):
    jmodel, tree, model = dense
    padded = _padded(_prompts(), 0)
    with pytest.raises(ValueError) as theirs:
        jax_generate(jmodel, tree, jnp.asarray(padded), max_new_tokens=2,
                     prompt_lengths=jnp.asarray(LENGTHS[:2]))
    with pytest.raises(ValueError) as ours:
        generate(model, torch.from_numpy(padded), max_new_tokens=2,
                 prompt_lengths=torch.tensor(LENGTHS[:2]))
    assert str(ours.value) == str(theirs.value)
    assert "prompt_lengths must have shape (4,)" in str(ours.value)
    sp_jax = jax_models.GPT(attn_impl="xla", seq_axis="seq", **GEOM)
    with pytest.raises(NotImplementedError) as theirs:
        jax_generate(sp_jax, tree, jnp.asarray(padded), max_new_tokens=2)
    with pytest.raises(NotImplementedError) as ours:
        generate(model.clone(seq_axis="seq"), torch.from_numpy(padded),
                 max_new_tokens=2)
    assert str(ours.value) == str(theirs.value)


def test_ragged_generate_under_mesh_matches_jax(dense, tmp_path):
    """``generate(mesh=grid, prompt_lengths=...)`` on 2 gloo ranks: each
    rank's kernel takes the same starts, and the tokens are JAX's."""
    jmodel, tree, _ = dense
    padded = _padded(_prompts(), 5)
    inputs = {"geometry": GEOM, "params": from_jax_params(tree),
              "engine": {}, "generate": {"ragged": dict(
                  prompt=torch.from_numpy(padded),
                  kw=dict(max_new_tokens=NEW,
                          prompt_lengths=torch.tensor(LENGTHS)))}}
    path, out = tmp_path / "inputs.pt", tmp_path / "out"
    torch.save(inputs, path)
    mp.spawn(serve_rank, args=(2, free_port(), str(path), str(out)),
             nprocs=2, join=True)
    want = _jax_ragged(jmodel, tree, padded, LENGTHS)
    for r in range(2):
        got = torch.load(f"{out}.{r}", weights_only=False)
        assert got["ragged"]["tokens"] == want, f"rank {r}"


def test_plain_decode_with_starts_matches_masked_f64():
    """``torch_decode_attention(..., starts)`` on f64 inputs: the masked
    softmax over ``[starts[b], min(positions[b], W - 1)]`` in numpy."""
    rng = np.random.default_rng(0)
    b, w, h, d = 5, 40, 3, 8
    q = rng.standard_normal((b, 1, h, d))
    k = rng.standard_normal((b, w, h, d))
    v = rng.standard_normal((b, w, h, d))
    pos = np.array([0, 39, 45, 20, 7], np.int32)
    starts = np.array([0, 12, 39, 20, 3], np.int32)
    got = da.torch_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(starts)).numpy()
    want = np.zeros_like(got)
    for i in range(b):
        cols = np.arange(starts[i], min(pos[i], w - 1) + 1)
        logits = np.einsum("hd,khd->hk", q[i, 0], k[i, cols]) * d ** -0.5
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want[i, 0] = np.einsum("hk,khd->hd", p, v[i, cols])
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("window", [40, 300, 1024])
def test_decode_split_ranges_with_a_start(window):
    """The kernel's walk with a first valid column: every column of
    ``[start, reach]`` in exactly one range, each range inside its
    split; the live splits run from the start's to the reach's, and
    start 0 is the walk without one."""
    for split in (64, 128, 256):
        plan = da.decode_split_plan(8, 12, window, 64, split=split)
        for pos in (0, 63, 64, 129, window - 1, window + 3):
            reach = min(pos, window - 1)
            for start in sorted({0, 1, split - 1, split, split + 1,
                                 reach // 2, reach}):
                if start > reach:
                    continue
                ranges = da.decode_split_ranges(plan, pos, window, start)
                walked = [c for lo, hi in ranges for c in range(lo, hi)]
                assert walked == list(range(start, reach + 1))
                assert [lo // split for lo, _ in ranges] == list(
                    range(start // split, reach // split + 1))
                for lo, hi in ranges:
                    assert lo < hi <= (lo // split + 1) * split
            assert (da.decode_split_ranges(plan, pos, window, 0)
                    == da.decode_split_ranges(plan, pos, window))


def test_starts_checks():
    q = torch.zeros(2, 1, 2, 8)
    k = v = torch.zeros(2, 6, 2, 8)
    pos = torch.tensor([1, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="starts must be int32"):
        da.decode_attention(q, k, v, pos, starts=torch.tensor([0, 1]))
    quant = da.QuantizedKV(torch.zeros(2, 6, 2, 8, dtype=torch.int8),
                           torch.ones(2, 6, 2))
    with pytest.raises(ValueError, match="not int8"):
        da.decode_attention(q, quant, quant, pos,
                            starts=torch.zeros(2, dtype=torch.int32))
