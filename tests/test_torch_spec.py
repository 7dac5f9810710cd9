"""Units of the port's speculative decode against the JAX package's.

The host and device draft-table hashes, the n-gram drafter, the draft
length and horizon pickers, the collapsed-k re-probe, the spare cache
columns, and the engine's, the decode body's and the CLI's validation
messages. Everything here is exact: integer and host bookkeeping.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference.generate import (
    draft_bucket as jax_draft_bucket)
from pytorch_multiprocessing_distributed_tpu.serving import (
    NgramDrafter as JaxDrafter, init_params as jax_init_params,
    ngram_bucket as jax_ngram_bucket, pick_draft_k as jax_pick_draft_k,
    pick_horizon as jax_pick_horizon)
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
from pytorch_multiprocessing_distributed_tpu_torch.inference.generate import (
    _decode_horizon, draft_bucket)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    NgramDrafter, ServingEngine, SlotPool, from_jax_params, init_params,
    ngram_bucket, pick_draft_k, pick_horizon)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    m = GPT(**GEOM)
    m.load_state_dict(from_jax_params(jax_init_params(jmodel, 1)),
                      assign=True)
    return m


def _ids():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.asarray([0, 1, 7, 60, 255, 50000, 2 ** 31 - 1, 2 ** 31 - 2,
                    1 << 30], np.int64),
        rng.integers(0, 2 ** 31, 4000)]).astype(np.int32)


@pytest.mark.parametrize("n_buckets", [1, 16, 61, 64, 1000])
def test_hashes_bit_equal_to_jax(n_buckets):
    """ngram_bucket (numpy) and draft_bucket (torch, int64 masked to 32
    bits) equal the JAX formulas over ids up to 2^31 - 1."""
    ids = _ids()
    want = np.asarray(jax_draft_bucket(jnp.asarray(ids), n_buckets))
    assert np.array_equal(jax_ngram_bucket(ids, n_buckets), want)
    assert np.array_equal(ngram_bucket(ids, n_buckets), want)
    got = draft_bucket(torch.from_numpy(ids), n_buckets)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _histories():
    rng = np.random.default_rng(1)
    return [
        [],
        [5],
        [5, 9, 5, 7, 2],
        rng.integers(0, 61, 40).tolist(),
        rng.integers(0, 2 ** 31, 300).tolist(),
        ([7, 19, 3, 42, 11, 58, 23, 5] * 40)[:301],  # a loop
        [3, 9] + [1, 2] * 6,
    ]


@pytest.mark.parametrize("k, n_buckets, scan_window",
                         [(3, 16, None), (4, 64, None), (2, 16, 4),
                          (4, 8, 40), (1, 61, 7)])
def test_drafter_rows_bit_equal_to_jax(k, n_buckets, scan_window):
    """build_row and note_history give the JAX drafter's table on random
    and looping histories, the scan_window bound included."""
    port = NgramDrafter(3, k, n_buckets, scan_window=scan_window)
    ref = JaxDrafter(3, k, n_buckets, scan_window=scan_window)
    for i, hist in enumerate(_histories()):
        assert np.array_equal(port.build_row(hist), ref.build_row(hist))
        port.note_history(i % 3, hist)
        ref.note_history(i % 3, hist)
        assert np.array_equal(port._table, ref._table)
    assert np.array_equal(port.device_table().numpy(),
                          np.asarray(ref.device_table()))


def test_drafter_uploads_lazily_into_fresh_tensors():
    """An unchanged index keeps the device copy; a change uploads a new
    tensor (the old one, which a queued horizon may still read, keeps
    its values)."""
    drafter = NgramDrafter(2, 3, n_buckets=16)
    hist = [5, 9, 5, 7, 2]
    b5 = int(ngram_bucket([5], 16)[0])
    drafter.note_history(0, hist)
    t1 = drafter.device_table()
    assert t1[0, b5].tolist() == [7, 2, -1]
    ups = drafter.uploads
    drafter.note_history(0, hist)
    assert drafter.device_table() is t1 and drafter.uploads == ups
    drafter.note_history(0, [5, 1, 2, 3])
    assert drafter.uploads == ups  # dirty, the upload waits for a use
    t2 = drafter.device_table()
    assert t2 is not t1 and drafter.uploads == ups + 1
    assert t1[0, b5].tolist() == [7, 2, -1]
    assert t2[0, b5].tolist() == [1, 2, 3]
    with pytest.raises(ValueError, match="draft_k"):
        NgramDrafter(2, 0)


def test_pickers_equal_jax_over_a_grid():
    for k_max in (0, 1, 4):
        for ema in (None, 0.0, 0.1, 0.125, 0.5, 1.0):
            for cool in (False, True):
                for probe in (False, True):
                    assert (pick_draft_k(k_max, ema, cool, probe)
                            == jax_pick_draft_k(k_max, ema, cool, probe))
    for h_max in (1, 2, 4):
        for window in (8, 16, 64):
            for max_pos in (-1, 0, 7, 40, 63):
                for rem in (0, 1, 4, 100):
                    for pend in (False, True):
                        for per in (1, 3, 5):
                            assert (pick_horizon(h_max, window, max_pos,
                                                 rem, pend, per)
                                    == jax_pick_horizon(h_max, window,
                                                        max_pos, rem, pend,
                                                        per_step=per))


def test_probe_rearms_collapsed_spec(model):
    """tests/test_graftspec.py's regression: after low acceptance
    collapses the draft length, the probe counter still advances on the
    collapsed picks, so k re-arms every 16 dispatches."""
    engine = ServingEngine(model, max_slots=1, s_max=32, draft_k=4)
    engine._accept_ema = 0.0
    picks = [engine._pick_k() for _ in range(33)]
    assert picks == [4 if i % 16 == 0 else 0 for i in range(33)]
    assert engine.draft_k == 4 and engine.spec_accept_ema == 0.0


def test_dense_pool_carries_spare_columns(model):
    """Armed speculation gives the dense caches draft_k spare columns
    past s_max (counted in kv_bytes); disarmed, none."""
    armed = ServingEngine(model, max_slots=2, s_max=32, draft_k=4).pool
    assert armed.k_caches.shape[2] == 36 and armed.s_max == 32
    assert armed.kv_bytes == 2 * SlotPool.per_slot_kv_bytes(model, 36)
    plain = ServingEngine(model, max_slots=2, s_max=32).pool
    assert plain.k_caches.shape[2] == 32 and plain.spare_cols == 0
    int8 = ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                         kv_dtype="int8").pool
    assert int8.k_caches.scale.shape[2] == 34


def test_engine_validation_messages(model):
    """The JAX engine's checks and messages."""
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                      temperature=0.5, generator=gen)
    with pytest.raises(ValueError, match="BOTH draft_model"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                      draft_model=model)
    with pytest.raises(ValueError, match="draft_k > 0"):
        ServingEngine(model, max_slots=2, s_max=32, draft_model=model,
                      draft_params={})
    with pytest.raises(ValueError, match="draft_k must be >= 0"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=-1)
    with pytest.raises(ValueError, match="draft_buckets"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                      draft_buckets=0)
    bad = GPT(**dict(GEOM, vocab_size=17))
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                      draft_model=bad, draft_params={})
    short = GPT(**dict(GEOM, max_seq_len=16))
    with pytest.raises(ValueError, match="max_seq_len 16 < s_max=32"):
        ServingEngine(model, max_slots=2, s_max=32, draft_k=2,
                      draft_model=short, draft_params={})


def test_decode_body_validation(model):
    """_decode_horizon's guards: greedy-only, exactly one draft
    source."""
    n = 2
    caches = torch.zeros(2, n, 36, 2, 16)
    state = (torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32),
             torch.ones(n, dtype=torch.bool),
             torch.full((n,), 4, dtype=torch.int32),
             torch.full((n,), -1, dtype=torch.int32))
    table = torch.full((n, 8, 2), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="greedy-only"):
        _decode_horizon(model, caches, caches.clone(), *state, 1,
                        draft_k=2, draft_table=table, temperature=0.5,
                        generator=torch.Generator())
    with pytest.raises(ValueError, match="exactly one draft source"):
        _decode_horizon(model, caches, caches.clone(), *state, 1,
                        draft_k=2)
    with pytest.raises(ValueError, match="exactly one draft source"):
        _decode_horizon(model, caches, caches.clone(), *state, 1,
                        draft_k=2, draft_table=table, draft_model=model)


@pytest.mark.parametrize("argv, message", [
    (["--draft_k", "2", "--temperature", "0.5"], "greedy-only"),
    (["--draft_model", "gpt_tiny"], "needs --draft_k > 0"),
])
def test_cli_validation_messages(argv, message):
    with pytest.raises(SystemExit, match=message):
        serve_lm.main(["--device", "cpu", "--random_init", *argv])


def test_cli_draft_ckpt_is_read_as_npz(tmp_path):
    """--draft_ckpt reads the same .npz --ckpt reads: a draft holding the
    target's own params proposes the target's own greedy tokens (only
    the requests' budgets cut acceptance)."""
    params = init_params(get_model("gpt_tiny"), 3, "cpu")
    path = tmp_path / "params.npz"
    np.savez(path, **{name.replace(".", "/"): t.numpy()
                      for name, t in params.items()})
    snap = serve_lm.main([
        "--device", "cpu", "--model", "gpt_tiny", "--ckpt", str(path),
        "--draft_model", "gpt_tiny", "--draft_ckpt", str(path),
        "--synthetic", "3", "--max_slots", "2", "--max_new_tokens", "6",
        "--decode_horizon", "2", "--draft_k", "2", "--quiet"])
    assert snap["requests_completed"] == 3 and snap["draft_k"] == 2
    assert snap["spec_verify_passes"] > 0
    assert snap["spec_accept_rate"] > 0.5
