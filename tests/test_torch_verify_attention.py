"""The port's k-query verify attention against the JAX package's.

The plain PyTorch versions (what the wrappers run on a CPU tensor, and
the CUDA kernels' references on the card) are held against the JAX
Pallas verify kernels in interpret mode (``verify_decode_attention`` and
``paged_verify_decode_attention`` with ``impl="pallas"``) and against
their XLA references, on the same numpy inputs: K1 = 1, 2 and 5 query
rows, model dtype and int8 K/V, dense windows and shuffled page tables
(page size 8) whose unallocated entries point at a scratch page 0 full
of huge values, and positions whose last row reaches the window's last
column or past it. Tolerances are the decode tests': f32 atol 1e-5 (the
same f32 math, summed in another order); bf16 compared in f32 atol 1e-2
(the Pallas kernels round the probabilities to bf16 before the PV
product, the port keeps f32). A row reaching past a window that is not
a block multiple (dense) or past a window shorter than the table's
pages (paged) is compared with XLA only: the Pallas kernels attend the
padded block or the rest of the pages there, the port clamps to the
window as XLA does (ROADMAP.md queue 3 item 3).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops import kv_quant as jkq
from pytorch_multiprocessing_distributed_tpu_torch.ops import resolve_impl
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    QuantizedKV, quantize_kv_np)

jda = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu.ops.pallas.decode_attention")
tda = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")

B, H, DH, PS, N_WIN, BLOCK_K = 3, 2, 32, 8, 4, 16
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _to_jax(a, dtype, quant):
    if quant:
        return jkq.QuantizedKV(jnp.asarray(a[0]), jnp.asarray(a[1]))
    return jnp.asarray(a, dtype)


def _to_torch(a, dtype, quant):
    if quant:
        return QuantizedKV(torch.from_numpy(a[0]), torch.from_numpy(a[1]))
    return torch.from_numpy(a).to(dtype)


def _dense_inputs(s, k1, quant, seed):
    """q [B, K1, H, Dh], a dense window of s columns and positions: 0,
    one whose last row lands on column s - 1, and one whose rows reach
    past the window."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, k1, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, s, H, DH)).astype(np.float32) * 2
    v = rng.normal(size=(B, s, H, DH)).astype(np.float32)
    if quant:
        k, v = quantize_kv_np(k), quantize_kv_np(v)
    pos = np.asarray([0, s - k1, s - 1], np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k1", [1, 2, 5])
@pytest.mark.parametrize("s", [40, 64])
def test_plain_verify_matches_jax(quant, dtype, k1, s):
    q, k, v, pos = _dense_inputs(s, k1, quant, seed=s + k1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tda.verify_decode_attention(
        torch.from_numpy(q).to(tdt), _to_torch(k, tdt, quant),
        _to_torch(v, tdt, quant), torch.from_numpy(pos)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, k1, H, DH)
    args = (jnp.asarray(q, jdt), _to_jax(k, jdt, quant),
            _to_jax(v, jdt, quant), jnp.asarray(pos))
    xla = np.asarray(jda.verify_decode_attention(*args, impl="xla"),
                     np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    pallas = np.asarray(jda.verify_decode_attention(
        *args, impl="pallas", block_k=BLOCK_K, interpret=True), np.float32)
    reach = pos[:, None] + np.arange(k1)[None, :]  # [B, K1]
    same = (reach < s) | (s % BLOCK_K == 0)
    np.testing.assert_allclose(got[same], pallas[same], atol=TOL[dtype],
                               rtol=0)


def _paged_inputs(seed, k1, quant):
    """q, k/v pages (int8 as (data, scale) pairs), a shuffled table
    whose entries past each slot's last reachable column point at the
    scratch page 0, and positions: inside, at the table's edge and past
    it for the last row."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * N_WIN + 3
    span = N_WIN * PS
    q = rng.normal(size=(B, k1, H, DH)).astype(np.float32)
    k = rng.normal(size=(n_pages, H, PS, DH)).astype(np.float32)
    v = rng.normal(size=(n_pages, H, PS, DH)).astype(np.float32)
    k[0], v[0] = 1e30, 1e30  # scratch: never attended
    table = rng.permutation(np.arange(1, n_pages))[:B * N_WIN].reshape(
        B, N_WIN).astype(np.int32)
    pos = np.asarray([5, span - k1, span - 2], np.int32)
    for row, p in enumerate(pos):
        used = -(-(min(p + k1 - 1, span - 1) + 1) // PS)
        table[row, used:] = 0
    if quant:
        k, v = quantize_kv_np(k), quantize_kv_np(v)
        k[1][0], v[1][0] = 1e30, 1e30
    return q, k, v, table, pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k1", [1, 2, 5])
@pytest.mark.parametrize("window", [None, 20])
def test_plain_paged_verify_matches_jax(quant, dtype, k1, window):
    q, k, v, table, pos = _paged_inputs(11 + k1, k1, quant)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    n_win = N_WIN if window is None else -(-window // PS)
    tab = table[:, :n_win]
    got = tda.paged_verify_decode_attention(
        torch.from_numpy(q).to(tdt), _to_torch(k, tdt, quant),
        _to_torch(v, tdt, quant), torch.from_numpy(tab),
        torch.from_numpy(pos), window=window).numpy()
    assert got.dtype == np.float32 and got.shape == (B, k1, H, DH)
    assert np.isfinite(got).all()
    args = (jnp.asarray(q, jdt), _to_jax(k, jdt, quant),
            _to_jax(v, jdt, quant), jnp.asarray(tab), jnp.asarray(pos))
    xla = np.asarray(jda.paged_verify_decode_attention(
        *args, window=window, impl="xla"), np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    pallas = np.asarray(jda.paged_verify_decode_attention(
        *args, window=window, impl="pallas", interpret=True), np.float32)
    w = n_win * PS if window is None else window
    reach = pos[:, None] + np.arange(k1)[None, :]
    same = (reach < w) | (w == n_win * PS)
    np.testing.assert_allclose(got[same], pallas[same], atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_one_row_is_the_decode_attention(quant):
    """K1 = 1 is the port's single-query decode attention, bit for bit,
    dense and paged."""
    q, k, v, pos = _dense_inputs(40, 1, quant, seed=3)
    tq = torch.from_numpy(q)
    tk, tv = (_to_torch(a, torch.float32, quant) for a in (k, v))
    tpos = torch.from_numpy(pos)
    assert torch.equal(tda.verify_decode_attention(tq, tk, tv, tpos),
                       tda.decode_attention(tq, tk, tv, tpos))
    q, k, v, table, pos = _paged_inputs(4, 1, quant)
    args = (torch.from_numpy(q),
            *(_to_torch(a, torch.float32, quant) for a in (k, v)),
            torch.from_numpy(table), torch.from_numpy(pos))
    assert torch.equal(tda.paged_verify_decode_attention(*args),
                       tda.paged_decode_attention(*args))


def test_paged_equals_dense_on_the_same_columns():
    """The paged plain version is the dense one on the gathered columns:
    equal bit for bit."""
    q, k, v, table, pos = _paged_inputs(5, 5, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ttab, tpos = torch.from_numpy(table), torch.from_numpy(pos)
    idx = ttab.long()
    dense_k = tk[idx].permute(0, 1, 3, 2, 4).reshape(B, N_WIN * PS, H, DH)
    dense_v = tv[idx].permute(0, 1, 3, 2, 4).reshape(B, N_WIN * PS, H, DH)
    assert torch.equal(
        tda.paged_verify_decode_attention(tq, tk, tv, ttab, tpos),
        tda.verify_decode_attention(tq, dense_k, dense_v, tpos))


def test_wrapper_contract_on_cpu():
    """``auto`` runs the plain version on a CPU tensor, ``cuda`` raises
    there, and the kernel's row-count check names its error."""
    q, k, v, pos = (torch.from_numpy(a)
                    for a in _dense_inputs(16, 2, False, seed=6))
    assert resolve_impl("auto", q) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        tda.verify_decode_attention(q, k, v, pos, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tda.paged_verify_decode_attention(
            q, k.view(B, 2, 8, H, DH)[:, 0].transpose(1, 2).contiguous(),
            v.view(B, 2, 8, H, DH)[:, 0].transpose(1, 2).contiguous(),
            torch.zeros(B, 1, dtype=torch.int32), pos, impl="cuda")
    with pytest.raises(tda.VerifyRowsError, match="K1"):
        tda._check(q[:, :0], k, v, pos, verify=True)
    with pytest.raises(ValueError, match=r"\[B, 1, H, Dh\]"):
        tda._check(q, k, v, pos)  # two rows through the decode entry
    tda._check(q, k, v, pos, verify=True)
    counts = [getattr(f, n) for f in (tda.verify_decode_attention,
                                      tda.paged_verify_decode_attention)
              for n in ("launches", "int8_launches")]
    tda.verify_decode_attention(q, k, v, pos)
    assert counts == [getattr(f, n) for f in (
        tda.verify_decode_attention, tda.paged_verify_decode_attention)
        for n in ("launches", "int8_launches")]  # the plain path counts 0
