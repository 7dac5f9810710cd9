"""The port's paged and int8 decode attention against the JAX package's.

The plain PyTorch versions (what the wrappers run on a CPU tensor, and
the CUDA kernels' references on the card) are held against the JAX
Pallas kernels in interpret mode (``paged_decode_attention`` and
``decode_attention`` with ``impl="pallas"``) and against their XLA
references, on the same numpy inputs: shuffled page tables whose
unallocated entries point at a scratch page 0 full of huge values, and
positions at 0, inside the window and beyond it. Tolerances: f32 atol
1e-5 (the same f32 math, summed in another order); bf16 compared in f32
atol 1e-2 (the Pallas kernels round the probabilities to bf16 before
the PV product, the port keeps f32). A row beyond a window that is not a
page (or block) multiple is compared with XLA only: the Pallas kernels
attend the rest of that last page or block, the port clamps to the
window as XLA does (ROADMAP.md queue 3 item 3).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops import kv_quant as jkq
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    QuantizedKV, quantize_kv_np)

# the modules (each package's ``decode_attention`` name is the function)
jda = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu.ops.pallas.decode_attention")
tda = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")

B, H, DH, PS, N_WIN = 3, 2, 32, 8, 4
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _paged_inputs(seed, quant):
    """q, k/v pages (numpy; int8 as (data, scale) pairs), a shuffled
    table (unallocated entries -> scratch page 0) and positions."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * N_WIN + 3
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k = rng.normal(size=(n_pages, H, PS, DH)).astype(np.float32)
    v = rng.normal(size=(n_pages, H, PS, DH)).astype(np.float32)
    k[0], v[0] = 1e30, 1e30  # scratch: never attended
    ids = rng.permutation(np.arange(1, n_pages))[:B * N_WIN]
    table = ids.reshape(B, N_WIN).astype(np.int32)
    table[0, 1:] = 0  # slot 0 holds one page
    pos = np.asarray([5, 17, N_WIN * PS + 3], np.int32)
    if quant:
        k, v = quantize_kv_np(k), quantize_kv_np(v)
        k[1][0], v[1][0] = 1e30, 1e30
    return q, k, v, table, pos


def _to_jax(a, dtype, quant):
    if quant:
        return jkq.QuantizedKV(jnp.asarray(a[0]), jnp.asarray(a[1]))
    return jnp.asarray(a, dtype)


def _to_torch(a, dtype, quant):
    if quant:
        return QuantizedKV(torch.from_numpy(a[0]), torch.from_numpy(a[1]))
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16, 20])
def test_plain_paged_matches_jax(quant, dtype, window):
    q, k, v, table, pos = _paged_inputs(3, quant)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    n_win = N_WIN if window is None else -(-window // PS)
    tab = table[:, :n_win]
    got = tda.torch_paged_decode_attention(
        torch.from_numpy(q).to(tdt), _to_torch(k, tdt, quant),
        _to_torch(v, tdt, quant), torch.from_numpy(tab),
        torch.from_numpy(pos), window).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 1, H, DH)
    args = (jnp.asarray(q, jdt), _to_jax(k, jdt, quant),
            _to_jax(v, jdt, quant), jnp.asarray(tab), jnp.asarray(pos))
    xla = np.asarray(jda.paged_decode_attention(
        *args, window=window, impl="xla"), np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    pallas = np.asarray(jda.paged_decode_attention(
        *args, window=window, impl="pallas", interpret=True), np.float32)
    w = n_win * PS if window is None else window
    same = (pos < w) | (w % PS == 0)
    np.testing.assert_allclose(got[same], pallas[same], atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 64])
def test_plain_int8_dense_matches_jax(dtype, s):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k = quantize_kv_np(rng.normal(size=(B, s, H, DH)) * 2)
    v = quantize_kv_np(rng.normal(size=(B, s, H, DH)))
    pos = np.asarray([0, s - 1, s + 4], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tda.decode_attention(
        torch.from_numpy(q).to(tdt), _to_torch(k, tdt, True),
        _to_torch(v, tdt, True), torch.from_numpy(pos)).numpy()
    args = (jnp.asarray(q, jdt), _to_jax(k, jdt, True),
            _to_jax(v, jdt, True), jnp.asarray(pos))
    xla = np.asarray(jda.decode_attention(*args, impl="xla"), np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    pallas = np.asarray(jda.decode_attention(
        *args, impl="pallas", block_k=16, interpret=True), np.float32)
    same = (pos < s) | (s % 16 == 0)
    np.testing.assert_allclose(got[same], pallas[same], atol=TOL[dtype],
                               rtol=0)


def test_paged_equals_dense_on_the_same_columns():
    """The paged plain version is the dense one on gathered columns: a
    dense cache cut into shuffled pages gives bit-equal outputs."""
    rng = np.random.default_rng(5)
    w = N_WIN * PS
    q = torch.from_numpy(rng.normal(size=(B, 1, H, DH)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, w, H, DH)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, w, H, DH)).astype(np.float32))
    pos = torch.tensor([0, 13, w + 2], dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(B * N_WIN) + 1)
    table = perm.view(B, N_WIN).to(torch.int32)
    pages = torch.zeros(1 + B * N_WIN, H, PS, DH)
    vpages = torch.zeros_like(pages)
    tiles = k.view(B, N_WIN, PS, H, DH).transpose(2, 3)
    pages[table.long()] = tiles
    vpages[table.long()] = v.view(B, N_WIN, PS, H, DH).transpose(2, 3)
    dense = tda.decode_attention(q, k, v, pos)
    paged = tda.paged_decode_attention(q, pages, vpages, table, pos)
    torch.testing.assert_close(paged, dense, atol=0, rtol=0)


def test_paged_wrapper_on_cpu_counts_no_launch():
    q, k, v, table, pos = _paged_inputs(1, True)
    before = (tda.paged_decode_attention.launches,
              tda.paged_decode_attention.int8_launches,
              tda.decode_attention.int8_launches)
    out = tda.paged_decode_attention(
        torch.from_numpy(q), _to_torch(k, torch.float32, True),
        _to_torch(v, torch.float32, True), torch.from_numpy(table),
        torch.from_numpy(pos), impl="auto")
    assert out.shape == (B, 1, H, DH)
    assert before == (tda.paged_decode_attention.launches,
                      tda.paged_decode_attention.int8_launches,
                      tda.decode_attention.int8_launches)
    with pytest.raises(ValueError, match="CUDA"):
        tda.paged_decode_attention(
            torch.from_numpy(q), _to_torch(k, torch.float32, True),
            _to_torch(v, torch.float32, True), torch.from_numpy(table),
            torch.from_numpy(pos), impl="cuda")


@pytest.mark.parametrize("change, match", [
    (dict(table_dtype=torch.int64), "page_table must be int32"),
    (dict(window=N_WIN * PS + 1), "window"),
    (dict(heads=H + 1), "pages must be"),
    (dict(scale_dtype=torch.float16), "scale must be f32"),
])
def test_paged_kernel_input_checks(change, match):
    """What the paged kernel does not take is refused before a launch."""
    q = torch.zeros(B, 1, H, DH)
    heads = change.get("heads", H)
    data = torch.zeros(9, heads, PS, DH, dtype=torch.int8)
    scale = torch.ones(9, heads, PS,
                       dtype=change.get("scale_dtype", torch.float32))
    kv = QuantizedKV(data, scale)
    table = torch.ones(B, N_WIN, dtype=change.get("table_dtype",
                                                  torch.int32))
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tda._check_paged(q, kv, kv, table, pos, change.get("window"))
