"""The decode kernel's split plan and its split-and-fold algebra, on the
CPU.

On the card a decode call (rows 1 and 2: dense or paged, model dtype or
int8) runs as CTAs of ``split`` keys over a slot's window; a CTA whose
split starts past the slot's reach ``min(position, W - 1)`` returns at
once, and a second kernel folds the live splits' partials in split order
(a window of one split is one launch that writes the output itself).
:func:`decode_split_plan` is how the wrapper cuts a call (grid and
workspace), and :func:`decode_split_ranges` writes out, in Python, the
rule by which the kernel decides from a slot's position which CTAs are
live and which keys each walks. The plan tests hold both to their
contract for windows 1, 40, 64, 300 and 1024, positions at the edges, at
the split boundaries and at random, and show that the wrapper launches
the same plan for a dense window and for the same columns in pages; they
import no jax.

The arithmetic is then emulated in float64 as the kernels order it: in
each live split, four warps of 16 keys a 64-key tile, each an online
softmax in the log2 domain; the warps folded at the end of the split;
the splits folded in split order. The emulation matches the port's plain
version run in float64 within 1e-12 (the same function, summed in
another order), and, on numpy inputs from a seed, the JAX package's
``xla_decode_attention`` and ``xla_paged_decode_attention`` within 1e-5
(the JAX functions compute in f32), in int8 too.
"""

import importlib
import math
import types

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    QuantizedKV, quantize_kv, quantize_kv_np)

# the module (the package's ``decode_attention`` name is the function)
da = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")

WINDOWS = (1, 40, 64, 300, 1024)
SPLITS = (64, 128, 256)  # chip_smoke phase 12's A/B
TILE, WARPS = 64, 4  # keys of a ring tile; warps of a CTA (16 keys each)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positions(window, seed):
    """0, the window's last column, beyond the window, both sides of the
    split boundaries and random columns."""
    rng = np.random.default_rng(seed)
    edges = [e + d for e in (64, 128, 256, 512) for d in (-1, 0, 1)]
    fixed = [0, window - 1, window, window + 3] + edges
    return sorted(set(fixed + rng.integers(0, window + 8, 8).tolist()))


@pytest.mark.parametrize("window", WINDOWS)
def test_every_reachable_column_in_exactly_one_split(window):
    for split in SPLITS:
        plan = da.decode_split_plan(8, 12, window, 64, split=split)
        for pos in _positions(window, seed=window):
            ranges = da.decode_split_ranges(plan, pos, window)
            walked = [c for start, end in ranges for c in range(start, end)]
            assert walked == list(range(min(pos, window - 1) + 1))
            for start, end in ranges:  # a range stays in its split
                assert start % split == 0 and start < end
                assert end <= start + split


@pytest.mark.parametrize("window", WINDOWS)
def test_splits_past_the_reach_are_skipped(window):
    for split in SPLITS:
        plan = da.decode_split_plan(8, 12, window, 64, split=split)
        for pos in _positions(window, seed=window + 1):
            reach = min(pos, window - 1)
            live = {start // split
                    for start, _ in da.decode_split_ranges(plan, pos, window)}
            # the merge folds reach // split + 1 splits, the live ones
            assert live == set(range(reach // split + 1))
            skipped = set(range(plan.n_splits)) - live
            assert all(s * split > reach for s in skipped)
            if pos < split:
                assert live == {0}


@pytest.mark.parametrize("window", WINDOWS)
def test_workspace_shape_matches_the_grid(window):
    for split in SPLITS:
        for batch, heads, d in ((8, 12, 64), (3, 2, 32), (1, 4, 128)):
            plan = da.decode_split_plan(batch, heads, window, d, split=split)
            assert plan.split == split
            assert plan.grid == (batch * heads, plan.n_splits)
            # the splits cover the window, no more
            assert (plan.n_splits - 1) * split < window <= \
                plan.n_splits * split
            if window <= split:  # one launch: no workspace, no merge
                assert plan.n_splits == 1 and plan.partials is None
            else:
                assert plan.partials == (batch * heads, plan.n_splits, d + 4)
    assert da.decode_split_plan(8, 12, window, 64).split == da.DECODE_SPLIT


def test_plan_limits():
    """The default split, and splits the ring cannot take."""
    assert da.DECODE_SPLIT in SPLITS
    assert da.decode_split_plan(1, 1, 65535 * 64, 64, split=64).n_splits \
        <= 65535
    for bad in (0, 32, 96, 100):
        with pytest.raises(ValueError, match="multiple of 64"):
            da.decode_split_plan(1, 1, 1024, 64, split=bad)


def _record_launch(monkeypatch):
    """Route the decode C entry to a recorder (CPU tensors: no card is
    touched); returns the list of launched plans."""
    launched = []

    def entry(args, stream):
        a = args._obj
        launched.append((a.d.B, a.d.H, a.d.W, a.d.D, a.split, a.n_splits,
                         bool(a.partials), bool(a.d.table)))
        return 0

    monkeypatch.setattr(da, "_kernel", lambda verify=False: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return launched


@pytest.mark.parametrize("w", [64, 1024])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 24, 32])
def test_plan_does_not_depend_on_the_layout(monkeypatch, quant, ps, w):
    """The wrapper launches one plan for a dense window and for the same
    columns in pages of 8, 16, 24 or 32 (24: split boundaries inside a
    page), model dtype or int8; a 64-column window is one launch with no
    workspace, a 1024-column one has a workspace."""
    launched = _record_launch(monkeypatch)
    b, h, d = 3, 2, 64
    rng = np.random.default_rng(ps)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, w, h, d),
                                             dtype=np.float32))
    n_win = -(-w // ps)
    pages = torch.from_numpy(rng.standard_normal((1 + b * n_win, h, ps, d),
                                                 dtype=np.float32))
    if quant:
        k, pages = quantize_kv(k), quantize_kv(pages)
    table = torch.arange(1, 1 + b * n_win, dtype=torch.int32).view(b, n_win)
    pos = torch.tensor([0, 517 % w, w - 2], dtype=torch.int32)
    da._launch(q, k, k, pos, window=w)
    da._launch(q, pages, pages, pos, window=w, table=table, page_size=ps)
    plan = da.decode_split_plan(b, h, w, d)
    spill = plan.partials is not None
    assert spill == (w > da.DECODE_SPLIT)
    assert launched == [
        (b, h, w, d, plan.split, plan.n_splits, spill, False),
        (b, h, w, d, plan.split, plan.n_splits, spill, True)]


# ---- the split-and-fold algebra in float64 -----------------------------

LOG2E = 1.0 / math.log(2.0)


def _fold(states, d):
    """``(m, l, acc)`` states folded in order, online, in the log2
    domain (a state that saw no key keeps m = -inf and is skipped)."""
    m, l, acc = -math.inf, 0.0, np.zeros(d)
    for mi, li, ai in states:
        if mi == -math.inf:
            continue
        m_new = max(m, mi)
        co, cn = 2.0 ** (m - m_new), 2.0 ** (mi - m_new)
        m, l, acc = m_new, l * co + li * cn, acc * co + ai * cn
    return m, l, acc


def _emulate(q, k, v, pos, split):
    """The decode kernels' arithmetic in float64 on ``[B, 1, H, Dh]`` /
    ``[B, W, H, Dh]`` arrays: per (slot, head) and live split, each warp's
    online softmax over its 16 keys of every tile, the warps folded at
    the split's end, the splits folded in split order."""
    b_, w, h_, d = k.shape
    plan = da.decode_split_plan(b_, h_, w, d, split=split)
    c = d ** -0.5 * LOG2E
    out = np.zeros((b_, 1, h_, d))
    for b in range(b_):
        ranges = da.decode_split_ranges(plan, int(pos[b]), w)
        for h in range(h_):
            parts = []
            for start, end in ranges:
                warps = []
                for wp in range(WARPS):
                    m, l, acc = -math.inf, 0.0, np.zeros(d)
                    for t0 in range(start, end, TILE):
                        keys = np.arange(t0 + 16 * wp,
                                         min(t0 + 16 * wp + 16, end))
                        if keys.size == 0:
                            continue
                        t = k[b, keys, h] @ q[b, 0, h] * c
                        m_new = max(m, t.max())
                        p = 2.0 ** (t - m_new)
                        corr = 2.0 ** (m - m_new)
                        m, l = m_new, l * corr + p.sum()
                        acc = acc * corr + p @ v[b, keys, h]
                    warps.append((m, l, acc))
                parts.append(_fold(warps, d))
            _, l, acc = _fold(parts, d)
            out[b, 0, h] = acc / l
    return out


def _case(w, d, seed, quant=False, b=3, h=2):
    """q, k, v (numpy f32; int8 K/V as their ``(data, scale)`` pairs
    and the f32 values they dequantize to) and positions: 0, W-1, beyond
    the window, both sides of the split boundaries and random columns."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, w, h, d)) * 2).astype(np.float32)
    v = rng.standard_normal((b, w, h, d)).astype(np.float32)
    edges = [0, w - 1, w + 5, 63, 64, 128, 255, 256, 300]
    pos = np.array([edges[(seed + i) % len(edges)] for i in range(b)],
                   np.int32)
    pos[-1] = rng.integers(0, w)
    pairs = None
    if quant:
        pairs = [quantize_kv_np(x) for x in (k, v)]
        k, v = ((dq.astype(np.float32) * sc[..., None]).astype(np.float32)
                for dq, sc in pairs)
    return q, k, v, pos, pairs


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("w", WINDOWS)
def test_split_fold_matches_plain_in_float64(w, split):
    """Split then fold in split order == the plain version (f64) within
    1e-12, Dh 32 and 64."""
    for d in (32, 64):
        q, k, v, pos, _ = _case(w, d, seed=w + split + d, b=4)
        want = da.torch_decode_attention(
            *(torch.from_numpy(x.astype(np.float64)) for x in (q, k, v)),
            torch.from_numpy(pos))
        assert want.dtype == torch.float64
        got = _emulate(*(x.astype(np.float64) for x in (q, k, v)), pos,
                       split)
        np.testing.assert_allclose(got, want.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("w", [40, 300, 1024])
def test_split_fold_matches_jax_dense(w, quant):
    """The emulation at the default split against the JAX package's
    ``decode_attention(impl="xla")`` (``xla_decode_attention`` behind
    the int8 dequantize) on the same numpy inputs, within 1e-5."""
    import jax.numpy as jnp
    from pytorch_multiprocessing_distributed_tpu.ops import kv_quant as jkq
    jda = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu.ops.pallas.decode_attention")

    q, k, v, pos, pairs = _case(w, 32, seed=w, quant=quant)
    if quant:
        jk, jv = (jkq.QuantizedKV(jnp.asarray(dq), jnp.asarray(sc))
                  for dq, sc in pairs)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(jda.decode_attention(jnp.asarray(q), jk, jv,
                                           jnp.asarray(pos), impl="xla"))
    if not quant:  # the XLA reference itself, mask from the positions
        mask = np.arange(w)[None, :] <= pos[:, None]
        np.testing.assert_array_equal(want, np.asarray(
            jda.xla_decode_attention(jnp.asarray(q), jk, jv,
                                     jnp.asarray(mask))))
    got = _emulate(*(x.astype(np.float64) for x in (q, k, v)), pos,
                   da.DECODE_SPLIT)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _paged_of(x, ps, table, n_pages):
    """The ``[B, W, H, ...]`` window laid out in ``[P, H, ps, ...]``
    pages through ``table`` (every other page random)."""
    b, w = x.shape[:2]
    n_win = table.shape[1]
    rest = x.shape[2:]
    pages = np.random.default_rng(n_pages).standard_normal(
        (n_pages, rest[0], ps) + rest[1:]).astype(x.dtype)
    full = np.zeros((b, n_win * ps) + rest, x.dtype)
    full[:, :w] = x
    blocks = np.moveaxis(full.reshape((b, n_win, ps) + rest), 2, 3)
    pages[table] = blocks
    return pages


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [16, 24])
def test_split_fold_matches_jax_paged(ps, quant):
    """The emulation on the gathered window against the JAX package's
    ``xla_paged_decode_attention`` over shuffled pages (page size 24
    puts split boundaries inside a page), within 1e-5."""
    import jax.numpy as jnp
    from pytorch_multiprocessing_distributed_tpu.ops import kv_quant as jkq
    jda = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu.ops.pallas.decode_attention")

    w, b = 300, 3
    q, k, v, pos, pairs = _case(w, 32, seed=ps, quant=quant, b=b)
    n_win = -(-w // ps)
    n_pages = 1 + b * n_win
    table = (np.random.default_rng(ps).permutation(n_pages - 1)[:b * n_win]
             + 1).reshape(b, n_win).astype(np.int32)
    if quant:
        jk, jv = (jkq.QuantizedKV(
            jnp.asarray(_paged_of(dq, ps, table, n_pages).astype(np.int8)),
            jnp.asarray(_paged_of(sc[..., None], ps, table,
                                  n_pages)[..., 0].astype(np.float32)))
            for dq, sc in pairs)
    else:
        jk, jv = (jnp.asarray(_paged_of(x, ps, table, n_pages))
                  for x in (k, v))
    want = np.asarray(jda.xla_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
        window=w))
    got = _emulate(*(x.astype(np.float64) for x in (q, k, v)), pos,
                   da.DECODE_SPLIT)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_paged_equals_dense_on_the_emulated_inputs():
    """The port's plain paged version over the same pages gives the
    dense plain version's bits, and both sit within 1e-5 of the f64
    emulation (int8 included)."""
    w, b, ps = 300, 3, 24
    for quant in (False, True):
        q, k, v, pos, pairs = _case(w, 32, seed=7, quant=quant, b=b)
        n_win = -(-w // ps)
        n_pages = 1 + b * n_win
        table = (np.random.default_rng(7).permutation(n_pages - 1)
                 [:b * n_win] + 1).reshape(b, n_win).astype(np.int32)
        tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
        if quant:
            dense = [QuantizedKV(torch.from_numpy(dq), torch.from_numpy(sc))
                     for dq, sc in pairs]
            paged = [QuantizedKV(
                torch.from_numpy(_paged_of(dq, ps, table, n_pages)
                                 .astype(np.int8)),
                torch.from_numpy(_paged_of(sc[..., None], ps, table,
                                           n_pages)[..., 0]
                                 .astype(np.float32)))
                for dq, sc in pairs]
        else:
            dense = [torch.from_numpy(x) for x in (k, v)]
            paged = [torch.from_numpy(_paged_of(x, ps, table, n_pages))
                     for x in (k, v)]
        got_dense = da.torch_decode_attention(tq, *dense, tpos)
        got_paged = da.torch_paged_decode_attention(
            tq, *paged, torch.from_numpy(table), tpos, w)
        assert torch.equal(got_dense, got_paged)
        emulated = _emulate(*(x.astype(np.float64) for x in (q, k, v)),
                            pos, da.DECODE_SPLIT)
        np.testing.assert_allclose(got_dense.numpy(), emulated, atol=1e-5,
                                   rtol=0)
