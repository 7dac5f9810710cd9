"""The port's CUDA kernels on the card (every test here is marked
``cuda`` and skips on a machine without one; the kernels have no CPU
mode). This file imports neither jax nor the JAX package, so it runs on
a GPU machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors. Decode attention and its k-query verify twin (dense and paged,
model dtype and int8): atol 1e-4 — the same f32 math on the same values
(int8 rows dequantized by the same expression, rounded to q's dtype),
only the summation order differs; the paged variants read shuffled
tables whose unallocated entries point at a scratch page full of NaN
and huge values, so a read past a slot's last reachable column would
show. Both split-K kernels also give the same bits over two calls, and
for a dense window and the same columns in pages (they walk the keys in
one order whatever the layout); a decode call captured in a CUDA graph
replays the eager bits. With ``starts`` (a ragged batch's first valid
column a slot) row 1 is held likewise, its pad columns full of NaN
(never read), and starts of zeros give the bits of no starts. Flash
attention: in f32 the
output and lse within 1e-4 and the gradients within 5e-4 (the same f32
math; the gradients sum up to 300 products per element in another
order); in bf16 the lse within 1e-4 and the bf16 outputs within 2e-2
(the kernels round P and dS to bf16 before their tensor-core products,
as the Pallas kernels do, where the plain version keeps them in f32;
both round the outputs to bf16, and one unit in the last place of a
value near 4 is 3e-2). Fused SGD: bit-equal (tolerance 0) — the kernel
rounds each product and sum on its own, as the plain version's separate
ops do; so the image step with its transforms (``grad_accum``,
``clip_grad_norm``, ``ema_decay``, ``remat``) on ``sgd_fused`` is
bit-equal to the same step on ``sgd``, and ``remat`` to the step without
it, on deterministic cuDNN. Ring all-reduce: bit-equal (tolerance 0) — the kernel keeps the
plain version's chunk layout and its ``own + incoming`` order per
element, each add rounded on its own.
"""

import importlib

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.inference import (
    beam_search, generate)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
    import (VerifyRowsError, decode_attention, paged_decode_attention,
            paged_verify_decode_attention, torch_decode_attention,
            torch_paged_decode_attention, torch_paged_verify_decode_attention,
            torch_verify_decode_attention, verify_decode_attention)
from pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention \
    import (flash_bwd_dkv, flash_bwd_dq, flash_fwd, flash_pair_grads,
            torch_flash_bwd_dkv, torch_flash_bwd_dq, torch_flash_fwd)
from pytorch_multiprocessing_distributed_tpu_torch.ops.fused_update import (
    fused_sgd_, torch_fused_sgd_)
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    QuantizedKV, quantize_kv)
from pytorch_multiprocessing_distributed_tpu_torch.ops import (
    ring_allreduce as ring_module)
from pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce import (
    launch_loopback_, ring_all_reduce, ring_all_reduce_loopback,
    ring_comm_bytes, ring_layout, torch_ring_all_reduce)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, init_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, create_train_state, make_lm_train_step,
    make_train_step, sgd, sgd_fused)

# the module (the package's ``decode_attention`` name is the function)
verify_module = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")
flash_mod = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, w, h, d, dtype, positions, s_max=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_max = s_max or w
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s_max, h, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s_max, h, d, generator=gen, device=dev).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, k[:, :w], v[:, :w], pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("w", [1, 40, 264])
def test_decode_kernel_matches_plain(cuda_device, dtype, d, w):
    """Positions 0, W-1 and beyond the window, on a window view of a
    wider cache (the engine's call)."""
    q, k, v, pos = _inputs(cuda_device, 3, w, 2, d, dtype,
                           [0, w - 1, w + 5], s_max=w + 16)
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, impl="cuda")
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (3, 1, 2, d)
    torch.testing.assert_close(got, torch_decode_attention(q, k, v, pos),
                               atol=1e-4, rtol=0)


def test_decode_wrapper_contract_on_card(cuda_device):
    q, k, v, pos = _inputs(cuda_device, 2, 16, 2, 64, torch.bfloat16,
                           [3, 15])
    with pytest.raises(ValueError, match="CPU tensors only"):
        decode_attention(q, k, v, pos, impl="torch")
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, pos.long())
    flat = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    unaligned = flat[1:].view(2, 16, 2, 64)  # rows off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        decode_attention(q, unaligned, v, pos)
    wq, wk, wv, _ = _inputs(cuda_device, 2, 16, 2, 160, torch.bfloat16,
                            [3, 15])
    with pytest.raises(ValueError, match="Dh <= 128"):
        decode_attention(wq, wk, wv, pos)


def test_engine_on_card_matches_cpu_plain_path(cuda_device):
    """The engine on the card (kernel decode) gives the CPU engine's
    (plain decode) greedy transcripts on the same f32 weights, TF32 off,
    and matches generate on the card."""
    geom = dict(vocab_size=61, max_seq_len=64, hidden_size=64,
                num_layers=2, num_heads=2, mlp_dim=128)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 7, 12, 5)]
    out = {}
    for dev in ("cpu", cuda_device):
        model = GPT(**geom)
        model.load_state_dict(init_params(model, 1, dev), assign=True)
        engine = ServingEngine(model, max_slots=3, s_max=32, min_bucket=8,
                               decode_horizon=4)
        out[str(dev)] = [r.tokens for r in
                         engine.serve([(p, 6) for p in prompts])]
    assert out["cpu"] == out["cuda"]
    for p, toks in zip(prompts, out["cuda"]):
        ref = generate(model, torch.tensor([p], device=cuda_device),
                       max_new_tokens=6)[0, -6:].tolist()
        assert toks == ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("w", [1, 40, 264])
def test_int8_decode_kernel_matches_plain(cuda_device, dtype, d, w):
    """Row 1q: int8 K/V with f32 scales, window views of a wider cache,
    positions 0, W-1 and beyond the window."""
    q, k, v, pos = _inputs(cuda_device, 3, w + 16, 2, d, dtype,
                           [0, w - 1, w + 5], seed=1)
    kq, vq = quantize_kv(k * 3), quantize_kv(v)
    kw = QuantizedKV(kq.data[:, :w], kq.scale[:, :w])
    vw = QuantizedKV(vq.data[:, :w], vq.scale[:, :w])
    before = (decode_attention.launches, decode_attention.int8_launches)
    got = decode_attention(q, kw, vw, pos, impl="cuda")
    torch.cuda.synchronize()
    assert (decode_attention.launches,
            decode_attention.int8_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, torch_decode_attention(q, kw, vw, pos),
                               atol=1e-4, rtol=0)


def _paged(dev, b, h, d, ps, n_win, dtype, quant, positions, seed=0):
    """Pages with a scratch page 0 of garbage (K NaN, V huge), a
    shuffled table held as an unaligned view of a wider one (entries
    past each slot's position point at scratch), and positions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * n_win + 5
    k = torch.randn(n_pages, h, ps, d, generator=gen, device=dev)
    v = torch.randn(n_pages, h, ps, d, generator=gen, device=dev)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    wide = torch.zeros(b, n_win + 3, dtype=torch.int32, device=dev)
    table = wide[:, 1:1 + n_win]
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table.copy_(perm[:b * n_win].view(b, n_win).to(torch.int32))
    span = n_win * ps
    for row, p in enumerate(positions):
        used = -(-(min(p, span - 1) + 1) // ps)
        table[row, used:] = 0
    if quant:
        k, v = quantize_kv(k * 2), quantize_kv(v)
        k.data[0], v.data[0] = 127, 127
        k.scale[0], v.scale[0] = float("nan"), 1e30
    else:
        k, v = k.to(dtype), v.to(dtype)
        k[0], v[0] = float("nan"), 1e30
    return q, k, v, table, pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_decode_kernel_matches_plain(cuda_device, quant, dtype, d,
                                           ps):
    """Row 2 (model dtype and int8): windows of whole pages and of a
    part of the last page, positions 0, inside and beyond the window."""
    n_win = 5
    for window in (None, 3 * ps + 5):
        w = n_win * ps if window is None else window
        q, k, v, table, pos = _paged(cuda_device, 4, 2, d, ps, n_win,
                                     dtype, quant, [0, ps + 3, w - 1,
                                                    w + 7], seed=ps + d)
        name = "int8_launches" if quant else "launches"
        before = getattr(paged_decode_attention, name)
        got = paged_decode_attention(q, k, v, table, pos, window=window,
                                     impl="cuda")
        torch.cuda.synchronize()
        assert getattr(paged_decode_attention, name) == before + 1
        assert torch.isfinite(got).all()
        ref = torch_paged_decode_attention(q, k, v, table, pos, window)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_paged_wrapper_contract_on_card(cuda_device):
    q, k, v, table, pos = _paged(cuda_device, 2, 2, 64, 16, 3,
                                 torch.bfloat16, False, [3, 20])
    with pytest.raises(ValueError, match="CPU tensors only"):
        paged_decode_attention(q, k, v, table, pos, impl="torch")
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, k, v, table.long(), pos)
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(q, k, v, table, pos, window=49)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged", page_size=8),
    dict(kv_dtype="int8"),
    dict(kv_layout="paged", page_size=4, kv_dtype="int8", prefix_cache=4,
         prefill_chunk=5)])
def test_paged_int8_engine_on_card_matches_cpu(cuda_device, kw):
    """The paged/int8 engine on the card (the new kernels) gives the CPU
    engine's (plain versions) greedy transcripts on the same f32 weights
    with TF32 off, and returns every page but the prefix cache's."""
    geom = dict(vocab_size=61, max_seq_len=64, hidden_size=64,
                num_layers=2, num_heads=2, mlp_dim=128)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 9, 12, 5)]
    prompts.append(prompts[2])  # a full hit where the cache is on
    out = {}
    for dev in ("cpu", cuda_device):
        model = GPT(**geom)
        model.load_state_dict(init_params(model, 1, dev), assign=True)
        engine = ServingEngine(model, max_slots=3, s_max=32, min_bucket=8,
                               decode_horizon=4, **kw)
        out[str(dev)] = [r.tokens for r in
                         engine.serve([(p, 6) for p in prompts])]
        if "page_size" in kw:
            cache = engine._prefix_cache
            held = len(cache.page_ids()) if cache is not None else 0
            assert engine.pool.pages_in_use == held
    assert out["cpu"] == out["cuda"]


DECODE_WINDOWS = (1, 63, 64, 65, 300, 1024)  # one split, and several


def _decode_split_case(dev, w, d, dtype, quant, ps, seed, b=6, h=2):
    """q, a dense window view of a wider cache (model dtype or int8),
    the same columns in shuffled pages of ``ps`` behind a scratch page 0
    of NaN (K) and 1e30 (V) that every table entry past a slot's reach
    names, that table, and positions 0, W-1, beyond the window, both
    sides of the first split boundaries and a random column."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, w + 8, h, d, generator=gen, device=dev) * 2
    v = torch.randn(b, w + 8, h, d, generator=gen, device=dev)
    if quant:
        kq, vq = quantize_kv(k), quantize_kv(v)
        k = QuantizedKV(kq.data[:, :w], kq.scale[:, :w])
        v = QuantizedKV(vq.data[:, :w], vq.scale[:, :w])
    else:
        k, v = k.to(dtype)[:, :w], v.to(dtype)[:, :w]
    edges = [0, w - 1, w + 5, min(63, w - 1), min(128, w - 1),
             int(torch.randint(0, w, (1,), generator=gen, device=dev))]
    pos = torch.tensor(edges[:b], dtype=torch.int32, device=dev)
    n_win = -(-w // ps)
    n_pages = 1 + b * n_win
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)
             + 1).view(b, n_win).to(torch.int32)

    def lay(x, garbage):
        if isinstance(x, QuantizedKV):
            return QuantizedKV(lay(x.data, 127),
                               lay(x.scale[..., None], garbage)[..., 0])
        full = torch.zeros(b, n_win * ps, h, x.shape[-1], dtype=x.dtype,
                           device=dev)
        full[:, :w] = x
        pages = torch.full((n_pages, h, ps, x.shape[-1]), garbage,
                           dtype=x.dtype, device=dev)
        pages[table.long()] = full.view(b, n_win, ps, h, -1).permute(
            0, 1, 3, 2, 4)
        return pages

    kp, vp = lay(k, float("nan")), lay(v, 1e30)
    for row, p in enumerate(pos.tolist()):
        table[row, -(-(min(p, w - 1) + 1) // ps):] = 0
    return q, k, v, kp, vp, table, pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_split_kernel_matches_plain(cuda_device, quant, dtype, d):
    """Rows 1 and 2 on the split-K kernel, windows 1, 63, 64, 65, 300 and
    1024 (one split and several): dense and paged (pages of 16 and 24,
    shuffled, the scratch page 0 never read) within 1e-4 of their plain
    versions, dense == paged bit for bit, two calls bit-equal, one
    launch counted a call."""
    name = "int8_launches" if quant else "launches"
    for w in DECODE_WINDOWS:
        for ps in (16, 24):
            q, k, v, kp, vp, table, pos = _decode_split_case(
                cuda_device, w, d, dtype, quant, ps, seed=w + ps + d)
            before = (getattr(decode_attention, name),
                      getattr(paged_decode_attention, name))
            dense = decode_attention(q, k, v, pos, impl="cuda")
            again = decode_attention(q, k, v, pos, impl="cuda")
            paged = paged_decode_attention(q, kp, vp, table, pos, window=w,
                                           impl="cuda")
            torch.cuda.synchronize()
            assert (getattr(decode_attention, name),
                    getattr(paged_decode_attention, name)) == (
                        before[0] + 2, before[1] + 1)
            assert dense.dtype == torch.float32 and dense.shape == (
                6, 1, 2, d)
            assert torch.isfinite(paged).all()
            assert torch.equal(dense, again) and torch.equal(dense, paged)
            torch.testing.assert_close(
                dense, torch_decode_attention(q, k, v, pos), atol=1e-4,
                rtol=0)
            torch.testing.assert_close(
                paged, torch_paged_decode_attention(q, kp, vp, table, pos,
                                                    w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_split_kernel_replays_in_a_graph(cuda_device, quant, dtype,
                                                paged):
    """One call captured in a CUDA graph (the split kernel, and at W =
    1024 the merge kernel as its programmatic dependent) replays the
    eager call's bits, at W = 64 (one split) and 1024."""
    for w in (64, 1024):
        q, k, v, kp, vp, table, pos = _decode_split_case(
            cuda_device, w, 64, dtype, quant, 16, seed=w)
        if paged:
            def call():
                return paged_decode_attention(q, kp, vp, table, pos,
                                              window=w, impl="cuda")
        else:
            def call():
                return decode_attention(q, k, v, pos, impl="cuda")
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def _starts_for(pos, w, gen, dev):
    """A first valid column a slot: 0 for the first, the reach itself
    for the second (one column), both sides of the first split boundary
    where the reach allows, random below the reach for the rest."""
    reach = pos.clamp(max=w - 1).long()
    starts = (torch.rand(pos.shape, generator=gen, device=dev)
              * (reach + 1)).floor().long()
    starts[0] = 0
    starts[1] = reach[1]
    for i, edge in ((3, 127), (4, 128), (5, 129)):
        if i < len(starts) and edge <= reach[i]:
            starts[i] = edge
    return starts.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_kernel_with_starts_matches_plain(cuda_device, dtype, d):
    """Row 1 with a first valid column a slot (a ragged batch's left
    padding), windows of one split and of several: within 1e-4 of the
    plain version, the pad columns never read (NaN there changes
    nothing), two calls bit-equal, one launch counted a call."""
    for w in DECODE_WINDOWS:
        q, k, v, _, _, _, pos = _decode_split_case(
            cuda_device, w, d, dtype, False, 16, seed=w + d)
        gen = torch.Generator(device=cuda_device).manual_seed(w)
        starts = _starts_for(pos, w, gen, cuda_device)
        cols = torch.arange(w, device=cuda_device)[None, :]
        pad = (cols < starts.long()[:, None])[:, :, None, None]
        k_nan = k.masked_fill(pad, float("nan"))
        v_nan = v.masked_fill(pad, float("nan"))
        before = decode_attention.launches
        got = decode_attention(q, k_nan, v_nan, pos, starts=starts,
                               impl="cuda")
        again = decode_attention(q, k_nan, v_nan, pos, starts=starts,
                                 impl="cuda")
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 2
        assert torch.equal(got, again) and torch.isfinite(got).all()
        torch.testing.assert_close(
            got, torch_decode_attention(q, k, v, pos, starts), atol=1e-4,
            rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_zero_starts_is_no_starts(cuda_device, dtype):
    """Starts of zeros walk what a call without them walks: the same
    bits, at one split and several."""
    for w in (64, 1024):
        q, k, v, _, _, _, pos = _decode_split_case(
            cuda_device, w, 64, dtype, False, 16, seed=w)
        zeros = torch.zeros_like(pos)
        assert torch.equal(
            decode_attention(q, k, v, pos, starts=zeros, impl="cuda"),
            decode_attention(q, k, v, pos, impl="cuda"))


def test_decode_starts_contract_on_card(cuda_device):
    q, k, v, _, _, _, pos = _decode_split_case(
        cuda_device, 64, 64, torch.bfloat16, True, 16, seed=1)
    with pytest.raises(ValueError, match="not int8"):
        decode_attention(q, k, v, pos, starts=torch.zeros_like(pos))
    q, k, v, _, _, _, pos = _decode_split_case(
        cuda_device, 64, 64, torch.bfloat16, False, 16, seed=1)
    with pytest.raises(ValueError, match="starts must be int32"):
        decode_attention(q, k, v, pos, starts=pos.long())


def test_ragged_generate_and_beams_on_card_match_cpu(cuda_device):
    """A ragged ``generate`` batch (row 1 with ``starts`` on the card)
    and ``beam_search`` give the CPU's tokens on the same f32 weights,
    TF32 off; each ragged row equals its one-row call."""
    geom = dict(vocab_size=61, max_seq_len=64, hidden_size=64,
                num_layers=2, num_heads=2, mlp_dim=128)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    lengths = [5, 17, 40]
    prompts = [rng.integers(0, 61, (n,)) for n in lengths]
    padded = np.stack([np.concatenate([np.full(40 - len(p), 7), p])
                       for p in prompts])
    out = {}
    for dev in ("cpu", cuda_device):
        model = GPT(**geom)
        model.load_state_dict(init_params(model, 1, dev), assign=True)
        before = decode_attention.launches
        ragged = generate(model, torch.tensor(padded, device=dev),
                          max_new_tokens=8,
                          prompt_lengths=torch.tensor(lengths, device=dev))
        if str(dev) == "cuda":
            assert decode_attention.launches == before + 2 * 7
        beams, scores = beam_search(model, torch.tensor(padded, device=dev),
                                    max_new_tokens=6, beam_size=3)
        out[str(dev)] = (ragged.cpu(), beams.cpu(), scores.cpu())
        for i, p in enumerate(prompts):
            one = generate(model, torch.tensor(p[None], device=dev),
                           max_new_tokens=8)
            assert ragged[i, -8:].tolist() == one[0, -8:].tolist()
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    torch.testing.assert_close(out["cpu"][2], out["cuda"][2], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [64, 128, 256])
def test_decode_kernel_split_sizes(cuda_device, monkeypatch, quant, dtype,
                                   split):
    """Each split size of the A/B (64, 128 and 256 keys a CTA) over a
    1024-column window stays within 1e-4 of the plain version, dense and
    paged bit-equal."""
    monkeypatch.setattr(verify_module, "DECODE_SPLIT", split)
    w = 1024
    q, k, v, kp, vp, table, pos = _decode_split_case(
        cuda_device, w, 64, dtype, quant, 16, seed=split)
    dense = decode_attention(q, k, v, pos, impl="cuda")
    paged = paged_decode_attention(q, kp, vp, table, pos, window=w,
                                   impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)
    torch.testing.assert_close(
        dense, torch_decode_attention(q, k, v, pos), atol=1e-4, rtol=0)


VERIFY_ROWS = (1, 2, 5, 9, 16, 17)  # 16: one full row tile; 17: two


def _verify_q(dev, b, k1, h, d, dtype, seed):
    """q [B, K1, H, Dh] as the verify pass hands it over: a strided view
    of a fused projection (row stride 3 * H * Dh)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, k1, 3 * h * d, generator=gen, device=dev)
    return qkv.to(dtype)[..., :h * d].view(b, k1, h, d)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_verify_kernel_matches_plain(cuda_device, quant, dtype, d):
    """Row 3 (model dtype and int8): K1 = 1, 2, 5 and 9 query rows over
    window views of a wider cache; positions 0, one whose last row lands
    on the window's last column, and one whose rows reach past it."""
    w = 40
    for k1 in VERIFY_ROWS:
        _, k, v, _ = _inputs(cuda_device, 4, w + 16, 2, d, dtype,
                             [0] * 4, seed=k1 + d)
        q = _verify_q(cuda_device, 4, k1, 2, d, dtype, seed=k1)
        pos = torch.tensor([0, 7, w - k1, w - 2], dtype=torch.int32,
                           device=cuda_device)
        if quant:
            kq, vq = quantize_kv(k.float() * 3), quantize_kv(v.float())
            kw = QuantizedKV(kq.data[:, :w], kq.scale[:, :w])
            vw = QuantizedKV(vq.data[:, :w], vq.scale[:, :w])
        else:
            kw, vw = k[:, :w], v[:, :w]
        name = "int8_launches" if quant else "launches"
        before = getattr(verify_decode_attention, name)
        got = verify_decode_attention(q, kw, vw, pos, impl="cuda")
        torch.cuda.synchronize()
        assert getattr(verify_decode_attention, name) == before + 1
        assert got.dtype == torch.float32 and got.shape == (4, k1, 2, d)
        torch.testing.assert_close(
            got, torch_verify_decode_attention(q, kw, vw, pos), atol=1e-4,
            rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_verify_kernel_matches_plain(cuda_device, quant, dtype, d,
                                           ps):
    """Row 4 (model dtype and int8): K1 = 1, 2, 5 and 9 over windows of
    whole pages and of part of the last page, through unaligned shuffled
    tables whose entries past each slot's last reachable column point at
    a NaN scratch page."""
    n_win = 5
    for k1 in VERIFY_ROWS:
        for window in (None, 3 * ps + 5):
            w = n_win * ps if window is None else window
            positions = [0, ps + 3, w - k1, w - 2]
            reach = [min(p + k1 - 1, w - 1) for p in positions]
            _, k, v, table, _ = _paged(cuda_device, 4, 2, d, ps, n_win,
                                       dtype, quant, reach, seed=ps + d)
            q = _verify_q(cuda_device, 4, k1, 2, d, dtype, seed=k1 + ps)
            pos = torch.tensor(positions, dtype=torch.int32,
                               device=cuda_device)
            name = "int8_launches" if quant else "launches"
            before = getattr(paged_verify_decode_attention, name)
            got = paged_verify_decode_attention(q, k, v, table, pos,
                                                window=window, impl="cuda")
            torch.cuda.synchronize()
            assert getattr(paged_verify_decode_attention, name) == \
                before + 1
            assert torch.isfinite(got).all()
            ref = torch_paged_verify_decode_attention(q, k, v, table, pos,
                                                      window)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def _verify_case(dev, b, w, h, d, k1, dtype, quant, seed):
    """q, and the dense K/V window (model dtype or int8) of a wider cache,
    for the multi-split tests."""
    _, k, v, _ = _inputs(dev, b, w + 8, h, d, torch.float32, [0] * b,
                         seed=seed)
    q = _verify_q(dev, b, k1, h, d, dtype, seed=seed + 1)
    if quant:
        kq, vq = quantize_kv(k * 3), quantize_kv(v)
        return (q, QuantizedKV(kq.data[:, :w], kq.scale[:, :w]),
                QuantizedKV(vq.data[:, :w], vq.scale[:, :w]))
    return q, k.to(dtype)[:, :w], v.to(dtype)[:, :w]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_verify_kernel_several_splits(cuda_device, quant, dtype, d):
    """A window of 300 columns, three key splits of 128: positions 0 (one
    live split), rows that straddle the first split boundary, a reach
    that ends before the last split, and rows that reach the window's
    end; K1 = 5, 16 and 17 (two row tiles). Within 1e-4 of the plain
    version, and two calls give the same bits."""
    w = 300
    for k1 in (5, 16, 17):
        q, k, v = _verify_case(cuda_device, 5, w, 2, d, k1, dtype, quant,
                               seed=k1 + d)
        pos = torch.tensor([0, 126, 200, w - k1, w - 2], dtype=torch.int32,
                           device=cuda_device)
        first = verify_decode_attention(q, k, v, pos, impl="cuda")
        second = verify_decode_attention(q, k, v, pos, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(
            first, torch_verify_decode_attention(q, k, v, pos), atol=1e-4,
            rtol=0)


def _pages_of(dense, ps, table, n_pages, garbage):
    """The dense ``[B, W, H, Dh]`` window (or its int8 pair) laid out in
    ``[P, H, ps, Dh]`` pages through ``table``; every page the table does
    not name holds ``garbage`` (int8 data: 127, with ``garbage`` as the
    scale), so a stray read would show."""
    if isinstance(dense, QuantizedKV):
        data = _pages_of(dense.data, ps, table, n_pages, 127)
        scale = _pages_of(dense.scale[..., None], ps, table, n_pages,
                          garbage)
        return QuantizedKV(data, scale[..., 0])
    b, w, h, d = dense.shape
    n_win = table.shape[1]
    pad = n_win * ps - w
    full = torch.cat([dense, dense[:, :pad]], 1) if pad else dense
    pages = torch.full((n_pages, h, ps, d), garbage, dtype=dense.dtype,
                       device=dense.device)
    pages[table.long()] = full.reshape(b, n_win, ps, h, d).permute(
        0, 1, 3, 2, 4)
    return pages


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16, 24, 32])
def test_verify_dense_equals_paged_bitwise(cuda_device, quant, dtype, ps):
    """The same 1024 columns as a dense window and as shuffled pages
    (page size 24 puts split boundaries inside a page): the two variants
    give the same bits, each within 1e-4 of its plain version, and two
    paged calls give the same bits. Positions: 0, rows straddling the
    first split boundary, a reach that ends before the last split, and
    rows that reach the window's end."""
    w, b, h, d, k1 = 1024, 6, 2, 64, 5
    q, k, v = _verify_case(cuda_device, b, w, h, d, k1, dtype, quant,
                           seed=ps)
    pos = torch.tensor([0, 126, 300, 517, w - k1, w - 2], dtype=torch.int32,
                       device=cuda_device)
    n_win = -(-w // ps)
    gen = torch.Generator(device=cuda_device).manual_seed(ps)
    n_pages = 1 + b * n_win
    table = (torch.randperm(n_pages - 1, generator=gen, device=cuda_device)
             [:b * n_win] + 1).view(b, n_win).to(torch.int32)
    kp = _pages_of(k, ps, table, n_pages, float("nan"))
    vp = _pages_of(v, ps, table, n_pages, 1e30)
    for row, p in enumerate(pos.tolist()):
        table[row, -(-(min(p + k1 - 1, w - 1) + 1) // ps):] = 0
    dense = verify_decode_attention(q, k, v, pos, impl="cuda")
    paged = paged_verify_decode_attention(q, kp, vp, table, pos, window=w,
                                          impl="cuda")
    again = paged_verify_decode_attention(q, kp, vp, table, pos, window=w,
                                          impl="cuda")
    torch.cuda.synchronize()
    assert torch.isfinite(paged).all()
    assert torch.equal(dense, paged) and torch.equal(paged, again)
    torch.testing.assert_close(
        dense, torch_verify_decode_attention(q, k, v, pos), atol=1e-4, rtol=0)
    torch.testing.assert_close(
        paged, torch_paged_verify_decode_attention(q, kp, vp, table, pos, w),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [64, 128, 256])
def test_verify_kernel_split_sizes(cuda_device, monkeypatch, quant, dtype,
                                   split):
    """Each split size of the A/B (64, 128 and 256 keys a CTA) over a
    1024-column window stays within 1e-4 of the plain version."""
    monkeypatch.setattr(verify_module, "VERIFY_SPLIT", split)
    w = 1024
    q, k, v = _verify_case(cuda_device, 4, w, 2, 64, 5, dtype, quant,
                           seed=split)
    pos = torch.tensor([0, 190, w - 5, w - 2], dtype=torch.int32,
                       device=cuda_device)
    got = verify_decode_attention(q, k, v, pos, impl="cuda")
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, torch_verify_decode_attention(q, k, v, pos), atol=1e-4, rtol=0)


def test_verify_wrapper_contract_on_card(cuda_device):
    q = _verify_q(cuda_device, 2, 3, 2, 64, torch.bfloat16, seed=0)
    _, k, v, _ = _inputs(cuda_device, 2, 16, 2, 64, torch.bfloat16, [0, 0])
    pos = torch.tensor([3, 12], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CPU tensors only"):
        verify_decode_attention(q, k, v, pos, impl="torch")
    with pytest.raises(VerifyRowsError, match="K1"):
        verify_decode_attention(q[:, :0], k, v, pos)
    with pytest.raises(ValueError, match="int32"):
        verify_decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match=r"\[B, 1, H, Dh\]"):
        decode_attention(q, k, v, pos)  # K1 rows through the decode entry


@pytest.mark.parametrize("kw", [
    dict(draft_k=4),
    dict(draft_k=2, kv_layout="paged", page_size=8, prefill_chunk=5),
    dict(draft_k=4, kv_dtype="int8", kv_layout="paged", page_size=4,
         prefix_cache=4),
    dict(draft_k=4, kv_dtype="int8"),
    dict(draft_k=3, self_draft=True),
])
def test_spec_engine_on_card_matches_cpu(cuda_device, kw):
    """The speculative engine on the card (the verify kernels, and the
    decode kernel for the draft model) gives the CPU engine's greedy
    transcripts on the same f32 weights with TF32 off, with the same
    acceptance; every page but the prefix cache's comes back."""
    geom = dict(vocab_size=61, max_seq_len=64, hidden_size=64,
                num_layers=2, num_heads=2, mlp_dim=128)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, (n,)).tolist() for n in (3, 9, 12, 5)]
    prompts.append(prompts[2])  # a full hit where the cache is on
    kw = dict(kw)
    self_draft = kw.pop("self_draft", False)
    out = {}
    for dev in ("cpu", cuda_device):
        model = GPT(**geom)
        params = init_params(model, 1, dev)
        model.load_state_dict(params, assign=True)
        if self_draft:
            kw.update(draft_model=GPT(**geom), draft_params=params)
        engine = ServingEngine(model, max_slots=3, s_max=32, min_bucket=8,
                               decode_horizon=4, **kw)
        tokens = [r.tokens for r in
                  engine.serve([(p, 6) for p in prompts[:4]]
                               + [(prompts[4], 20)])]
        snap = engine.metrics.snapshot()
        out[str(dev)] = (tokens, snap["spec_tokens_drafted"],
                         snap["spec_tokens_accepted"])
        if "page_size" in kw:
            cache = engine._prefix_cache
            held = len(cache.page_ids()) if cache is not None else 0
            assert engine.pool.pages_in_use == held
    assert out["cpu"] == out["cuda"]


def _flash_inputs(dev, b, sq, skv, h, d, dtype, seed=0):
    """q/k/v as the model passes them: [B, S, H, Dh] views of one fused
    projection (row stride 3*H*Dh); dO contiguous; lse and dterm from the
    plain forward."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv_q = torch.randn(b, sq, 3 * h * d, generator=gen, device=dev)
    qkv_k = torch.randn(b, skv, 3 * h * d, generator=gen, device=dev)
    q = qkv_q.to(dtype)[..., :h * d].view(b, sq, h, d)
    k = qkv_k.to(dtype)[..., h * d:2 * h * d].view(b, skv, h, d)
    v = qkv_k.to(dtype)[..., 2 * h * d:].view(b, skv, h, d)
    do = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    return q, k, v, do


FLASH_TOL = {torch.float32: dict(out=1e-4, grad=5e-4),
             torch.bfloat16: dict(out=2e-2, grad=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal", [(197, 197, True),
                                           (197, 300, False),
                                           (130, 70, False), (1, 1, True),
                                           (127, 127, True),
                                           (128, 128, False),
                                           (129, 129, True),
                                           (255, 255, False),
                                           (129, 255, False),
                                           (255, 129, False),
                                           (1024, 1024, True),
                                           (191, 191, True),
                                           (193, 193, True),
                                           (257, 257, True),
                                           (97, 33, False)])
def test_flash_kernels_match_plain(cuda_device, dtype, d, sq, skv, causal):
    """Rows 5-7 (forward, dq, dk/dv) against their plain versions on the
    fused-QKV strided views, ragged lengths and both masks; 127-129,
    191-193, 255, 257 and 1024 straddle the bf16 kernels' 64-row tiles
    and 128-row CTAs (a CTA's second warpgroup past the end, a last tile
    of one row); Skv 33 is a single ragged k-tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_inputs(cuda_device, 2, sq, skv, 3, d, dtype)
    scale = d ** -0.5
    tol = FLASH_TOL[dtype]
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out, lse = flash_fwd(q, k, v, scale=scale, causal=causal, impl="cuda")
    ref_out, ref_lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    dterm = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    dterm = dterm.contiguous()
    dq = flash_bwd_dq(q, k, v, do, ref_lse, dterm, scale=scale,
                      causal=causal, impl="cuda")
    dk, dv = flash_bwd_dkv(q, k, v, do, ref_lse, dterm, scale=scale,
                           causal=causal, impl="cuda")
    torch.cuda.synchronize()
    ref_dq = torch_flash_bwd_dq(q, k, v, do, ref_lse, dterm, scale=scale,
                                causal=causal)
    ref_dk, ref_dv = torch_flash_bwd_dkv(q, k, v, do, ref_lse, dterm,
                                         scale=scale, causal=causal)
    for got, ref, name in ((dq, ref_dq, "dq"), (dk, ref_dk, "dk"),
                           (dv, ref_dv, "dv")):
        assert got.dtype == dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=tol["grad"], rtol=tol["grad"],
                                   msg=name)
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_pair_grads_are_bit_reproducible(cuda_device, dtype, d):
    """Two calls of the backward pair give equal bits: no atomics, each
    output element summed by one thread in one order."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 255, 255, 3, d, dtype,
                                seed=d)
    _, lse = torch_flash_fwd(q, k, v, scale=d ** -0.5, causal=True)
    dterm = torch.randn(lse.shape, device=cuda_device)
    first = flash_pair_grads(q, k, v, do, lse, dterm, scale=d ** -0.5,
                             causal=True, impl="cuda")
    second = flash_pair_grads(q, k, v, do, lse, dterm, scale=d ** -0.5,
                              causal=True, impl="cuda")
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_pair_grads_ignore_nan_past_the_end(cuda_device, dtype, d,
                                                  causal):
    """q/k/v/dO are the first 129 rows (one past the 64-row tiles) of
    buffers whose later rows hold NaN: the kernels read nothing past the
    end (a NaN row times a zero weight would be NaN), so dq, dk and dv
    are finite and match the plain version on the same views."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = 129
    q, k, v, do = _flash_inputs(cuda_device, 2, s + 63, s + 63, 3, d,
                                dtype, seed=d + causal)
    for t in (q, k, v, do):
        t[:, s:] = float("nan")
    q, k, v, do = (t[:, :s] for t in (q, k, v, do))
    scale = d ** -0.5
    ref_out, lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    dterm = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    dterm = dterm.contiguous()
    got = flash_pair_grads(q, k, v, do, lse, dterm, scale=scale,
                           causal=causal, impl="cuda")
    torch.cuda.synchronize()
    ref = (torch_flash_bwd_dq(q, k, v, do, lse, dterm, scale=scale,
                              causal=causal),
           *torch_flash_bwd_dkv(q, k, v, do, lse, dterm, scale=scale,
                                causal=causal))
    tol = FLASH_TOL[dtype]["grad"]
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_ignores_nan_past_the_end(cuda_device, dtype, d, causal):
    """The forward's twin of the pair's test: q/k/v are the first 129
    rows of buffers whose later rows hold NaN. The forward reads nothing
    past the end (a NaN key or value times a zero weight would be NaN),
    so out and lse are finite and match the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = 129
    q, k, v, _ = _flash_inputs(cuda_device, 2, s + 63, s + 63, 3, d, dtype,
                               seed=d + causal + 7)
    for t in (q, k, v):
        t[:, s:] = float("nan")
    q, k, v = (t[:, :s] for t in (q, k, v))
    scale = d ** -0.5
    out, lse = flash_fwd(q, k, v, scale=scale, causal=causal, impl="cuda")
    ref_out, ref_lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]["out"]
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal", [(1, 1, True), (1, 1, False),
                                           (33, 33, True), (5, 33, False),
                                           (97, 33, False), (97, 32, False),
                                           (64, 32, False), (97, 97, True)])
def test_flash_fwd_where_a_warpgroup_sees_no_key(cuda_device, dtype, d, sq,
                                                 skv, causal):
    """Both forwards take 128 query rows a CTA, 64 a consumer warpgroup,
    and in f32 both warpgroups split every streamed tile for each other.
    With Sq <= 64 the second warpgroup holds no row of the sequence
    (zero-filled query rows that must reach neither O nor lse); with Skv
    32 or 33 the one tile is mostly or wholly past Skv; at S 97 causal the
    first warpgroup skips the second tile (keys 64-127, all above its
    rows) but still splits half of it. Out and lse must stay finite and
    match the plain version."""
    q, k, v, _ = _flash_inputs(cuda_device, 2, sq, skv, 3, d, dtype,
                               seed=sq + skv)
    scale = d ** -0.5
    out, lse = flash_fwd(q, k, v, scale=scale, causal=causal, impl="cuda")
    ref_out, ref_lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]["out"]
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_fwd_is_bit_reproducible(cuda_device, dtype, d):
    """Two calls of the forward give equal bits, output and lse: each
    output element is summed by one thread in one order."""
    q, k, v, _ = _flash_inputs(cuda_device, 2, 255, 255, 3, d, dtype,
                               seed=d + 1)
    first = flash_fwd(q, k, v, scale=d ** -0.5, causal=True, impl="cuda")
    second = flash_fwd(q, k, v, scale=d ** -0.5, causal=True, impl="cuda")
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("out", "lse")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("sq,skv,causal", [(197, 300, False),
                                           (129, 129, True)])
def test_flash_fwd_takes_any_scale(cuda_device, dtype, scale, sq, skv,
                                   causal):
    """A negative or zero logit scale through the forward: the bf16
    kernel takes its row max on the raw logits, so it flips them for a
    negative scale, and a zero scale must not turn a masked logit into
    0 * -inf (the plain version gives a uniform average of the live
    columns)."""
    q, k, v, _ = _flash_inputs(cuda_device, 2, sq, skv, 3, 64, dtype)
    tol = FLASH_TOL[dtype]["out"]
    out, lse = flash_fwd(q, k, v, scale=scale, causal=causal, impl="cuda")
    ref_out, ref_lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


# 3 bf16 SGD steps, flash against the plain masked softmax: both paths
# round q/k/v and the attention output to bf16 at the same places; they
# differ where the kernels also round P (forward) and P, dS (backward) to
# bf16 before their products, which moves each attention output and
# gradient by about one bf16 unit (2^-8 relative). Through two layers,
# the f32 head and 3 steps at lr 0.1 that moves a loss near ln 61 = 4.11
# by far less than 1e-2 (0.25% of it); a wrong mask, scale or tile would
# move it by more than 0.1.
BF16_TRAIN_LOSS_TOL = 1e-2


def test_train_steps_bf16_flash_match_xla_on_card(cuda_device):
    """A 2-layer GPT in bf16 through 3 SGD steps: the flash kernels
    (rows 5-7) against the plain masked softmax (``attn_impl="xla"``),
    from the same params and batch; S = 199 is no multiple of the
    kernels' 64-row tiles."""
    torch.backends.cuda.matmul.allow_tf32 = False
    geom = dict(vocab_size=61, max_seq_len=256, hidden_size=128,
                num_layers=2, num_heads=2, mlp_dim=256)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 61, (4, 200))).to(cuda_device)
    losses = {}
    for impl in ("flash", "xla"):
        model = GPT(**geom, dtype=torch.bfloat16, attn_impl=impl)
        state = create_lm_train_state(model, init_params(model, 1,
                                                         cuda_device))
        step = make_lm_train_step(model, sgd(0.1))
        losses[impl] = [float(step(state, tokens)[1]["loss"])
                        for _ in range(3)]
    assert all(np.isfinite(losses["flash"])), losses
    np.testing.assert_allclose(losses["flash"], losses["xla"],
                               atol=BF16_TRAIN_LOSS_TOL, rtol=0)


def test_flash_wrapper_contract_on_card(cuda_device):
    q, k, v, _ = _flash_inputs(cuda_device, 1, 16, 16, 2, 64,
                               torch.bfloat16)
    with pytest.raises(ValueError, match="CPU tensors only"):
        flash_fwd(q, k, v, impl="torch")
    with pytest.raises(ValueError, match="head_dim stride"):
        flash_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    wide = torch.zeros(1, 16, 2, 160, dtype=q.dtype, device=cuda_device)
    with pytest.raises(ValueError, match="Dh <= 128"):
        flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="one dtype"):
        flash_fwd(q, k.float(), v)
    for dtype in (torch.bfloat16, torch.float32):
        flat = torch.zeros(16 * 2 * 64 + 1, dtype=dtype, device=cuda_device)
        unaligned = flat[1:].view(1, 16, 2, 64)  # rows off 16-byte alignment
        with pytest.raises(ValueError, match="aligned"):
            flash_fwd(unaligned, k.to(dtype), v.to(dtype))


def test_train_step_flash_matches_xla_on_card(cuda_device):
    """One SGD step of a small GPT on the card through the kernels equals
    the same step through the plain masked softmax (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geom = dict(vocab_size=61, max_seq_len=128, hidden_size=128,
                num_layers=2, num_heads=2, mlp_dim=256)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 61, (4, 97))).to(cuda_device)
    got = {}
    for impl in ("flash", "xla"):
        model = GPT(**geom, attn_impl=impl)
        state = create_lm_train_state(model, init_params(model, 1,
                                                         cuda_device))
        step = make_lm_train_step(model, sgd(0.1))
        losses = [float(step(state, tokens)[1]["loss"]) for _ in range(2)]
        got[impl] = (losses, state.params.clone())
    np.testing.assert_allclose(got["flash"][0], got["xla"][0], atol=1e-5)
    torch.testing.assert_close(got["flash"][1], got["xla"][1], atol=1e-5,
                               rtol=0)


def _sgd_buffers(dev, n, seed, offset=0):
    """(params, grads, buf) views of n elements at ``offset`` elements
    into their storage (an offset that is not a multiple of 4 takes the
    kernel's unaligned path)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(n + offset, generator=gen,
                             device=dev)[offset:] for _ in range(3))


def _sgd_flags(dev, initialized, keep):
    return (torch.tensor(initialized, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.tensor(keep, device=dev))


@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (4, 0), (7, 0),
                                      (1_000_003, 0), (4_903_242, 0),
                                      (1027, 1), (4099, 2)])
def test_fused_sgd_kernel_matches_plain(cuda_device, n, offset, nesterov):
    """Row 8 over 4 steps (the first with init 0, a skipped one with
    keep False) equals the plain version bit for bit, in place."""
    hyper = dict(lr=0.1, momentum=0.9, weight_decay=1e-4,
                 nesterov=nesterov)
    runs = {}
    for name, fn in (("kernel", fused_sgd_), ("plain", torch_fused_sgd_)):
        p, g, b = _sgd_buffers(cuda_device, n, seed=n, offset=offset)
        b.zero_()
        ptrs = (p.data_ptr(), b.data_ptr())
        init, count, _ = _sgd_flags(cuda_device, False, True)
        before = fused_sgd_.launches
        for step, keep in enumerate((True, True, False, True)):
            grads = g * (step + 1) - 0.5
            keep_t = torch.tensor(keep, device=cuda_device)
            if name == "kernel":
                fn(p, grads, b, init, count, keep_t, impl="cuda", **hyper)
            else:
                fn(p, grads, b, init, count, keep_t, **hyper)
        torch.cuda.synchronize()
        assert (p.data_ptr(), b.data_ptr()) == ptrs  # updated in place
        if name == "kernel":
            assert fused_sgd_.launches == before + 4
        runs[name] = (p, b, bool(init), int(count))
    (kp, kb, kinit, kcount), (pp, pb, pinit, pcount) = (runs["kernel"],
                                                        runs["plain"])
    assert torch.equal(kp, pp) and torch.equal(kb, pb)
    assert kinit and pinit and kcount == pcount == 3


def test_fused_sgd_kernel_skip_writes_nothing(cuda_device):
    """keep False: params, momenta and both flags are left as they
    were, NaN grads included (the NaN guard's skip)."""
    p, g, b = _sgd_buffers(cuda_device, 4099, seed=1)
    g[7] = float("nan")
    init, count, keep = _sgd_flags(cuda_device, False, False)
    saved = (p.clone(), b.clone())
    fused_sgd_(p, g, b, init, count, keep, lr=0.1, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(p, saved[0]) and torch.equal(b, saved[1])
    assert not bool(init) and int(count) == 0


def test_fused_sgd_views_see_the_update(cuda_device):
    """The model's parameters are views of the flat buffer: the in-place
    kernel updates them without a copy."""
    flat = torch.randn(10, device=cuda_device)
    view = flat[2:6].view(2, 2)
    grads = torch.ones(10, device=cuda_device)
    buf = torch.zeros(10, device=cuda_device)
    init, count, keep = _sgd_flags(cuda_device, False, True)
    expect = flat[2:6] - 0.5 * (1 + 1e-4 * flat[2:6]) * 1.9
    fused_sgd_(flat, grads, buf, init, count, keep, lr=0.5,
               weight_decay=1e-4, impl="cuda")
    torch.testing.assert_close(view.reshape(-1), expect, atol=1e-6,
                               rtol=0)


def test_fused_sgd_wrapper_contract_on_card(cuda_device):
    p, g, b = _sgd_buffers(cuda_device, 64, seed=2)
    init, count, keep = _sgd_flags(cuda_device, False, True)
    with pytest.raises(ValueError, match="CPU tensors only"):
        fused_sgd_(p, g, b, init, count, keep, lr=0.1, impl="torch")
    with pytest.raises(ValueError, match="flat f32"):
        fused_sgd_(p, g.double(), b, init, count, keep, lr=0.1)
    with pytest.raises(ValueError, match="overlap"):
        fused_sgd_(p, p, b, init, count, keep, lr=0.1)
    with pytest.raises(ValueError, match="int32"):
        fused_sgd_(p, g, b, init, count.long(), keep, lr=0.1)


@pytest.fixture
def deterministic_cudnn():
    """Deterministic cuDNN in f32 (TF32 off), restored after."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _image_run(dev, make, steps, **kw):
    """ResNet-18 on ``steps`` CIFAR-shaped batches of 32 through the
    image step: (losses, state, the fused kernel's launches)."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_resnet)

    gen = torch.Generator(device=dev).manual_seed(7)
    images = torch.randn(steps, 32, 32, 32, 3, generator=gen, device=dev)
    labels = torch.randint(0, 10, (steps, 32), generator=gen, device=dev)
    model = init_resnet(get_model("res"), 3).to(dev)
    opt = make(0.1)
    state = create_train_state(model, opt, ema="ema_decay" in kw)
    step = make_train_step(model, opt, **kw)
    launches = fused_sgd_.launches
    losses = [float(step(state, x, y)[1]["loss"])
              for x, y in zip(images, labels)]
    return losses, state, fused_sgd_.launches - launches


def test_transform_step_sgd_fused_matches_sgd_on_card(cuda_device,
                                                      deterministic_cudnn):
    """Three steps with all four transforms: the fused kernel (one launch
    a step, reading the clipped gradients) gives the plain update's
    bits in params, momenta, BN stats and EMA."""
    kw = dict(grad_accum=2, clip_grad_norm=1.0, ema_decay=0.9, remat=True)
    plain = _image_run(cuda_device, sgd, 3, **kw)
    fused = _image_run(cuda_device, sgd_fused, 3, **kw)
    assert plain[0] == fused[0]
    assert (plain[2], fused[2]) == (0, 3)
    for name in ("params", "momentum", "stats", "ema"):
        assert torch.equal(getattr(plain[1], name),
                           getattr(fused[1], name)), name


def test_remat_is_bit_equal_on_card(cuda_device, deterministic_cudnn):
    """One step with ``remat`` (the forward recomputed in the backward,
    BN's running stats kept from the first forward) against one
    without: params and BN stats bit-equal."""
    plain = _image_run(cuda_device, sgd_fused, 1)
    remat = _image_run(cuda_device, sgd_fused, 1, remat=True)
    assert plain[0] == remat[0]
    for name in ("params", "momentum", "stats"):
        assert torch.equal(getattr(plain[1], name),
                           getattr(remat[1], name)), name


# ring all-reduce: sizes and dtypes cycled through consecutive calls (one
# fixed comm buffer throughout; the flags' sequence numbers run on)
RING_SIZES = ((40, 33), (1,), (3 * 1000 + 7,), (1_000_003,), (70_000,))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_loopback_matches_plain(cuda_device, n):
    """50 consecutive loopback calls, each on fresh inputs, bit-equal to
    the plain version on the card."""
    for call in range(50):
        shape = RING_SIZES[call % len(RING_SIZES)]
        dtype = (torch.float32, torch.bfloat16)[(call // len(RING_SIZES))
                                                % 2]
        gen = torch.Generator(device=cuda_device).manual_seed(call)
        xs = [(torch.randn(shape, generator=gen, device=cuda_device)
               * 1e3).to(dtype) for _ in range(n)]
        before = ring_all_reduce_loopback.launches
        got = ring_all_reduce_loopback(xs, impl="cuda")
        torch.cuda.synchronize()
        assert ring_all_reduce_loopback.launches == before + 1
        want = torch_ring_all_reduce(xs)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype == dtype
            assert torch.equal(g, w), (call, shape, dtype)


def test_ring_wrapper_contract_on_card(cuda_device):
    xs = [torch.ones(8, device=cuda_device) for _ in range(2)]
    with pytest.raises(ValueError, match="CPU tensors only"):
        ring_all_reduce_loopback(xs, impl="torch")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ring_all_reduce(xs[0], impl="torch")
    with pytest.raises(ValueError, match="at most 8"):
        ring_all_reduce_loopback(xs * 5)
    with pytest.raises(ValueError, match="contiguous"):
        launch_loopback_(torch.zeros(2, 1000, device=cuda_device))
    assert ring_all_reduce(xs[0]) is xs[0]  # no process group: a world of 1
    assert ring_all_reduce_loopback(xs[:1])[0] is xs[0]


def test_ring_cross_card_matches_plain(cuda_device, tmp_path):
    """min(cards, 4) ranks, one per card over NCCL: 50 consecutive calls
    of the kernel over peer memory, each bit-equal to the plain version
    of every rank's inputs."""
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    from torch_image_worker import spawn_ranks
    from torch_ring_worker import ring_cuda_rank

    spawn_ranks(ring_cuda_rank, world, (50, str(tmp_path)), timeout_s=300)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        # 50 calls, then one of 64 MiB; one comm buffer throughout, and a
        # contiguous f32 call is one kernel and nothing else on the card
        assert (got["mismatches"], got["worst"], got["launches"]) == (0, 0.0,
                                                                      51)
        assert got["buffers"] == 1 and got["kernels"] == ["ring_kernel"]


def _ring_inputs(dev, n, shape, seed, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(shape, generator=gen, device=dev) * 1e3).to(dtype)
            for _ in range(n)]


def _assert_ring_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.fixture
def ring_blocks():
    """Restores the ring's block count after a test that sets it."""
    saved = ring_module.RING_BLOCKS
    yield
    ring_module.RING_BLOCKS = saved


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_loopback_small_block_count(cuda_device, ring_blocks, n,
                                         blocks):
    """A forced small G: every block takes many steps a hop; the sum
    order does not depend on G, so the bits do not move."""
    ring_module.RING_BLOCKS = blocks
    for call, shape in enumerate(RING_SIZES):
        xs = _ring_inputs(cuda_device, n, shape, seed=call)
        got = ring_all_reduce_loopback(xs, impl="cuda")
        _assert_ring_bits(got, torch_ring_all_reduce(xs))
    plan = ring_module.loopback_plan(1_000_003, n, cuda_device)
    assert plan.blocks <= blocks and plan.steps > 1


@pytest.mark.parametrize("size", [1024, 16 * 2 ** 20])
def test_ring_loopback_4kib_and_64mib(cuda_device, size):
    xs = _ring_inputs(cuda_device, 4, (size,), seed=size)
    _assert_ring_bits(ring_all_reduce_loopback(xs, impl="cuda"),
                      torch_ring_all_reduce(xs))


@pytest.mark.parametrize("layout", ["non_contiguous", "misaligned", "bf16",
                                    "in_place"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_loopback_views_and_dtypes(cuda_device, n, layout):
    """Views the kernel cannot read in place are copied into one f32
    payload first (the kernel still runs); ``launch_loopback_`` reduces
    a ``[n, padded]`` buffer in place."""
    if layout == "non_contiguous":
        xs = [x[:, 1:] for x in _ring_inputs(cuda_device, n, (3, 5001), 1)]
    elif layout == "misaligned":  # storage offset 1: not 16-byte aligned
        xs = [x[1:] for x in _ring_inputs(cuda_device, n, (70_001,), 2)]
    elif layout == "bf16":
        xs = _ring_inputs(cuda_device, n, (70_000,), 3, torch.bfloat16)
    else:
        padded = ring_layout(70_000, n)[2]
        work = torch.zeros(n, padded, device=cuda_device)
        for r, x in enumerate(_ring_inputs(cuda_device, n, (70_000,), 4)):
            work[r, :70_000] = x
        want = torch_ring_all_reduce(list(work))
        before = ring_all_reduce_loopback.launches
        launch_loopback_(work)
        assert ring_all_reduce_loopback.launches == before + 1
        _assert_ring_bits(list(work), want)
        return
    before = ring_all_reduce_loopback.launches
    got = ring_all_reduce_loopback(xs, impl="cuda")
    assert ring_all_reduce_loopback.launches == before + 1
    _assert_ring_bits(got, torch_ring_all_reduce(xs))


def test_ring_loopback_comm_buffer_is_allocated_once(cuda_device):
    """Alternating large and small payloads reuse one fixed comm buffer
    per (card, n), of the size the kernel's own layout gives."""
    ring_all_reduce_loopback(_ring_inputs(cuda_device, 4, (8,), 0))
    state = ring_module._loopback_state(cuda_device, 4)
    ptr, nbytes = state.comm.data_ptr(), state.comm.numel()
    _, _, slot, slots, _ = state.config
    lib = ring_module._lib()
    assert lib.pmdt_ring_comm_bytes(state.blocks, slots, slot) \
        == ring_comm_bytes(state.blocks, slots, slot)
    assert nbytes == 4 * state.stride >= 4 * ring_comm_bytes(
        state.blocks, slots, slot)
    for call, size in enumerate((16 * 2 ** 20, 1, 4_903_242, 1024,
                                 16 * 2 ** 20, 3007)):
        xs = _ring_inputs(cuda_device, 4, (size,), seed=call)
        _assert_ring_bits(ring_all_reduce_loopback(xs, impl="cuda"),
                          torch_ring_all_reduce(xs))
        again = ring_module._loopback_state(cuda_device, 4)
        assert again is state and again.comm.data_ptr() == ptr


def test_ring_contiguous_f32_call_is_one_kernel(cuda_device):
    """No pad, no copy: a contiguous f32 call is one launch of the ring
    kernel and no other work on the card (``torch.profiler``)."""
    xs = _ring_inputs(cuda_device, 4, (4_903_242,), seed=5)
    ring_all_reduce_loopback(xs)  # warm: buffers and the library
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ring_all_reduce_loopback(xs)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "ring_loopback_kernel" in on_card[0], \
        on_card


# head_dims off the kernels' 32/64/128 tiles: 16 and 48 (a smaller tile's
# part), 96 (past 64), and 20, which is no whole 16-byte row in bf16 or
# int8 (the wrappers zero-pad those to the tile) but is in f32
ODD_HEAD_DIMS = (16, 20, 48, 96)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_flash_kernels_take_any_head_dim(cuda_device, dtype, d):
    """Rows 5-7 at a head_dim that is not a tile, causal and not, on the
    fused-QKV strided views: each wrapper launches its kernel once and
    matches the plain version within the tolerances of the tile sizes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = FLASH_TOL[dtype]
    for sq, skv, causal in ((197, 197, True), (130, 70, False)):
        q, k, v, do = _flash_inputs(cuda_device, 2, sq, skv, 3, d, dtype)
        scale = d ** -0.5
        before = (flash_fwd.launches, flash_bwd_dq.launches,
                  flash_bwd_dkv.launches)
        out, lse = flash_fwd(q, k, v, causal=causal)
        ref_out, ref_lse = torch_flash_fwd(q, k, v, scale=scale,
                                           causal=causal)
        assert out.shape == q.shape and out.is_contiguous()
        torch.testing.assert_close(out.float(), ref_out.float(),
                                   atol=tol["out"], rtol=tol["out"])
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
        dterm = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
        dterm = dterm.contiguous()
        dq, dk, dv = flash_pair_grads(q, k, v, do, ref_lse, dterm,
                                      scale=scale, causal=causal)
        torch.cuda.synchronize()
        ref_dq = torch_flash_bwd_dq(q, k, v, do, ref_lse, dterm,
                                    scale=scale, causal=causal)
        ref_dk, ref_dv = torch_flash_bwd_dkv(q, k, v, do, ref_lse, dterm,
                                             scale=scale, causal=causal)
        for got, ref, name in ((dq, ref_dq, "dq"), (dk, ref_dk, "dk"),
                               (dv, ref_dv, "dv")):
            assert got.shape == ref.shape, name
            torch.testing.assert_close(got.float(), ref.float(),
                                       atol=tol["grad"], rtol=tol["grad"],
                                       msg=name)
        assert (flash_fwd.launches, flash_bwd_dq.launches,
                flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_decode_kernels_take_any_head_dim(cuda_device, quant, dtype, d):
    """Rows 1-4 (and 1q-4q) at a head_dim that is not a tile: dense and
    paged decode over one split and over several, dense and paged verify
    at K1 = 5; each wrapper launches its kernel once and matches the
    plain version within 1e-4."""
    name = "int8_launches" if quant else "launches"

    def check(fn, ref, *args, **kw):
        before = getattr(fn, name)
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(fn, name) == before + 1
        assert got.shape[-1] == d and got.is_contiguous()
        torch.testing.assert_close(got, ref(*args, **kw), atol=1e-4,
                                   rtol=0)

    for w in (40, 264):
        q, k, v, pos = _inputs(cuda_device, 3, w + 16, 2, d, dtype,
                               [0, w - 1, w + 5], seed=d)
        if quant:
            kq, vq = quantize_kv(k.float() * 3), quantize_kv(v.float())
            kw = QuantizedKV(kq.data[:, :w], kq.scale[:, :w])
            vw = QuantizedKV(vq.data[:, :w], vq.scale[:, :w])
        else:
            kw, vw = k[:, :w], v[:, :w]
        check(decode_attention, torch_decode_attention, q, kw, vw, pos)
        vq_ = _verify_q(cuda_device, 3, 5, 2, d, dtype, seed=d + 1)
        vpos = torch.tensor([0, w - 5, w - 2], dtype=torch.int32,
                            device=cuda_device)
        check(verify_decode_attention, torch_verify_decode_attention, vq_,
              kw, vw, vpos)
    ps, n_win = 16, 20
    positions = [0, 100, n_win * ps + 3]
    q, k, v, table, pos = _paged(cuda_device, 3, 2, d, ps, n_win, dtype,
                                 quant, positions, seed=d)
    check(paged_decode_attention, torch_paged_decode_attention, q, k, v,
          table, pos)
    vq_ = _verify_q(cuda_device, 3, 5, 2, d, dtype, seed=d + 2)
    reach = [min(p + 4, n_win * ps - 1) for p in positions]
    _, k, v, table, _ = _paged(cuda_device, 3, 2, d, ps, n_win, dtype,
                               quant, reach, seed=d + 3)
    check(paged_verify_decode_attention, torch_paged_verify_decode_attention,
          vq_, k, v, table, pos)


# ---- the GSPMD placements (--zero1, --fsdp) on the card ----


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_gspmd_one_card_grid_is_the_plain_step(cuda_device, optimizer):
    """A 1 x 1 grid on one card: two steps of ResNet-18 under ``--zero1``
    and under ``--fsdp`` give the plain step's bits (params, BN stats,
    moments)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        reset_grid)
    from torch_image_worker import gspmd_card_steps

    try:
        got = gspmd_card_steps(1, cuda_device, ("plain", "zero1", "fsdp"),
                               steps=2, optimizer=optimizer)
    finally:
        reset_grid()
    for mode in ("zero1", "fsdp"):
        for k, v in got["plain"].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[mode][k], v), (mode, k)


def test_gspmd_fsdp_two_cards_matches_plain(cuda_device, tmp_path):
    """``--fsdp`` at (2, 1) over NCCL, one rank a card: after one step
    within 1e-5 of the plain data-parallel step (the reductions' order
    only)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from torch_image_worker import gspmd_cuda_rank, spawn_ranks

    spawn_ranks(gspmd_cuda_rank, 2, (str(tmp_path),), timeout_s=300)
    got = torch.load(tmp_path / "payloads.pt", weights_only=True)
    for k, v in got["plain"].items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(got["fsdp"][k], v, atol=1e-5, rtol=0,
                                       msg=k)


# ---- sequence parallelism (train_lm --parallel sp) on the card ----

SP_GEOM = dict(vocab_size=257, max_seq_len=256, hidden_size=128,
               num_layers=2, num_heads=4, mlp_dim=256)


def _sp_step(dtype, mode, tokens):
    """One step of a 2-layer GPT (plain DP for ``mode`` None, else the SP
    step on the 1 x 1 grid in place): loss, params, flash launches."""
    kw = {} if mode is None else dict(seq_axis="seq", sp_mode=mode)
    model = GPT(**SP_GEOM, dtype=dtype, **kw)
    state = create_lm_train_state(model, init_params(model, 0, "cuda"))
    step = make_lm_train_step(model, sgd(0.01), seq_axis=kw.get("seq_axis"))
    before = {n: getattr(flash_mod, n).launches
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    _, m = step(state, tokens)
    launches = {n: getattr(flash_mod, n).launches - c
                for n, c in before.items()}
    return float(m["loss"]), state.params.clone(), launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["ring", "zigzag", "ulysses"])
def test_sp_degree_one_matches_plain_step(cuda_device, mode, dtype):
    """A 1 x 1 ``(data, seq)`` grid on one card: one SP step from the
    plain DP step's params. Ring and ulysses fold one block with weight 1
    and give the plain step's bits; zigzag folds two halves a row (f32
    within 1e-6 in params, bf16 within 1e-4); the flash kernels launch
    per layer as the hop schedule says (1, 3, 1 each)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)

    tokens = torch.randint(0, 257, (2, 128),
                           generator=torch.Generator().manual_seed(0)
                           ).to(cuda_device)
    make_grid(1, 1, axis="seq")
    try:
        loss0, p0, _ = _sp_step(dtype, None, tokens)
        loss, p, launches = _sp_step(dtype, mode, tokens)
    finally:
        reset_grid()
    per_layer = 3 if mode == "zigzag" else 1
    assert launches == {n: 2 * per_layer for n in launches}
    if mode == "zigzag":
        tol = 1e-6 if dtype == torch.float32 else 1e-4
        assert float((p - p0).abs().max()) <= tol
        assert abs(loss - loss0) <= 100 * tol
    else:
        assert loss == loss0 and torch.equal(p, p0)


def test_sp_attention_two_cards_matches_dense(cuda_device, tmp_path):
    """Ring (causal and not), zigzag and ulysses at degree 2 over NCCL,
    one rank a card, against the flash kernels on the whole sequence:
    f32 within 2e-5 (the fold's and the gradient sums' order), bf16
    within 4e-2 (bf16 outputs of each hop and of the whole)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from torch_image_worker import spawn_ranks
    from torch_sp_worker import card_attention_rank

    spawn_ranks(card_attention_rank, 2, (str(tmp_path),), timeout_s=300)
    for rank in range(2):
        errs = torch.load(tmp_path / f"{rank}.pt", weights_only=True)
        for case, vals in errs.items():
            tol = 2e-5 if case.endswith("float32") else 4e-2
            assert max(vals) <= tol, (rank, case, vals)


# ---- pipeline and tensor parallelism (train_lm --parallel pp|tp) ----

MP_RUNS = {"pp_gpipe": {"kind": "pp", "schedule": "gpipe"},
           "pp_1f1b": {"kind": "pp", "schedule": "1f1b"},
           "tp": {"kind": "tp"}, "tp_zero1": {"kind": "tp", "zero1": True},
           "tp_fsdp": {"kind": "tp", "fsdp": True},
           "dp_zero": {"kind": "dp", "zero": True},
           "dp_remat": {"kind": "dp", "remat": True}}


def _mp_step(dtype, run, tokens):
    """One step of a 2-layer GPT under ``run`` on a 1 x 1 grid in this
    process: loss, whole params, flash launches."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        reset_grid)
    from torch_mp_worker import _dense, _state

    model = GPT(**SP_GEOM, dtype=dtype)
    before = {n: getattr(flash_mod, n).launches
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    try:
        state, step, _ = _state(dict(run, lr=0.01), model,
                                init_params(model, 0, "cuda"), (1, 1), 0)
        _, m = step(state, tokens)
        whole = _dense(state, run["kind"], model.vocab_size)
    finally:
        reset_grid()
    launches = {n: getattr(flash_mod, n).launches - c
                for n, c in before.items()}
    return float(m["loss"]), whole, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mp_degree_one_matches_plain_step(cuda_device, dtype):
    """pp (gpipe, 1f1b), tp (plain, --zero1, --fsdp), --zero and
    --remat at degree 1 on one card against the plain DP step from the
    same params: tp, --zero and --remat give its bits; pp within 1e-5
    (f32) or 1e-3 (bf16) in params after one step (its final LayerNorm's
    two-pass variance, its vocab-parallel CE and, in bf16, the embedding
    rounded after the position add). The flash kernels launch once a
    layer (the forward twice under 1f1b and remat)."""
    from torch_mp_worker import card_tokens

    tokens = card_tokens().to(cuda_device)
    loss0, p0, launches0 = _mp_step(dtype, {"kind": "dp"}, tokens)
    assert launches0 == {n: 2 for n in launches0}
    for name, run in MP_RUNS.items():
        loss, p, launches = _mp_step(dtype, run, tokens)
        twice = name in ("pp_1f1b", "dp_remat")
        assert launches == {"flash_fwd": 4 if twice else 2,
                            "flash_bwd_dq": 2, "flash_bwd_dkv": 2}, name
        err = max(float((p[k] - p0[k]).abs().max()) for k in p0)
        if run["kind"] == "pp":
            tol = 1e-5 if dtype == torch.float32 else 1e-3
            assert err <= tol and abs(loss - loss0) <= 20 * tol, (name, err)
        else:
            assert loss == loss0 and err == 0.0, (name, err)


def test_mp_two_cards_match_one_card(cuda_device, tmp_path):
    """pp (gpipe, 1f1b) and tp at degree 2 over NCCL, one rank a card,
    against the plain DP step on one card: f32 params within 1e-5 after
    one step, losses within 1e-5."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from torch_image_worker import spawn_ranks
    from torch_mp_worker import card_mp_rank, card_tokens

    loss0, p0, _ = _mp_step(torch.float32, {"kind": "dp"},
                            card_tokens().to(cuda_device))
    spawn_ranks(card_mp_rank, 2, (SP_GEOM, str(tmp_path)), timeout_s=300)
    got = torch.load(tmp_path / "mp.pt", weights_only=True)
    assert set(got) == {"pp_gpipe", "pp_1f1b", "tp"}
    for name, (loss, p) in got.items():
        assert abs(loss - loss0) <= 1e-5, name
        for k, v in p0.items():
            torch.testing.assert_close(p[k], v.cpu(), atol=1e-5, rtol=0,
                                       msg=f"{name} {k}")
