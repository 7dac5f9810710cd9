"""The attention wrappers' head_dim routing on the CPU (jax-free).

On the card the kernels take any ``1 <= Dh <= 128``: they run on the tile
of 32, 64 or 128 columns that holds Dh, reading zeros past it where a
row of Dh is whole 16-byte pieces, or on inputs the wrapper zero-pads to
the tile. Both rest on the same algebra, pinned here with the plain
versions: zero columns of q and k add nothing to ``q . k``, zero columns
of v give zero output columns, and the scale stays ``Dh ** -0.5`` of the
true Dh, so the padded computation sliced back equals the computation
at Dh (within f32 rounding, 1e-6). ``auto`` on a CPU tensor still takes
the plain version at the true Dh and launches nothing."""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.ops import (
    head_dim_tile, kernel_head_dim, pad_head_dim)
from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
    import (_pad_kv, decode_attention, torch_decode_attention,
            torch_verify_decode_attention, verify_decode_attention)
from pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention \
    import (flash_attention, flash_fwd, torch_flash_bwd_dkv,
            torch_flash_bwd_dq, torch_flash_fwd)
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    quantize_kv)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tiles_and_widths():
    assert [head_dim_tile(d) for d in (1, 16, 32, 33, 64, 65, 96, 128)] == \
        [32, 32, 32, 64, 64, 128, 128, 128]
    for bad in (0, 129, 160):
        with pytest.raises(ValueError, match="Dh <= 128"):
            head_dim_tile(bad)
    # (head_dim, element bytes) -> the width the kernels are given
    cases = {(16, 2): 16, (20, 2): 32, (48, 2): 48, (96, 2): 96,
             (20, 4): 20, (22, 4): 32, (112, 4): 112, (16, 1): 16,
             (20, 1): 32, (48, 1): 48, (4, 4): 4, (3, 2): 32}
    for (d, elt), want in cases.items():
        assert kernel_head_dim(d, elt) == want, (d, elt)


def _qkv(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d),
                      (b, sq, h, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 20, 96])
def test_flash_padded_to_the_tile_and_sliced_equals_true_dh(d, causal):
    q, k, v, do = _qkv(2, 33, 33, 3, d, seed=d)
    tile = head_dim_tile(d)
    scale = d ** -0.5
    qp, kp, vp, dop = (pad_head_dim(t, tile) for t in (q, k, v, do))
    assert qp.shape[-1] == tile and torch.all(qp[..., d:] == 0)
    out, lse = torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    outp, lsep = torch_flash_fwd(qp, kp, vp, scale=scale, causal=causal)
    torch.testing.assert_close(outp[..., :d], out, atol=TOL, rtol=0)
    torch.testing.assert_close(lsep, lse, atol=TOL, rtol=0)
    assert torch.all(outp[..., d:] == 0)
    dterm = (do * out).sum(-1).transpose(1, 2).contiguous()
    kw = dict(scale=scale, causal=causal)
    dq = torch_flash_bwd_dq(q, k, v, do, lse, dterm, **kw)
    dqp = torch_flash_bwd_dq(qp, kp, vp, dop, lse, dterm, **kw)
    torch.testing.assert_close(dqp[..., :d], dq, atol=TOL, rtol=0)
    dk, dv = torch_flash_bwd_dkv(q, k, v, do, lse, dterm, **kw)
    dkp, dvp = torch_flash_bwd_dkv(qp, kp, vp, dop, lse, dterm, **kw)
    torch.testing.assert_close(dkp[..., :d], dk, atol=TOL, rtol=0)
    torch.testing.assert_close(dvp[..., :d], dv, atol=TOL, rtol=0)


def _scaled_decode(q, k, v, positions, scale, k1=1):
    """The decode and verify math with an explicit scale (the kernels'
    argument): row i of slot b attends ``[0, positions[b] + i]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    cols = torch.arange(k.shape[1])
    rows = torch.arange(k1)
    mask = (cols[None, None, :]
            <= (positions.long()[:, None] + rows[None, :])[..., None])
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [16, 20, 96])
def test_decode_padded_to_the_tile_and_sliced_equals_true_dh(d, quant):
    rng = np.random.default_rng(d)
    b, w, h, k1 = 3, 40, 2, 5
    q = torch.from_numpy(rng.normal(size=(b, k1, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, w, h, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, w, h, d)).astype(np.float32))
    pos = torch.tensor([0, 17, w - 2], dtype=torch.int32)
    tile = head_dim_tile(d)
    qp = pad_head_dim(q, tile)
    if quant:  # the wrapper pads the int8 data; the scales stay
        kq, vq = quantize_kv(k), quantize_kv(v)
        k, v = (t.data.float() * t.scale[..., None] for t in (kq, vq))
        kp, vp = (_pad_kv(t, tile) for t in (kq, vq))
        assert kp.shape[-1] == tile and torch.equal(kp.scale, kq.scale)
        kp, vp = (t.data.float() * t.scale[..., None] for t in (kp, vp))
    else:
        kp, vp = (pad_head_dim(t, tile) for t in (k, v))
    want = torch_verify_decode_attention(q, k, v, pos)
    got = _scaled_decode(qp, kp, vp, pos, d ** -0.5, k1)
    torch.testing.assert_close(got[..., :d], want, atol=TOL, rtol=0)
    assert torch.all(got[..., d:] == 0)
    one = _scaled_decode(qp[:, :1], kp, vp, pos, d ** -0.5)
    torch.testing.assert_close(
        one[..., :d], torch_decode_attention(q[:, :1], k, v, pos),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [16, 20, 96])
def test_auto_on_a_cpu_tensor_takes_the_plain_version(d):
    """No padding and no launch on the CPU: ``auto`` runs the plain
    version at the true Dh, for any Dh the kernels take."""
    q, k, v, do = _qkv(1, 9, 9, 2, d, seed=d)
    before = (flash_fwd.launches, decode_attention.launches,
              verify_decode_attention.launches)
    out, lse = flash_fwd(q, k, v, causal=True)
    ref, ref_lse = torch_flash_fwd(q, k, v, scale=d ** -0.5, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    qg = q.clone().requires_grad_()
    flash_attention(qg, k, v, causal=True).sum().backward()
    assert qg.grad.shape == q.shape
    pos = torch.tensor([3], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, :1], k, v, pos),
                       torch_decode_attention(q[:, :1], k, v, pos))
    assert torch.equal(verify_decode_attention(q[:, :4], k, v, pos),
                       torch_verify_decode_attention(q[:, :4], k, v, pos))
    assert (flash_fwd.launches, decode_attention.launches,
            verify_decode_attention.launches) == before
