"""The port's flash attention on the CPU (its plain versions under the
autograd Function) against the JAX package's Pallas flash attention,
run in interpret mode on the CPU as ``tests/test_pallas_kernels.py``
runs it, on the same numpy inputs.

Tolerances are the JAX suite's own: output and lse within 2e-5 and
dq/dk/dv within 2e-4 in f32 (two frameworks' f32 sums in different
orders). With bf16 I/O within 3e-2: the Pallas kernel rounds P to bf16
before P.V and the port keeps it in f32, so the two differ by about one
bf16 rounding of the probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops.pallas import (
    flash_attention as jax_flash_attention)
from pytorch_multiprocessing_distributed_tpu.ops.pallas.flash_attention \
    import _flash_fwd, _flash_pair_grads
from pytorch_multiprocessing_distributed_tpu_torch.ops import (
    flash_attention, flash_fwd, flash_pair_grads, resolve_impl)
from pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention \
    import flash_bwd_dkv, flash_bwd_dq

F32 = dict(out=2e-5, grad=2e-4)


def _inputs(seed, b, sq, skv, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, h, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, h, d)).astype(np.float32)
    ct = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, ct


def _port_grads(q, k, v, ct, causal, dtype=torch.float32):
    qt, kt, vt = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    # the JAX suite's nontrivial cotangent: sum(o * cos(o)) times ct
    loss = (out.float() * torch.cos(out.float()) * torch.from_numpy(ct)
            ).sum()
    grads = torch.autograd.grad(loss, (qt, kt, vt))
    return out, grads


def _jax_grads(q, k, v, ct, causal, block, dtype=jnp.float32):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=block,
                                block_k=block).astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o) * ct)

    args = tuple(jnp.asarray(x, dtype) for x in (q, k, v))
    out = jax_flash_attention(*args, causal=causal, block_q=block,
                              block_k=block)
    return out, jax.grad(loss, argnums=(0, 1, 2))(*args)


@pytest.mark.parametrize("sq,skv,causal", [(197, 197, True),
                                           (197, 197, False),
                                           (64, 128, False),
                                           (13, 13, True)])
def test_output_and_grads_match_jax(sq, skv, causal):
    """Causal and not, S=197 (no block multiple: padded rows in JAX),
    Skv != Sq, a tiny odd length."""
    q, k, v, ct = _inputs(sq + skv, 2, sq, skv, 2, 32)
    out, grads = _port_grads(q, k, v, ct, causal)
    ref_out, ref_grads = _jax_grads(q, k, v, ct, causal, block=64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=F32["out"], rtol=F32["out"])
    for got, ref, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32["grad"], rtol=F32["grad"],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax_flash_fwd(causal):
    q, k, v, _ = _inputs(3, 2, 197, 197, 3, 64)
    out, lse = flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal)

    def merge(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(
            -1, x.shape[1], x.shape[3])

    ref_out, ref_lse = _flash_fwd(merge(q), merge(k), merge(v),
                                  64 ** -0.5, causal, 64, 64, True)
    np.testing.assert_allclose(lse.reshape(-1, 197).numpy(),
                               np.asarray(ref_lse), atol=F32["out"],
                               rtol=F32["out"])
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(-1, 197, 64).numpy(),
        np.asarray(ref_out), atol=F32["out"], rtol=F32["out"])


@pytest.mark.parametrize("causal", [False, True])
def test_pair_grads_with_external_lse_match_jax(causal):
    """The pair-grads entry with an EXTERNAL lse and D (what ring
    attention passes per hop) against ``_flash_pair_grads``. The lse here
    is not this pair's own (a shifted global one), as on a ring hop."""
    rng = np.random.default_rng(11)
    bh, sq, skv, d = 3, 70, 70 if causal else 45, 32
    q3, do = (rng.normal(size=(bh, sq, d)).astype(np.float32)
              for _ in range(2))
    k3, v3 = (rng.normal(size=(bh, skv, d)).astype(np.float32)
              for _ in range(2))
    lse = rng.normal(size=(bh, sq)).astype(np.float32) + 4.0
    dterm = rng.normal(size=(bh, sq)).astype(np.float32)
    scale = d ** -0.5
    ref = _flash_pair_grads(*(jnp.asarray(x) for x in
                              (q3, k3, v3, do, lse, dterm)),
                            scale=scale, causal=causal, block_q=32,
                            block_k=32, interpret=True)
    # [bh, S, d] is the port's [B, S, H, Dh] with H = 1
    got = flash_pair_grads(
        *(torch.from_numpy(x).unsqueeze(2) for x in (q3, k3, v3, do)),
        torch.from_numpy(lse)[:, None], torch.from_numpy(dterm)[:, None],
        scale=scale, causal=causal)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g[:, :, 0].numpy(), np.asarray(r),
                                   atol=F32["grad"], rtol=F32["grad"],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [127, 128, 129, 255])
def test_pair_grads_on_fused_qkv_views_match_jax(s, d, causal):
    """The contract the bf16 kernels implement, on the layout the model
    hands them: q/k/v are [B, S, H, Dh] views of one fused projection
    (row stride 3*H*Dh), with an EXTERNAL lse and dterm (a shifted one,
    not the pair's own, as on a ring hop), at lengths that straddle the
    kernels' 64- and 128-row tiles; against ``_flash_pair_grads``."""
    rng = np.random.default_rng(s * 1000 + d * 2 + causal)
    b, h = 1, 2
    fused = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    lse = rng.normal(size=(b, h, s)).astype(np.float32) + 4.0
    dterm = rng.normal(size=(b, h, s)).astype(np.float32)
    ft = torch.from_numpy(fused)
    q, k, v = (ft[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    scale = d ** -0.5
    got = flash_pair_grads(q, k, v, torch.from_numpy(do),
                           torch.from_numpy(lse), torch.from_numpy(dterm),
                           scale=scale, causal=causal)

    def merge(x):  # [B, S, H, Dh] -> the JAX [B*H, S, Dh]
        return jnp.asarray(np.moveaxis(np.ascontiguousarray(x), 2, 1)
                           .reshape(b * h, s, d))

    ref = _flash_pair_grads(*(merge(x.numpy()) for x in (q, k, v)),
                            merge(do), jnp.asarray(lse.reshape(b * h, s)),
                            jnp.asarray(dterm.reshape(b * h, s)),
                            scale=scale, causal=causal, block_q=64,
                            block_k=64, interpret=True)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(
            g.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(),
            np.asarray(r), atol=F32["grad"], rtol=F32["grad"],
            err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [127, 128, 129, 255])
def test_fwd_on_fused_qkv_views_match_jax(s, d, causal):
    """The forward's contract on the layout the bf16 kernel reads: q/k/v
    are [B, S, H, Dh] views of one fused projection (row stride 3*H*Dh),
    at lengths that straddle the kernel's 64-row tiles; output and lse
    against ``_flash_fwd`` in interpret mode."""
    rng = np.random.default_rng(s * 1000 + d * 2 + causal + 7)
    b, h = 1, 2
    fused = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    ft = torch.from_numpy(fused)
    q, k, v = (ft[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    scale = d ** -0.5
    out, lse = flash_fwd(q, k, v, scale=scale, causal=causal)
    assert out.shape == (b, s, h, d) and lse.shape == (b, h, s)

    def merge(x):  # [B, S, H, Dh] -> the JAX [B*H, S, Dh]
        return jnp.asarray(np.moveaxis(np.ascontiguousarray(x), 2, 1)
                           .reshape(b * h, s, d))

    ref_out, ref_lse = _flash_fwd(*(merge(x.numpy()) for x in (q, k, v)),
                                  scale, causal, 64, 64, True)
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(),
        np.asarray(ref_out), atol=F32["out"], rtol=F32["out"])
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(),
                               np.asarray(ref_lse), atol=F32["out"],
                               rtol=F32["out"])


def test_bf16_io_matches_jax():
    q, k, v, ct = _inputs(5, 1, 128, 128, 2, 64)
    out, grads = _port_grads(q, k, v, ct, True, dtype=torch.bfloat16)
    ref_out, ref_grads = _jax_grads(q, k, v, ct, True, block=64,
                                    dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref_out, np.float32),
                               atol=3e-2, rtol=3e-2)
    for got, ref, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=3e-2,
                                   rtol=3e-2, err_msg=f"d{name}")


def test_wrapper_contract_on_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(0, 1, 8, 8, 1, 32))
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    flash_attention(q.requires_grad_(), k, v, causal=True).sum().backward()
    # the plain versions ran: no kernel launched
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q, k[:, :4], v[:, :4], causal=True)
    with pytest.raises(ValueError, match="k.shape == v.shape"):
        flash_attention(q, k, v[:, :4])
    assert resolve_impl("auto", q) == "torch"
