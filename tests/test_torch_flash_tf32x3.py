"""The arithmetic of the f32 flash kernels, emulated on the CPU.

On the card the f32 flash kernels (``flash_fwd_tf32x3_kernel``,
``flash_bwd_dq_tf32x3_kernel`` and ``flash_bwd_dkv_tf32x3_kernel`` in
``ops/csrc/flash_attention.cu``) run every product on the tensor cores
as 3xTF32: each f32 operand x becomes hi = tf32(x) and lo = tf32(x -
hi), rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``:
10 mantissa bits), and a product is A_hi B_lo + A_lo B_hi + A_hi B_hi
summed in f32; the A_lo B_lo term is dropped. A TF32 x TF32 product is
exact in f32, so torch's f32 matmul of TF32-valued tensors on the CPU
reproduces a TF32 product with f32 sums.

This file emulates that arithmetic (the rounding by bit operations) and
runs the kernels' algorithms through it on numpy inputs from a seed: 2
heads, S 129 and 255 (a ragged last tile), Dh 32 and 64, causal and not,
and for the forward also Dh 128, Skv < Sq (97 x 33, 97 x 32), S 1 and
33, and a negative and a zero scale. The forward is emulated as the
kernel computes it: each warpgroup's 64 query rows run every key in
tiles of 64 (16 at Dh 128), the online softmax in the log2 domain
(``exp2(s c - m)``, c = |scale| log2 e, the logits flipped for a
negative scale), P split into hi and lo for P V. It shows that

- 3xTF32 stays within the f32 tolerances (forward: out and lse 1e-4;
  grads 5e-4; ``FLASH_TOL`` of the card tests and ``chip_smoke.py``) of
  the JAX package's ``_flash_fwd`` and ``_flash_pair_grads`` in
  interpret mode (skipped where jax is missing);
- a single TF32 product is at least 20x further from a float64
  reference than 3xTF32 on the same inputs: the reason for three
  products. Both errors are printed (``pytest -s``).
"""

import functools

import numpy as np
import pytest
import torch

CASES = [(s, d, causal) for s in (129, 255) for d in (32, 64)
         for causal in (False, True)]
HEADS = 2
GRAD_TOL = 5e-4  # FLASH_TOL["float32"]["grad"] of the card checks
OUT_TOL = 1e-4  # FLASH_TOL["float32"]["out"], and the lse's
RATIO = 20  # a single TF32 product's error over 3xTF32's, at least
# the forward: (Sq, Skv, Dh, causal, scale; None: Dh ** -0.5)
FWD_CASES = ([(s, s, d, causal, None) for s in (129, 255) for d in (32, 64)
              for causal in (False, True)]
             + [(129, 129, 128, causal, None) for causal in (False, True)]
             + [(97, 33, 64, False, None), (97, 33, 32, False, None),
                (97, 32, 64, False, None), (1, 1, 64, True, None),
                (33, 33, 32, True, None),
                (129, 129, 64, False, -0.3), (129, 129, 64, True, 0.0)])
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (``cvt.rna``):
    add half the 13 dropped bits to the magnitude, then clear them (the
    sign bit is untouched: f32 is sign and magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3x(a, b):
    """a @ b as the kernels compute it: three TF32 products, f32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def mm_1x(a, b):
    """a @ b as one TF32 product with f32 sums."""
    return tf32(a) @ tf32(b)


def mm_f64(a, b):
    return a.double() @ b.double()


def pair_grads(q, k, v, do, lse, dterm, scale, causal, mm):
    """(dq, dk, dv) of one [BH, S, D] pair from an external lse and dterm
    ``[BH, S]``, every product through ``mm``: P = exp(scale Q K^T - lse)
    (zero where masked), dS = P o (dO V^T - dterm), dq = scale dS K, dk =
    scale dS^T Q, dv = P^T dO."""
    s_q, s_k = q.shape[1], k.shape[1]
    live = torch.ones(s_q, s_k, dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    s = mm(q, k.transpose(1, 2))
    p = torch.where(live, torch.exp(s * scale - lse[..., None]),
                    torch.zeros((), dtype=s.dtype))
    ds = p * (mm(do, v.transpose(1, 2)) - dterm[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale,
            mm(p.transpose(1, 2), do))


def fwd_emulated(q, k, v, scale, causal, mm):
    """``(out [BH, Sq, D], lse [BH, Sq])`` as ``flash_fwd_tf32x3_kernel``
    computes them in f32: tiles of 64 keys (16 at Dh 128); per tile S =
    mm(Q, K^T), flipped for a negative scale, masked to -inf, the running
    max m raised to max(s) c (log2 domain, c = max(|scale| log2 e,
    1e-30)), P = exp2(s c - m) (0 while a row has no live key), l = l
    corr + sum(P), O = O corr + mm(P, V); then O / l and lse = m / log2 e
    + ln l. Rows are independent, so the CTA's split of the rows between
    its warpgroups does not show here."""
    s_q, s_k, d = q.shape[1], k.shape[1], q.shape[2]
    n = 16 if d == 128 else 64
    c = torch.tensor(max(abs(scale) * LOG2E, 1e-30), dtype=torch.float32)
    neg_inf = torch.tensor(-np.inf, dtype=torch.float32)
    row = torch.arange(s_q)[:, None]
    m = torch.full((q.shape[0], s_q), -np.inf)
    l = torch.zeros(q.shape[0], s_q)
    o = torch.zeros(q.shape[0], s_q, d)
    for k0 in range(0, s_k, n):
        cols = torch.arange(k0, k0 + n)
        # keys past Skv arrive as zero rows (TMA's fill), all masked
        kt, vt = (torch.nn.functional.pad(
            x[:, k0:k0 + n], (0, 0, 0, n - x[:, k0:k0 + n].shape[1]))
            for x in (k, v))
        sc = mm(q, kt.transpose(1, 2))
        if scale < 0:
            sc = -sc
        live = cols[None, :] < s_k
        if causal:
            live = live & (cols[None, :] <= row)
        sc = torch.where(live, sc, neg_inf)
        m_new = torch.maximum(m, sc.max(-1).values * c)
        m_use = torch.where(m_new == -np.inf, torch.zeros(()), m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(sc * c - m_use[..., None])
        m = m_new
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vt)
    l_safe = torch.clamp(l, min=1e-30)
    return o * (1 / l_safe)[..., None], m / LOG2E + torch.log(l_safe)


def fwd_f64(q, k, v, scale, causal):
    """The forward in float64: softmax(scale Q K^T + mask) V and its
    natural-log lse."""
    s = mm_f64(q, k.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(
            ~torch.tril(torch.ones(s.shape[1:], dtype=torch.bool)), -np.inf)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v.double(), lse


def _fwd_inputs(s_q, s_k, d, causal, scale):
    rng = np.random.default_rng(s_q * 1000 + s_k + d * 2 + causal)
    q = torch.from_numpy(rng.normal(size=(HEADS, s_q, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(HEADS, s_k, d))
                             .astype(np.float32)) for _ in range(2))
    return q, k, v, d ** -0.5 if scale is None else scale


@functools.lru_cache(maxsize=None)
def _jax_fwd(case):
    """``_flash_fwd`` in interpret mode on the case's inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_multiprocessing_distributed_tpu.ops.pallas.flash_attention \
        import _flash_fwd
    q, k, v, scale = _fwd_inputs(*case)
    out, lse = _flash_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                          scale, case[3], 64, 64, True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("case", FWD_CASES)
def test_tf32x3_fwd_matches_jax(case):
    """The emulated 3xTF32 forward against ``_flash_fwd`` (interpret
    mode, as ``tests/test_torch_flash_attention.py`` runs it): out and
    lse within 1e-4."""
    ref_out, ref_lse = _jax_fwd(case)
    q, k, v, scale = _fwd_inputs(*case)
    out, lse = fwd_emulated(q, k, v, scale, case[3], mm_3x)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=OUT_TOL,
                               rtol=OUT_TOL, err_msg="out")
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=OUT_TOL,
                               rtol=OUT_TOL, err_msg="lse")


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_one_tf32_product_is_far_off_three_are_not(case):
    """Against the float64 forward on the same inputs: with single TF32
    products the emulated forward errs at least 20x more than with
    3xTF32, and 3xTF32 stays within 1e-4 (out and lse)."""
    q, k, v, scale = _fwd_inputs(*case)
    ref = fwd_f64(q, k, v, scale, case[3])
    err_3x = _max_err(fwd_emulated(q, k, v, scale, case[3], mm_3x), ref)
    err_1x = _max_err(fwd_emulated(q, k, v, scale, case[3], mm_1x), ref)
    print(f"forward {case}: max|err| vs float64, 3xTF32 "
          f"{err_3x:.3e}, one TF32 product {err_1x:.3e} "
          f"({err_1x / err_3x:.1f}x)")
    assert err_3x <= OUT_TOL
    assert err_1x >= RATIO * err_3x


def _inputs(s, d, causal):
    """q, k, v, dO [BH, S, D] f32 from a seed; lse and dterm [BH, S] of
    the float64 forward (the values the training path hands the pair)."""
    rng = np.random.default_rng(s * 1000 + d * 2 + causal)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(HEADS, s, d))
                                    .astype(np.float32)) for _ in range(4))
    scale = d ** -0.5
    logits = mm_f64(q, k.transpose(1, 2)) * scale
    if causal:
        logits = logits.masked_fill(
            ~torch.tril(torch.ones(s, s, dtype=torch.bool)), -np.inf)
    lse = torch.logsumexp(logits, -1)
    out = torch.softmax(logits, -1) @ v.double()
    dterm = (do.double() * out).sum(-1)
    return q, k, v, do, lse.float(), dterm.float(), scale


def _max_err(got, ref):
    return max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))


@pytest.mark.parametrize("s,d,causal", CASES)
def test_tf32x3_pair_matches_jax(s, d, causal):
    """The emulated 3xTF32 pair against ``_flash_pair_grads`` (interpret
    mode, as ``tests/test_torch_flash_attention.py`` runs it) within the
    f32 grad tolerance."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_multiprocessing_distributed_tpu.ops.pallas.flash_attention \
        import _flash_pair_grads
    q, k, v, do, lse, dterm, scale = _inputs(s, d, causal)
    got = pair_grads(q, k, v, do, lse, dterm, scale, causal, mm_3x)
    ref = _flash_pair_grads(*(jnp.asarray(x.numpy()) for x in
                              (q, k, v, do, lse, dterm)),
                            scale=scale, causal=causal, block_q=64,
                            block_k=64, interpret=True)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("s,d,causal", CASES)
def test_one_tf32_product_is_far_off_three_are_not(s, d, causal):
    """Against the float64 pair on the same inputs: a single TF32 product
    errs at least 20x more than 3xTF32, and 3xTF32 stays within the f32
    grad tolerance."""
    q, k, v, do, lse, dterm, scale = _inputs(s, d, causal)
    ref = pair_grads(q, k, v, do, lse.double(), dterm.double(), scale,
                     causal, mm_f64)
    err_3x = _max_err(pair_grads(q, k, v, do, lse, dterm, scale, causal,
                                 mm_3x), ref)
    err_1x = _max_err(pair_grads(q, k, v, do, lse, dterm, scale, causal,
                                 mm_1x), ref)
    print(f"S={s} Dh={d} causal={causal}: max|err| vs float64, 3xTF32 "
          f"{err_3x:.3e}, one TF32 product {err_1x:.3e} "
          f"({err_1x / err_3x:.1f}x)")
    assert err_3x <= GRAD_TOL
    assert err_1x >= RATIO * err_3x


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated ``cvt.rna``: 10 mantissa bits kept, ties away from
    zero, both signs; hi + lo recovers x to 2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi.double() + lo.double() - y.double()).abs()
                  / y.double().abs()).max()) <= 2.0 ** -22
