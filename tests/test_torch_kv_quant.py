"""The port's int8 KV quantization against the JAX package's.

``quantize_kv`` (torch) and ``quantize_kv_np`` (numpy) must be BIT-equal
to JAX ``quantize_kv`` on the same numpy inputs, all-zero groups and
exact .5 ties included (tolerance 0: the engine's int8 transcripts and
the kernels' dequant rest on the same bits), and ``dequantize_kv`` must
be bit-equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops import kv_quant as jkq
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    KV_DTYPES, QuantizedKV, dequantize_kv, kv_slice_in_dim, quantize_kv,
    quantize_kv_np, stack_kv)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 3, 9, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 3] = 0.0  # all-zero groups: scale 1, data 0
    # exact ties: amax 127 gives scale 1.0, so x / scale lands on .5
    x[1, 2, 4, 0] = np.arange(16, dtype=np.float32) - 7.5
    x[1, 2, 4, 0, 0] = 127.0
    x[1, 1, 1, 1] = np.float32(2.5)
    x[1, 1, 1, 1, 5] = np.float32(-127.0)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal_to_jax(seed, dtype):
    x = _inputs(seed)
    jdt = getattr(jnp, dtype)
    ref = jkq.quantize_kv(jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = quantize_kv(xt)
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    host_q, host_s = quantize_kv_np(np.asarray(jnp.asarray(x, jdt),
                                               np.float32))
    np.testing.assert_array_equal(host_q, np.asarray(ref.data))
    np.testing.assert_array_equal(host_s, np.asarray(ref.scale))
    # dequant: the one expression, in each compute dtype
    for cdt in ("float32", "bfloat16"):
        want = jkq.dequantize_kv(ref, getattr(jnp, cdt))
        back = dequantize_kv(got, getattr(torch, cdt))
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(want, np.float32))


def test_zero_groups_and_ties():
    x = _inputs(0)
    got = quantize_kv(torch.from_numpy(x))
    assert torch.all(got.data[0, 0, 3] == 0)
    assert torch.all(got.scale[0, 0, 3] == 1.0)
    # half to even: -7.5 -> -8, -6.5 -> -6, 0.5 -> 0, 1.5 -> 2
    row = got.data[1, 2, 4, 0].tolist()
    assert row[1:] == [round(v) for v in
                       (np.arange(1, 16, dtype=np.float64) - 7.5)]
    assert row[1:4] == [-6, -6, -4]


def test_quantized_kv_duck_surface():
    x = torch.ones(2, 3, 4, 2, 8, dtype=torch.bfloat16)
    kv = quantize_kv(x)
    assert isinstance(kv, QuantizedKV) and KV_DTYPES == ("model", "int8")
    assert kv.shape == x.shape and kv.ndim == 5
    assert kv.dtype == torch.int8
    assert kv.nbytes == kv.data.numel() + 4 * kv.scale.numel()
    sub = kv[:, 1:2]
    assert isinstance(sub, QuantizedKV)
    assert tuple(sub.data.shape) == (2, 1, 4, 2, 8)
    assert tuple(sub.scale.shape) == (2, 1, 4, 2)
    sub.data.fill_(3)  # a view: writes reach the parent
    assert int(kv.data[0, 1, 0, 0, 0]) == 3
    win = kv_slice_in_dim(kv, 0, 2, axis=2)
    assert tuple(win.data.shape) == (2, 3, 2, 2, 8)
    assert tuple(win.scale.shape) == (2, 3, 2, 2)
    stacked = stack_kv([kv[0], kv[1]])
    assert torch.equal(stacked.data, kv.data)
    assert torch.equal(stacked.scale, kv.scale)
    assert "QuantizedKV" in repr(kv)
    plain = torch.zeros(3, 5, 2)
    assert kv_slice_in_dim(plain, 1, 2, axis=1).shape == (3, 2, 2)
    assert stack_kv([plain, plain]).shape == (2, 3, 5, 2)
