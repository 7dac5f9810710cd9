"""The port's decode attention against the JAX package's.

The plain PyTorch version (what the wrapper runs on a CPU tensor, and
the CUDA kernel's reference on the card) is held against the JAX
flash-decode kernel in Pallas interpret mode and against its XLA
reference, on the same numpy inputs. Tolerances: f32 inputs atol 1e-5
(the same f32 math, summed in another order); bf16 inputs, compared in
f32, atol 2e-2 (the Pallas kernel runs its PV product on bf16-rounded
probabilities, the port in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops.pallas.decode_attention \
    import decode_attention as jax_decode_attention
from pytorch_multiprocessing_distributed_tpu_torch.ops import resolve_impl
from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
    import _check, decode_attention, torch_decode_attention

B, H, DH, BLOCK_K = 3, 2, 32, 16


def _inputs(s, positions, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, s, H, DH)).astype(np.float32)
    v = rng.normal(size=(B, s, H, DH)).astype(np.float32)
    return q, k, v, np.asarray(positions, np.int32)


def _port(q, k, v, pos, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return decode_attention(*t, torch.from_numpy(pos)).numpy()


def _jax(q, k, v, pos, dtype, impl):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    kw = dict(block_k=BLOCK_K, interpret=True) if impl == "pallas" else {}
    out = jax_decode_attention(*args, jnp.asarray(pos), impl=impl, **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("s", [40, 264])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(s, dtype):
    """Rows at position 0, the last column and one beyond the window
    against the XLA reference; the in-window rows also against the
    Pallas kernel. (The Pallas kernel pads the window to a whole block
    and a row beyond the window would also attend those pad columns; the
    port clamps such a row to the window, the XLA semantics.)"""
    q, k, v, pos = _inputs(s, [0, s - 1, s + 5])
    atol = 1e-5 if dtype == "float32" else 2e-2
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = _port(q, k, v, pos, tdt)
    assert got.dtype == np.float32 and got.shape == (B, 1, H, DH)
    np.testing.assert_allclose(got, _jax(q, k, v, pos, jdt, "xla"),
                               atol=atol, rtol=0)
    in_win = pos < s
    np.testing.assert_allclose(
        got[in_win], _jax(q, k, v, pos, jdt, "pallas")[in_win],
        atol=atol, rtol=0)


def test_ragged_positions_match_pallas():
    """Positions inside the window but across block boundaries."""
    q, k, v, pos = _inputs(40, [7, 16, 23], seed=1)
    np.testing.assert_allclose(
        _port(q, k, v, pos, torch.float32),
        _jax(q, k, v, pos, jnp.float32, "pallas"), atol=1e-5, rtol=0)


def test_window_view_is_read_in_place():
    """The engine passes ``cache[:, :W]``, a strided view: same result
    as a contiguous copy."""
    q, k, v, pos = _inputs(64, [3, 10, 15], seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    view = decode_attention(tq, tk[:, :16], tv[:, :16], tp)
    copy = decode_attention(tq, tk[:, :16].contiguous(),
                            tv[:, :16].contiguous(), tp)
    torch.testing.assert_close(view, copy, atol=0, rtol=0)


def test_auto_on_cpu_takes_plain_version_without_launch():
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(40, [0, 5, 39]))
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos, impl="auto")
    torch.testing.assert_close(out, torch_decode_attention(q, k, v, pos),
                               atol=0, rtol=0)
    assert decode_attention.launches == before


@pytest.mark.parametrize("impl, raises", [
    ("cuda", ValueError), ("pallas", ValueError), ("xla", ValueError)])
def test_impl_on_cpu_tensor_raises(impl, raises):
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(40, [0, 5, 39]))
    with pytest.raises(raises):
        decode_attention(q, k, v, pos, impl=impl)


def test_resolve_impl_convention():
    cpu = torch.zeros(1)
    assert resolve_impl("auto", cpu) == "torch"
    assert resolve_impl("torch", cpu) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_impl("cuda", cpu)


@pytest.mark.parametrize("change, match", [
    (dict(d=160), "Dh"),
    (dict(pos_dtype=torch.int64), "int32"),
    (dict(dtype=torch.float16), "f32 or bf16"),
    (dict(q_shape=(B, 2, H, 32)), r"\[B, 1, H, Dh\]"),
    (dict(k_heads=H + 1), "k must be"),
])
def test_kernel_input_checks(change, match):
    """What the kernel does not take is refused before any launch."""
    d = change.get("d", 32)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(change.get("q_shape", (B, 1, H, d)), dtype=dtype)
    k = torch.zeros(B, 16, change.get("k_heads", H), d, dtype=dtype)
    pos = torch.zeros(B, dtype=change.get("pos_dtype", torch.int32))
    with pytest.raises(ValueError, match=match):
        _check(q, k, k.clone(), pos)


def test_build_sources_and_missing_nvcc(monkeypatch, tmp_path):
    """The build helper lists every CUDA source, keys each library by
    source and flags, and names a missing compiler instead of failing
    obscurely (this machine has no nvcc; the path is checked first)."""
    from pytorch_multiprocessing_distributed_tpu_torch.ops import _build

    assert "decode_attention" in _build.sources()
    target = _build._target("decode_attention")
    assert target.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build._target("decode_attention") != target
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()
