"""The port's CUDA kernels on the card (every test here is marked
``cuda`` and skips on a machine without one; the kernels have no CPU
mode). This file imports neither jax nor the JAX package, so it runs on
a GPU machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors. Tolerance: atol 1e-4 — the same f32 math on the same values,
only the summation order differs.
"""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
    import decode_attention, torch_decode_attention
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, init_params)

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
