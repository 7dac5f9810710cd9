"""Flash-decode attention: one cached query per slot over a KV window.

The serving engine's decode step: ONE query token per slot attending
over the slot's cached columns ``[0, position]``. On the card this runs
the hand-written CUDA kernel ``csrc/decode_attention.cu`` (the port of
the JAX package's Pallas ``_decode_kernel``): K/V are read once through
their strides, the softmax is an online recurrence in registers, and a
slot pays for its own length, not the window's. On the CPU it runs
:func:`torch_decode_attention`, the plain masked-softmax math of the JAX
package's ``xla_decode_attention``, which is also the kernel's reference
on the card.

Layouts are the JAX package's: q ``[B, 1, H, Dh]``, k/v ``[B, W, H,
Dh]`` (the engine passes the window view ``k_cache[:, :W]``, never a
copy), positions ``[B]`` int32; the output is f32 ``[B, 1, H, Dh]`` and
the caller casts back to the model dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import resolve_impl
from ._build import load

__all__ = ["decode_attention", "torch_decode_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def torch_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reference: f32 logits, masked softmax over columns
    ``<= positions[b]``, f32 PV (the JAX package's
    ``xla_decode_attention`` with the mask built from positions).
    A position beyond the window attends the whole window."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    cols = torch.arange(k.shape[1], device=k.device)
    mask = cols[None, :] <= positions.to(torch.long)[:, None]  # [B, W]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def _check(q, k, v, positions):
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"q must be [B, 1, H, Dh], got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k must be [B, W, H, Dh] = [{b}, W, {h}, {d}], got "
            f"{tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if positions.shape != (b,) or positions.dtype != torch.int32:
        raise ValueError(
            f"positions must be int32 [{b}], got {positions.dtype} "
            f"{tuple(positions.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {_HEAD_DIMS}, got {d}")
    if k.shape[1] < 1:
        raise ValueError("empty KV window")
    devs = {t.device for t in (q, k, v, positions)}
    if len(devs) != 1:
        raise ValueError(f"q/k/v/positions on different devices: {devs}")
    vec = 16 // q.element_size()  # 16-byte loads: lanes per thread
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit head_dim stride")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides "
                f"{t.stride()}, element size {t.element_size()})")
    if not positions.is_contiguous():
        raise ValueError("positions must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point with its ctypes signature (built at first
    use)."""
    fn = load("decode_attention").pmdt_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, positions):
    fn = _kernel()
    b, _, h, d = q.shape
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             positions.data_ptr(), out.data_ptr(), b, h, k.shape[1], d,
             _DTYPES[q.dtype], q.stride(0), q.stride(2), k.stride(0),
             k.stride(1), k.stride(2), v.stride(0), v.stride(1),
             v.stride(2), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err} "
            f"(B={b} H={h} W={k.shape[1]} Dh={d} {q.dtype})")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """Single-step cached attention over a KV window.

    Args:
      q: ``[B, 1, H, Dh]`` — one pending query token per slot.
      k, v: ``[B, W, H, Dh]`` KV window (any strides with a unit
        ``Dh`` stride — the engine's ``cache[:, :W]`` view is read in
        place).
      positions: ``[B]`` int32 — slot ``b`` attends columns
        ``[0, positions[b]]``; a position ``>= W`` attends the whole
        window.
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see :mod:`..ops`).

    Returns ``[B, 1, H, Dh]`` f32 attention output.
    """
    if resolve_impl(impl, q) == "torch":
        return torch_decode_attention(q, k, v, positions)
    _check(q, k, v, positions)
    return _launch(q, k, v, positions)


# launches of the CUDA kernel (incremented in _launch only)
decode_attention.launches = 0
