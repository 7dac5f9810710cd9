"""Blockwise (flash) attention with its FlashAttention-2 backward.

The port of the JAX package's ``ops/pallas/flash_attention.py``. On the
card each pass runs a hand-written CUDA kernel
(``csrc/flash_attention.cu``): the forward writes the output and the
per-row log-sum-exp, and the backward is two kernels that rebuild the
probabilities from that lse — dq loops over key tiles, dk/dv over query
tiles — so the ``[S, S]`` logits never reach device memory. On the CPU
each pass runs its plain PyTorch version (:func:`torch_flash_fwd`,
:func:`torch_flash_bwd_dq`, :func:`torch_flash_bwd_dkv`), which is also
the kernel's reference on the card.

Layouts are the JAX package's: q ``[B, Sq, H, Dh]``, k/v ``[B, Skv, H,
Dh]`` (any strides with a unit ``Dh`` stride: the model passes views of
its fused QKV projection and the kernels read them in place), any
``1 <= Dh <= 128``: the kernels run on a tile of 32, 64 or 128 columns,
read zeros past Dh (a row of whole 16-byte pieces) or take inputs the
wrapper zero-pads to the tile (any other Dh); lse and
the backward's ``dterm = rowsum(dO * O)`` are f32 ``[B, H, Sq]`` (the
JAX ``[B*H, Sq]``). Masks follow the Pallas ``_bwd_mask``: causal means
``col <= row`` (and needs ``Sq == Skv``), and ``Skv != Sq`` is allowed
when not causal.

The Pallas ``block_q``/``block_k`` are TPU VMEM tiles; the kernels pick
their own and take none as arguments. In bf16, CTAs of 128 query rows
(the forward), 64 query rows (dq) or 128 keys (dk/dv; 64 at Dh 128)
against a TMA-fed ring of 64-row K/V (or Q/dO) tiles, every product a
Hopper ``wgmma``. In f32 the three passes take CTAs of 128 query rows
(the forward, 64 a consumer warpgroup), 64 query rows (dq) or 64 keys
(dk/dv) against a TMA-fed ring of 64-row tiles (16 at Dh 128), every
product a 3xTF32 ``wgmma``: three TF32
products on hi/lo splits of the f32 operands, accurate to f32
(``tests/test_torch_flash_tf32x3.py`` emulates that arithmetic on the
CPU; ``tests/test_torch_cuda_kernels.py`` holds the kernels against the
plain versions on the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import head_dim_tile, kernel_head_dim, pad_head_dim, resolve_impl
from ._build import load

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_dterm", "flash_pair_grads", "torch_flash_fwd",
           "torch_flash_bwd_dq", "torch_flash_bwd_dkv"]

NEG_INF = -1e30  # the Pallas kernel's large-finite mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_REFUSED = 100000  # csrc's kTmaRefused: an entry's code past it


# ---- plain PyTorch versions (the CPU path and the kernels' reference) --

def _mask(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """``[Sq, Skv]`` validity: every column, or ``col <= row``."""
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(skv, device=device)[None, :]
    return col <= row


def _logits(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def torch_flash_fwd(q, k, v, *, scale: float, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Sq, H, Dh] in q's dtype, lse [B, H, Sq] f32)``: masked
    softmax attention in f32."""
    s = _logits(q, k, scale)
    s = s.masked_fill(~_mask(q.shape[1], k.shape[1], causal, q.device),
                      NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def _probs_and_dscores(q, k, v, do, lse, dterm, scale, causal):
    """P rebuilt from the lse (zero where masked) and dS = P o (dO V^T -
    D), both f32 ``[B, H, Sq, Skv]``."""
    s = _logits(q, k, scale)
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - dterm[..., None])


def torch_flash_bwd_dq(q, k, v, do, lse, dterm, *, scale: float,
                       causal: bool) -> torch.Tensor:
    """dq ``[B, Sq, H, Dh]`` in q's dtype: ``sum_k dS K * scale``."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, dterm, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def torch_flash_bwd_dkv(q, k, v, do, lse, dterm, *, scale: float,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` ``[B, Skv, H, Dh]`` in k's and v's dtypes: ``dk =
    sum_q dS^T Q * scale``, ``dv = sum_q P^T dO``."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, dterm, scale, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---- the CUDA kernels -------------------------------------------------

def _check_qkv(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q, k, v must be [B, S, H, Dh] with k.shape == v.shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k/v must be [{b}, Skv, {h}, {d}], got {tuple(k.shape)}")
    if causal and sq != k.shape[1]:
        raise ValueError(
            f"causal flash attention needs Sq == Skv, got {sq} vs "
            f"{k.shape[1]}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _kernel_inputs(tensors, rows=()):
    """What the kernels take: one dtype of f32/bf16, 1 <= Dh <= 128, a
    unit Dh stride and 16-byte aligned rows (the kernels read them by
    TMA), one CUDA device; per-row tensors f32 contiguous. Returns the
    tensors as the kernels read them: as given where a row of Dh is
    whole 16-byte pieces, else zero-padded to the kernels' tile
    (:func:`..ops.kernel_head_dim`)."""
    q = tensors[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            "the kernels take f32 or bf16 tensors of one dtype, got "
            f"{[t.dtype for t in tensors]}")
    head_dim_tile(q.shape[-1])
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError("q/k/v/dO need a unit head_dim stride")
    width = kernel_head_dim(q.shape[-1], q.element_size())
    tensors = [pad_head_dim(t, width) for t in tensors]
    # every pass reads q/k/v/dO by TMA, in both dtypes: 16-byte aligned
    # rows
    per = 16 // q.element_size()
    for t in tensors:
        if t.data_ptr() % 16 or any(s % per for s in t.stride()[:3]):
            raise ValueError(
                f"q/k/v/dO rows must be 16-byte aligned for the "
                f"{q.dtype} kernels (strides {t.stride()})")
    for t in rows:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lse and dterm must be contiguous f32 "
                             "[B, H, Sq]")
    devs = {t.device for t in (*tensors, *rows)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    return tensors


def _unpad(t, head_dim):
    """A kernel output of the padded width sliced back to ``head_dim``."""
    return t if t.shape[-1] == head_dim else t[..., :head_dim].contiguous()


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int):
    """A C entry point of ``flash_attention.cu`` with its ctypes
    signature (built at first use)."""
    fn = getattr(load("flash_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(name, ptr_tensors, stride_tensors, q, k, scale, causal):
    b, sq, h, d = q.shape
    fn = _entry(name, len(ptr_tensors))
    err = fn(*(t.data_ptr() for t in ptr_tensors), b, h, sq, k.shape[1], d,
             _DTYPES[q.dtype], _strides(*stride_tensors), scale, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = (f"cuTensorMapEncodeTiled refused a TMA descriptor: CUresult "
                f"{err - _TMA_REFUSED}" if err >= _TMA_REFUSED
                else f"cudaError {err}")
        raise RuntimeError(
            f"{name} launch failed: {what} (B={b} H={h} Sq={sq} "
            f"Skv={k.shape[1]} Dh={d} {q.dtype} causal={causal})")


def _scale(q, scale):
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def flash_fwd(q, k, v, *, scale: Optional[float] = None,
              causal: bool = False, impl: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass: ``(out [B, Sq, H, Dh] in q's dtype, lse [B, H, Sq]
    f32)`` — the kernel on a CUDA tensor, :func:`torch_flash_fwd` on a
    CPU tensor (``impl`` as in :mod:`..ops`)."""
    _check_qkv(q, k, v, causal)
    scale = _scale(q, scale)
    if resolve_impl(impl, q) == "torch":
        return torch_flash_fwd(q, k, v, scale=scale, causal=causal)
    head_dim = q.shape[-1]
    q, k, v = _kernel_inputs((q, k, v))
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call("pmdt_flash_fwd", (q, k, v, out, lse), (q, k, v, out), q, k,
          scale, causal)
    flash_fwd.launches += 1
    return _unpad(out, head_dim), lse


def flash_bwd_dq(q, k, v, do, lse, dterm, *, scale: Optional[float] = None,
                 causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """dq from an external lse and dterm (the Pallas ``_bwd_dq_kernel``)."""
    _check_qkv(q, k, v, causal)
    scale = _scale(q, scale)
    if resolve_impl(impl, q) == "torch":
        return torch_flash_bwd_dq(q, k, v, do, lse, dterm, scale=scale,
                                  causal=causal)
    head_dim = q.shape[-1]
    q, k, v, do = _kernel_inputs((q, k, v, do), (lse, dterm))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _call("pmdt_flash_bwd_dq", (q, k, v, do, lse, dterm, dq),
          (q, k, v, do, dq), q, k, scale, causal)
    flash_bwd_dq.launches += 1
    return _unpad(dq, head_dim)


def flash_bwd_dkv(q, k, v, do, lse, dterm, *,
                  scale: Optional[float] = None, causal: bool = False,
                  impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from an external lse and dterm (the Pallas
    ``_bwd_dkv_kernel``)."""
    _check_qkv(q, k, v, causal)
    scale = _scale(q, scale)
    if resolve_impl(impl, q) == "torch":
        return torch_flash_bwd_dkv(q, k, v, do, lse, dterm, scale=scale,
                                   causal=causal)
    head_dim = q.shape[-1]
    q, k, v, do = _kernel_inputs((q, k, v, do), (lse, dterm))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _call("pmdt_flash_bwd_dkv", (q, k, v, do, lse, dterm, dk, dv),
          (q, k, v, do, dk, dv), q, k, scale, causal)
    flash_bwd_dkv.launches += 1
    return _unpad(dk, head_dim), _unpad(dv, head_dim)


# launches of each CUDA kernel (incremented where it launches only)
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_pair_grads(q, k, v, do, lse, dterm, *, scale: float,
                     causal: bool, impl: str = "auto"):
    """``(dq, dk, dv)`` for one q/kv pair given an EXTERNAL ``lse [B, H,
    Sq]`` and ``dterm [B, H, Sq] = rowsum(dO * O)`` — the JAX
    ``_flash_pair_grads``, which ring attention calls per hop with the
    global lse. ``do`` must be in q's dtype."""
    dq = flash_bwd_dq(q, k, v, do, lse, dterm, scale=scale, causal=causal,
                      impl=impl)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dterm, scale=scale,
                           causal=causal, impl=impl)
    return dq, dk, dv


def flash_dterm(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)``, f32 ``[B, H, Sq]`` contiguous: the torch
    ops the backward runs before the pair (JAX forms it outside its
    kernels too)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash3`` custom VJP: the forward saves ``(q, k, v, out,
    lse)``; the backward forms ``D = rowsum(dO * O)`` in f32 with torch
    ops (as JAX does outside its kernels) and calls the pair grads."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, impl):
        out, lse = flash_fwd(q, k, v, scale=scale, causal=causal, impl=impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.impl = scale, causal, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_pair_grads(
            q, k, v, do.to(q.dtype).contiguous(), lse, flash_dterm(do, out),
            scale=ctx.scale, causal=ctx.causal, impl=ctx.impl)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = False,
                    impl: str = "auto") -> torch.Tensor:
    """Memory-efficient exact attention, differentiable.

    Args:
      q: ``[batch, seq_q, heads, head_dim]``.
      k, v: ``[batch, seq_kv, heads, head_dim]`` — ``seq_kv`` may differ
        from ``seq_q`` when not causal; lengths need not be multiples of
        the kernels' tiles.
      scale: logit scale, default ``head_dim ** -0.5``.
      causal: causal mask (needs ``seq_q == seq_kv``).
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see :mod:`..ops`).

    Returns ``[batch, seq_q, heads, head_dim]`` in ``q.dtype``.
    """
    _check_qkv(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, _scale(q, scale), bool(causal),
                                 impl)
