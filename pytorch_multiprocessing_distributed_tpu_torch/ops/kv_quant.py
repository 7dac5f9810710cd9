"""int8 KV-cache quantization: int8 lanes plus one f32 scale per
(token, head), the port of the JAX package's ``ops/kv_quant.py``.

The representation is :class:`QuantizedKV`, a plain pair ``(data
int8, scale f32)`` whose scale has the data's shape minus the trailing
head_dim axis (one amax per head_dim group):

* dense slot caches: data ``[L, slots, s_max, H, Dh]`` int8, scale
  ``[L, slots, s_max, H]`` f32;
* paged caches: data ``[L, pages, H, page_size, Dh]`` int8, scale
  ``[L, pages, H, page_size]`` f32.

The JAX class is a registered pytree so jit, scan and donation see two
leaves; PyTorch has no tracing to feed, so here it is a plain class
with just enough array surface (``shape``, ``dtype``, ``nbytes``,
leading-axis ``[i]`` indexing that slices both parts) that cache-shaped
code reads the same in both modes.

The formula (device and the numpy twin are held bit-equal, and both
bit-equal to the JAX package's):

    amax  = max(|x|) over head_dim            (per token, per head)
    scale = amax * (1/127)    (1.0 where the group is all-zero)
    q     = clip(round(x / scale), -127, 127) as int8

``torch.round`` rounds half to even, as ``jnp.round`` and ``np.round``
do. Dequant is ``q * scale`` in f32 cast to the compute dtype — the
one expression the CUDA kernels and the plain versions share.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["QuantizedKV", "KV_DTYPES", "quantize_kv", "dequantize_kv",
           "quantize_kv_np", "kv_slice_in_dim", "stack_kv"]

# engine-facing names for the cache element layout; "model" keeps the
# cache in the model's dtype
KV_DTYPES = ("model", "int8")

_QMAX = 127.0
# The scale multiplies by this precomputed reciprocal instead of
# dividing by 127: XLA strength-reduces a division by a constant to a
# reciprocal multiply, so the JAX package pins the multiply for every
# path; a true division here would differ by 1 ULP on a few percent of
# values.
_INV_QMAX = np.float32(1.0 / _QMAX)


class QuantizedKV:
    """A quantized KV cache: int8 ``data`` and f32 ``scale`` with
    ``scale.shape == data.shape[:-1]``. Reads of ``shape``/``dtype``
    delegate to ``data``; ``[idx]`` indexes both parts along the
    leading axes (layer or page selection)."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, idx) -> "QuantizedKV":
        # leading-axis indexing only: the trailing head_dim axis exists
        # on data alone, so an index reaching it would split the pair
        return QuantizedKV(self.data[idx], self.scale[idx])

    def __repr__(self) -> str:
        return (f"QuantizedKV(data={tuple(self.data.shape)}:"
                f"{self.data.dtype}, scale={tuple(self.scale.shape)}:"
                f"{self.scale.dtype})")


def quantize_kv(x: torch.Tensor) -> QuantizedKV:
    """Symmetric per-(…, token, head) int8 quantization over the
    trailing head_dim axis, in f32 whatever the input dtype."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax * float(_INV_QMAX),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -_QMAX, _QMAX)
    return QuantizedKV(q.to(torch.int8), scale)


def dequantize_kv(kv: QuantizedKV, dtype: torch.dtype) -> torch.Tensor:
    """``data * scale`` in f32, cast to the compute ``dtype``."""
    return (kv.data.float() * kv.scale[..., None]).to(dtype)


def quantize_kv_np(x):
    """The numpy twin of :func:`quantize_kv`: ``(data int8, scale
    f32)`` ndarrays, bit-equal to the device formula."""
    xf = np.asarray(x).astype(np.float32)
    amax = np.max(np.abs(xf), axis=-1)
    scale = np.where(amax > 0.0, amax * _INV_QMAX,
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(xf / scale[..., None]), -_QMAX, _QMAX)
    return q.astype(np.int8), scale


def kv_slice_in_dim(kv, start: int, size: int, axis: int):
    """``kv.narrow(axis, start, size)`` over a cache that may be
    quantized; ``axis`` precedes head_dim, so it is the same axis on
    both parts. Returns views."""
    if isinstance(kv, QuantizedKV):
        return QuantizedKV(kv.data.narrow(axis, start, size),
                           kv.scale.narrow(axis, start, size))
    return kv.narrow(axis, start, size)


def stack_kv(leaves):
    """``torch.stack`` over per-layer caches that may be quantized."""
    if leaves and isinstance(leaves[0], QuantizedKV):
        return QuantizedKV(torch.stack([kv.data for kv in leaves]),
                           torch.stack([kv.scale for kv in leaves]))
    return torch.stack(leaves)
