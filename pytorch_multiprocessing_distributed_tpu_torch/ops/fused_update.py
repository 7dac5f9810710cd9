"""Single-pass fused SGD (momentum, weight decay, Nesterov) over flat
buffers.

The port of the JAX package's ``ops/pallas/fused_update.py``. On the
card the update is one CUDA kernel (``csrc/fused_update.cu``) over the
train state's flat f32 buffers: it reads params, grads and momenta once
and writes params and momenta in place. On the CPU it runs its plain
PyTorch version, :func:`torch_fused_sgd_` — the whole-buffer ops that
:class:`..train.optim.SGD` runs for ``--optimizer sgd`` — which is also
the kernel's reference on the card.

The rule is torch's SGD (:mod:`..train.optim`):

    g   = grad + wd * p
    buf = init * momentum * buf + g        (init = 0 before the first step)
    d   = g + momentum * buf  (nesterov)   |  buf
    p   = p - lr * d

with the NaN guard of the train step folded in: where the device bool
``keep`` is False nothing is written and ``initialized``/``count`` keep
their values. ``lr`` comes from the host (the epoch schedule); ``init``
and ``keep`` are read on the device, so the update never syncs with the
host. The kernel rounds every product and sum on its own, as the plain
version's separate ops do, and the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import resolve_impl
from ._build import load

__all__ = ["fused_sgd_", "sgd_direction", "torch_fused_sgd_"]


def sgd_direction(params: torch.Tensor, grads: torch.Tensor,
                  buf: torch.Tensor, initialized: torch.Tensor, *,
                  momentum: float, weight_decay: float, nesterov: bool):
    """The rule's elementwise part: ``(d, new buf)`` from flat buffers of
    one length (the whole buffers, or one rank's shards under
    ``--zero``); the update is then ``p - lr * d``."""
    g = grads + weight_decay * params
    new_buf = torch.where(initialized, momentum * buf + g, g)
    d = g + momentum * new_buf if nesterov else new_buf
    return d, new_buf


def torch_fused_sgd_(params: torch.Tensor, grads: torch.Tensor,
                     buf: torch.Tensor, initialized: torch.Tensor,
                     count: torch.Tensor, keep: torch.Tensor, *, lr: float,
                     momentum: float, weight_decay: float,
                     nesterov: bool) -> None:
    """The plain version: whole-buffer torch ops, then the guard's
    select (see the module docstring)."""
    with torch.no_grad():
        d, new_buf = sgd_direction(params, grads, buf, initialized,
                                   momentum=momentum,
                                   weight_decay=weight_decay,
                                   nesterov=nesterov)
        new_params = params - lr * d
        params.copy_(torch.where(keep, new_params, params))
        buf.copy_(torch.where(keep, new_buf, buf))
        initialized.logical_or_(keep)
        count.add_(keep.to(count.dtype))


def _check(params, grads, buf, initialized, count, keep):
    for name, t in (("params", params), ("grads", grads), ("buf", buf)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous flat f32 buffer, got "
                f"{t.dtype} {tuple(t.shape)}")
    if not params.shape == grads.shape == buf.shape:
        raise ValueError(
            f"params/grads/buf lengths differ: {params.numel()}, "
            f"{grads.numel()}, {buf.numel()}")
    for name, t, dtype in (("initialized", initialized, torch.bool),
                           ("keep", keep, torch.bool),
                           ("count", count, torch.int32)):
        if t.dtype != dtype or t.numel() != 1:
            raise ValueError(
                f"{name} must be a {dtype} scalar, got {t.dtype} "
                f"{tuple(t.shape)}")
    devs = {t.device for t in (params, grads, buf, initialized, count, keep)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for t in (params, grads, buf))
    if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError("params, grads and buf must not overlap")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point with its ctypes signature (built at first
    use)."""
    fn = load("fused_update").pmdt_fused_sgd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_sgd_(params: torch.Tensor, grads: torch.Tensor,
               buf: torch.Tensor, initialized: torch.Tensor,
               count: torch.Tensor, keep: torch.Tensor, *, lr: float,
               momentum: float = 0.9, weight_decay: float = 1e-4,
               nesterov: bool = True, impl: str = "auto") -> None:
    """One fused SGD update of ``params`` and ``buf`` in place.

    Args:
      params, grads, buf: flat f32 ``[n]`` buffers (any ``n``), on one
        device, not overlapping.
      initialized: bool scalar; False before the first applied update
        (torch's lazy momentum init), set by an applied update.
      count: int32 scalar; advanced by one per applied update.
      keep: bool scalar; False skips the update (nothing is written).
      lr, momentum, weight_decay, nesterov: the SGD hyper-parameters.
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see :mod:`..ops`).
    """
    kw = dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
              nesterov=nesterov)
    if resolve_impl(impl, params) == "torch":
        torch_fused_sgd_(params, grads, buf, initialized, count, keep, **kw)
        return
    _check(params, grads, buf, initialized, count, keep)
    err = _kernel()(
        params.data_ptr(), grads.data_ptr(), buf.data_ptr(), keep.data_ptr(),
        initialized.data_ptr(), count.data_ptr(), params.numel(), float(lr),
        float(momentum), float(weight_decay), int(bool(nesterov)),
        torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sgd kernel launch failed: cudaError {err} "
            f"(n={params.numel()})")
    fused_sgd_.launches += 1


# launches of the CUDA kernel (incremented where it launches only)
fused_sgd_.launches = 0
