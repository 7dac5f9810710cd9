"""Hand-written CUDA kernels for the port's hot ops, with their plain
PyTorch versions beside them.

Dispatch convention (the counterpart of the JAX package's
``impl="auto"|"pallas"|"xla"``): every kernel wrapper takes
``impl="auto"|"cuda"|"torch"``.

- ``auto``: the kernel for a CUDA tensor, the plain version for a CPU
  tensor;
- ``cuda``: the kernel; a CPU tensor raises;
- ``torch``: the plain version; a CUDA tensor raises (call the plain
  function by name to run it on the card, as ``chip_smoke.py`` does).

There is no ``try`` that falls back: on a CUDA tensor a wrapper launches
its kernel or raises. Each wrapper counts its launches in a plain
integer attribute (``decode_attention.launches``,
``paged_decode_attention.int8_launches``, ``flash_fwd.launches``,
``fused_sgd_.launches``, ``ring_all_reduce.launches``, ...),
incremented where it launches the kernel and nowhere else.

Kernels are compiled from ``ops/csrc/`` at first use (:mod:`._build`).
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    """``"cuda"`` or ``"torch"`` for ``tensor`` under ``impl``; raises
    on a mismatch between the asked implementation and the device."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    on_card = tensor.is_cuda
    if impl == "auto":
        return "cuda" if on_card else "torch"
    if impl == "cuda" and not on_card:
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got a tensor on "
            f"{tensor.device}")
    if impl == "torch" and on_card:
        raise ValueError(
            "impl='torch' takes CPU tensors only: on the card a wrapper "
            "launches its kernel; call the plain function by name to run "
            "the reference there")
    return impl


HEAD_DIM_TILES = (32, 64, 128)  # the attention kernels' column tiles


def head_dim_tile(head_dim: int) -> int:
    """The attention kernels' tile of columns for ``head_dim``: the
    smallest of 32, 64 and 128 that holds it. A head_dim past 128 (the
    largest tile) raises."""
    for tile in HEAD_DIM_TILES:
        if 1 <= head_dim <= tile:
            return tile
    raise ValueError(
        f"the attention kernels take 1 <= Dh <= {HEAD_DIM_TILES[-1]} "
        f"(head_dim), got {head_dim}")


def kernel_head_dim(head_dim: int, element_size: int) -> int:
    """The head_dim the attention kernels are given for ``head_dim``
    over rows of ``element_size``-byte elements: ``head_dim`` itself
    where a row is whole 16-byte pieces (the kernels read zeros past it
    in their tile and store none of those columns), else its tile, to
    which :func:`pad_head_dim` zero-pads the inputs. Both are exact:
    zero columns of q and k add nothing to ``q . k``, and zero columns
    of v give zero output columns, which the wrappers slice off."""
    tile = head_dim_tile(head_dim)
    return head_dim if head_dim * element_size % 16 == 0 else tile


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last (head_dim) axis zero-padded to ``width``;
    ``t`` itself when it is that wide already."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


from .decode_attention import (  # noqa: E402,F401
    decode_attention, paged_decode_attention,
    paged_verify_decode_attention, torch_decode_attention,
    torch_paged_decode_attention, torch_paged_verify_decode_attention,
    torch_verify_decode_attention, verify_decode_attention)
from .flash_attention import (  # noqa: E402,F401
    flash_attention, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
    flash_pair_grads, torch_flash_bwd_dkv, torch_flash_bwd_dq,
    torch_flash_fwd)
from .fused_update import fused_sgd_, torch_fused_sgd_  # noqa: E402,F401
from .ring_allreduce import (  # noqa: E402,F401
    PeerAccessError, release_peer_buffers, ring_all_reduce,
    ring_all_reduce_loopback, ring_layout, torch_ring_all_reduce)
