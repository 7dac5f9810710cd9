"""Device selection for the port's entry points.

The card is the default: an entry point asked for ``"cuda"`` on a
machine without one raises :class:`CudaUnavailableError` instead of
quietly running on the CPU. The CPU is used only when the caller names
it (the tests do).
"""

from __future__ import annotations

from typing import Union

import torch


class CudaUnavailableError(RuntimeError):
    """A CUDA device was asked for and this process has none."""


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises
    :class:`CudaUnavailableError` for a CUDA device when
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev
