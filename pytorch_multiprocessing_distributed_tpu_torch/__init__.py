"""PyTorch + CUDA port of the framework, for NVIDIA Hopper (H100).

The JAX package ``pytorch_multiprocessing_distributed_tpu`` is the
reference; this package reproduces its behaviour in PyTorch, one slice
at a time, and replaces each Pallas TPU kernel with a kernel written by
hand for ``sm_90a``. It imports neither ``jax`` nor anything of the JAX
package: whatever it needs from there is copied in.

Ported so far: the continuous-batching serving path (``serve_lm``) on
the GPT family, dense KV slots, with the flash-decode attention kernel
in CUDA C++ (:mod:`.ops.decode_attention`).

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no card they raise :class:`CudaUnavailableError`.
"""

from .device import CudaUnavailableError, resolve_device  # noqa: F401
