"""KV-cached generation (the port of the JAX package's inference)."""

from .generate import generate, teacher_forced_logits  # noqa: F401
from .tp import shard_params_for_tp_decode  # noqa: F401
