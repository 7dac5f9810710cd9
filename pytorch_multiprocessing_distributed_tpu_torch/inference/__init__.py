"""KV-cached generation (the port of the JAX package's inference)."""

from .generate import (beam_search, generate,  # noqa: F401
                       teacher_forced_logits)
from .tp import shard_params_for_tp_decode  # noqa: F401
