"""KV-cached generation (the port of the JAX package's inference)."""

from .generate import generate  # noqa: F401
