"""Continuous-batching serving (the port of the JAX package's
``serving``, dense single-engine subset)."""

from .engine import ServingEngine  # noqa: F401
from .kv_slots import SlotPool  # noqa: F401
from .params import from_jax_params, init_params, load_params  # noqa: F401
from .scheduler import (FIFOScheduler, QueueFull, Request,  # noqa: F401
                        bucket_length, pick_horizon)
