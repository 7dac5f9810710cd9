"""Continuous-batching serving (the port of the JAX package's
``serving``, single-engine subset: dense or paged KV, model dtype or
int8, whole or chunked prefill, the shared-prefix cache, speculative
decode)."""

from .engine import ServingEngine  # noqa: F401
from .kv_pages import (PagePool, PagePoolExhausted,  # noqa: F401
                       PrefixCache, PrefixEntry)
from .kv_slots import SlotPool  # noqa: F401
from .params import (from_jax_params, from_jax_pipeline_params,  # noqa: F401
                     init_params, load_params)
from .scheduler import (FIFOScheduler, PrefillPlan,  # noqa: F401
                        QueueFull, Request, bucket_length, pick_draft_k,
                        pick_horizon)
from .spec import NgramDrafter, ngram_bucket  # noqa: F401
