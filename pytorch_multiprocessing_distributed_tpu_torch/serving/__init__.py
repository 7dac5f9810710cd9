"""Continuous-batching serving (the port of the JAX package's
``serving``: dense or paged KV, model dtype or int8, whole or chunked
prefill, the shared-prefix cache, speculative decode, and the
in-process fleet of replicas behind one router)."""

from .engine import ServingEngine  # noqa: F401
from .kv_pages import (PagePool, PagePoolExhausted,  # noqa: F401
                       PrefixCache, PrefixEntry)
from .kv_slots import SlotPool  # noqa: F401
from .params import (from_jax_params, from_jax_pipeline_params,  # noqa: F401
                     init_params, load_params)
from .replica import ROLES, PageTransfer, ServingReplica  # noqa: F401
from .router import (FleetDead, FleetSaturated,  # noqa: F401
                     PrefixCacheDirectory, Router)
from .scheduler import (FIFOScheduler, PrefillPlan,  # noqa: F401
                        QueueFull, Request, RequestWithdrawn,
                        bucket_length, pick_draft_k, pick_horizon)
from .spec import NgramDrafter, ngram_bucket  # noqa: F401
