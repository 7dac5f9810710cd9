"""Shared cases of the fault-tolerant serving tests
(``tests/test_torch_serving_{journal,faults,restart}.py``): the tiny GPT
of ``tests/test_graftfault.py`` carried from JAX, its prompts, and one
run of an engine (the JAX package's or the port's) reduced to what the
two must agree on."""

import numpy as np

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)

GEOM = dict(vocab_size=61, max_seq_len=64, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
# the engine of tests/test_graftfault.py's chaos fixture, whole-prompt
ENGINE_KW = dict(max_slots=2, s_max=32, min_bucket=8, decode_horizon=4,
                 retry_backoff_s=0.0)
# the snapshot counters the two engines must agree on under a fault
COUNTS = ("dispatch_retries", "requests_failed", "requests_redelivered",
          "watchdog_trips", "horizon_collapses")


def models(seed: int = 1):
    """(JAX GPT, its params, the port's GPT bound to the same params)."""
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, seed)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    return jmodel, jparams, model


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, GEOM["vocab_size"], (n,)).tolist()
            for n in (3, 7, 12, 5)]


def outcome(engine, requests, new_tokens: int = 4, deadlines=None):
    """Submit ``requests`` as ``r0, r1, ...`` (``deadlines[i]`` each,
    None = none) and run the engine to its end: the raised error's class
    (None when it drained), the finished transcripts, the failed uids
    with their reason and error class, and the fault counters' moves."""
    deadlines = deadlines or [None] * len(requests)
    before = engine.metrics.snapshot()
    reqs = [engine.submit(p, new_tokens, uid=f"r{i}", deadline_s=d)
            for i, (p, d) in enumerate(zip(requests, deadlines))]
    error = None
    try:
        for _ in engine.run():
            pass
    except Exception as e:  # compared by class with the other engine's
        error = type(e).__name__
    snap = engine.metrics.snapshot()
    return dict(
        error=error,
        tokens={r.uid: r.tokens for r in reqs if r.state == "done"},
        failed={r.uid: (r.finish_reason, type(r.error).__name__)
                for r in reqs if r.state == "failed"},
        counts={k: snap[k] - before[k] for k in COUNTS})


def _flat(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            yield from _flat(val, path)
        else:
            yield path, np.asarray(val)


def tiny_ckpts(tmp):
    """JAX ``init_params(gpt_tiny, 0)`` written for both CLIs: an
    ``.npz`` of the flattened tree (the port's ``--ckpt``) and a msgpack
    checkpoint (the JAX CLI's). Returns their paths."""
    from flax import serialization

    params = jax_init_params(jax_models.get_model("gpt_tiny",
                                                  attn_impl="xla"), 0)
    npz, msgpack = tmp / "tiny.npz", tmp / "tiny.msgpack"
    np.savez(npz, **dict(_flat(params)))
    msgpack.write_bytes(serialization.msgpack_serialize(
        {"params": serialization.to_state_dict(params)}))
    return str(npz), str(msgpack)
