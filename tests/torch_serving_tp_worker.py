"""Ranks of the port's tensor-parallel serving on the CPU, for
``tests/test_torch_serving_tp*.py``: started by ``torch.multiprocessing``
with the gloo backend, one intra-op thread each, on a ``(1, world)``
grid. jax-free, so the spawned processes import PyTorch only. Each rank
writes its results to ``{out_path}.{rank}``."""

import torch

from torch_sp_worker import _join


def _bound(geometry, params):
    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT

    model = GPT(**geometry)
    model.load_state_dict({k: v.clone() for k, v in params.items()},
                          assign=True)
    return model


def serve_rank(rank, world, port, inputs_path, out_path):
    """Every case of ``inputs["engine"]`` through ``ServingEngine(mesh=
    grid)`` (transcripts, prefix outcomes, the pool's bytes, the shard's
    resident bytes and all-gathers) and every case of
    ``inputs["generate"]`` through ``generate(mesh=grid)``."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.inference import (
        generate)
    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine)

    grid = make_grid(1, world)
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for name, case in inputs["engine"].items():
        kw = dict(case["kw"])
        if kw.pop("draft", False):
            # replicated and unsharded on every rank, as in JAX
            kw.update(draft_model=GPT(**inputs["draft_geometry"]),
                      draft_params=inputs["draft_params"])
        if kw.get("temperature"):
            kw["generator"] = torch.Generator().manual_seed(case["seed"])
        engine = ServingEngine(_bound(inputs["geometry"], inputs["params"]),
                               mesh=grid, **kw)
        served = engine.serve(case["requests"])
        tp = engine.model.tp
        out[name] = {"tokens": [r.tokens for r in served],
                     "prefix_hit": [r.prefix_hit for r in served],
                     "kv_bytes": engine.pool.kv_bytes,
                     "kv_shape": tuple((engine.pool.k_pages
                                        if kw.get("kv_layout") == "paged"
                                        else engine.pool.k_caches).shape),
                     "resident": tp.resident_bytes,
                     "decode_gathers": engine.decode_gathers,
                     "passes": sum(engine.passes_by_k.values())}
    for name, case in inputs["generate"].items():
        model = _bound(case.get("geometry", inputs["geometry"]),
                       case.get("params", inputs["params"]))
        kw = dict(case["kw"])
        if kw.get("temperature"):
            kw["generator"] = torch.Generator().manual_seed(case["seed"])
        out[name] = {"tokens": generate(model, case["prompt"], mesh=grid,
                                        **kw).tolist()}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()


def lockstep_rank(rank, world, port, inputs_path, out_path):
    """``serve_lm``'s store lockstep over ``ServingEngine(mesh=grid)``:
    rank 0 submits ``inputs["requests"]`` (prompt, max_new, deadline_s)
    and steps ``inputs["steps"]`` times, then drains under
    ``inputs["drain_s"]``, every clock decision its own; the other ranks
    replay it. Each rank writes every request's (state, reason, tokens)
    and its engine's failure count."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        Request, ServingEngine)

    grid = make_grid(1, world)
    inputs = torch.load(inputs_path, weights_only=False)
    engine = ServingEngine(_bound(inputs["geometry"], inputs["params"]),
                           mesh=grid, **inputs["kw"])
    lock = serve_lm._Lockstep(engine, dist.StoreBroadcast("test/lockstep"))
    seen = {}
    real_enqueue = engine.enqueue

    def enqueue(request):  # every rank keeps its own records
        seen[request.uid] = request
        return real_enqueue(request)

    engine.enqueue = enqueue
    if rank == 0:
        for i, (prompt, max_new, deadline_s) in enumerate(
                inputs["requests"]):
            lock.enqueue(Request(prompt, max_new, uid=f"d{i}",
                                 deadline_s=deadline_s))
        for _ in range(inputs["steps"]):
            lock.step()
        lock.drain(inputs["drain_s"])
    else:
        lock.follow()
    torch.save({"states": {uid: (r.state, r.finish_reason, r.tokens)
                           for uid, r in seen.items()},
                "failed": engine.metrics.requests_failed},
               f"{out_path}.{rank}")
    dist.barrier()
    dist.destroy_process_group()
