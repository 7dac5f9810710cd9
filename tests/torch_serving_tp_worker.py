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
