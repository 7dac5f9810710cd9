"""Shared cases of ``tests/test_torch_serving_tp*.py``: the port's
tensor-parallel serving (``ServingEngine(mesh=grid)``, ``generate(mesh=
grid)``) on spawned gloo ranks of a ``(1, M)`` grid against the JAX
package's TP engine and ``generate`` on ``make_mesh(8 // M, M)`` of the
root conftest's virtual CPU devices, on the same numpy params (gpt_tiny,
f32: 4 heads, so M = 4 gives each rank one head).

JAX draws its samples from ``jax.random``, the port from a
``torch.Generator``: no sampled stream can be token-exact across the two
frameworks. The sampled cases therefore hold the port's TP transcripts
against the port's single-shard ones from the same seed (JAX pins its
own TP sampling against its single-shard sampling in
``tests/test_generate.py``)."""

import jax
import numpy as np
import torch
import torch.multiprocessing as mp

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference import (
    generate as jax_generate, shard_params_for_tp_decode as jax_shard)
from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, from_jax_params, init_params)
from torch_serving_tp_worker import serve_rank

from sp_cases import free_port

# gpt_tiny's geometry
GEOM = dict(vocab_size=257, max_seq_len=256, hidden_size=128,
            num_layers=4, num_heads=4, mlp_dim=512)
MOE = dict(GEOM, n_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
COMMON = dict(max_slots=3, s_max=16, min_bucket=8)
PAGED = dict(kv_layout="paged", page_size=8)
SAMPLING = dict(temperature=0.8, top_k=17)
# name: the engine's options (``draft``: a replicated gpt_tiny draft)
ENGINE_CASES = {
    "dense": {},
    "chunked": dict(prefill_chunk=4),
    "paged_prefix": dict(PAGED, prefix_cache=4),
    "int8_dense": dict(kv_dtype="int8"),
    "int8_paged": dict(PAGED, kv_dtype="int8"),
    "horizon4": dict(decode_horizon=4),
    "ngram_k3": dict(draft_k=3),
    "draft_model_k3": dict(draft_k=3, draft=True),
    "sampled": dict(SAMPLING),
}
NEW_TOKENS = 5
SEED = 7


def prompts():
    """Four ragged prompts, then the third again (a full prefix hit) and
    its first page with a new tail (a partial hit)."""
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 257, (n,)).tolist() for n in (3, 7, 11, 5)]
    return out + [list(out[2]), out[2][:8] + [1, 2]]


def gen_prompt():
    return np.random.default_rng(5).integers(0, 257, (2, 9))


def _tree(geometry, seed):
    """A JAX param tree (nested numpy) of the port's random init: drawn
    by ``serving.init_params`` (JAX's initialisers, a torch generator),
    so no JAX init program is compiled."""
    model = GPT(**geometry)
    tree = {}
    for name, t in init_params(model, seed, "cpu").items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.numpy()
    return tree


def jax_setup():
    """The JAX target, its draft and the MoE model, and their params
    (numpy trees)."""
    return dict(model=jax_models.GPT(attn_impl="xla", **GEOM),
                params=_tree(GEOM, 1),
                draft=jax_models.GPT(attn_impl="xla", **GEOM),
                draft_params=_tree(GEOM, 2),
                moe=jax_models.GPT(attn_impl="xla", **MOE),
                moe_params=_tree(MOE, 3))


def _engine_kw(name):
    return dict(COMMON, **ENGINE_CASES[name])


def run(world, ref, tmp, engine, gen=()):
    """The named ``engine`` cases and ``gen`` cases of ``generate``
    (``greedy``, ``sampled``, ``moe``: a top-2 MoE gpt_tiny, greedy) on
    ``world`` spawned gloo ranks, and JAX's references of the same cases
    computed while the ranks run: ``{"ranks": every rank's results (the
    ranks must agree), "jax": {case: JAX's}}``."""
    requests = [(p, NEW_TOKENS) for p in prompts()]
    gen_cases = {"greedy": dict(kw=dict(max_new_tokens=8)),
                 "sampled": dict(kw=dict(max_new_tokens=8, **SAMPLING),
                                 seed=SEED),
                 "moe": dict(kw=dict(max_new_tokens=6), geometry=MOE,
                             params=from_jax_params(ref["moe_params"]))}
    gen_cases = {f"gen_{name}": gen_cases[name] for name in gen}
    for case in gen_cases.values():
        case["prompt"] = torch.from_numpy(gen_prompt())
    inputs = {
        "geometry": GEOM, "params": from_jax_params(ref["params"]),
        "draft_geometry": GEOM,
        "draft_params": from_jax_params(ref["draft_params"]),
        "engine": {name: dict(kw=_engine_kw(name), requests=requests,
                              seed=SEED) for name in engine},
        "generate": gen_cases}
    path, out = tmp / "inputs.pt", tmp / "out"
    torch.save(inputs, path)
    ctx = mp.start_processes(
        serve_rank, args=(world, free_port(), str(path), str(out)),
        nprocs=world, join=False, start_method="spawn")
    try:
        jax_refs = {name: jax_engine(ref, name, world) for name in engine
                    if name != "sampled"}
        if "greedy" in gen:
            jax_refs["gen_greedy"] = jax_generate_tp(ref, world)
        if "moe" in gen:
            jax_refs["gen_moe"] = jax_generate_tp(ref, world, moe=True)
        while not ctx.join(timeout=300):
            pass
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
    ranks = [torch.load(f"{out}.{r}", weights_only=False)
             for r in range(world)]
    for other in ranks[1:]:  # every rank streams the same tokens
        for name, got in other.items():
            assert got["tokens"] == ranks[0][name]["tokens"], name
    return {"ranks": ranks, "jax": jax_refs}


def jax_engine(ref, name, world):
    """JAX's TP engine on ``make_mesh(8 // world, world)``: the case's
    transcripts and prefix outcomes."""
    mesh = make_mesh(8 // world, world)
    kw = _engine_kw(name)
    if kw.pop("draft", False):
        kw.update(draft_model=ref["draft"], draft_params=ref["draft_params"])
    engine = JaxEngine(ref["model"], jax_shard(ref["params"], mesh),
                       mesh=mesh, **kw)
    served = engine.serve([(np.asarray(p), NEW_TOKENS) for p in prompts()])
    return ([[int(t) for t in r.tokens] for r in served],
            [r.prefix_hit for r in served])


def jax_generate_tp(ref, world, moe=False):
    mesh = make_mesh(8 // world, world)
    model, params = ((ref["moe"], ref["moe_params"]) if moe
                     else (ref["model"], ref["params"]))
    out = jax_generate(model, jax_shard(params, mesh),
                       jax.numpy.asarray(gen_prompt()),
                       max_new_tokens=6 if moe else 8, mesh=mesh)
    return np.asarray(out).tolist()


def port_single(ref, name):
    """The port's single-shard engine on one case (the sampled pin)."""
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(ref["params"]), assign=True)
    kw = _engine_kw(name)
    if kw.get("temperature"):
        kw["generator"] = torch.Generator().manual_seed(SEED)
    engine = ServingEngine(model, **kw)
    served = engine.serve([(p, NEW_TOKENS) for p in prompts()])
    return [r.tokens for r in served], engine


def port_single_generate(ref):
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(ref["params"]), assign=True)
    return generate(model, torch.from_numpy(gen_prompt()), max_new_tokens=8,
                    generator=torch.Generator().manual_seed(SEED),
                    **SAMPLING).tolist()


def jax_device_bytes(params, world):
    """JAX's bytes a device of ``shard_params_for_tp_decode``'s tree,
    in all and of the LayerNorm leaves."""
    tree = jax_shard(params, make_mesh(8 // world, world))
    total = small = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = leaf.addressable_shards[0].data.nbytes
        total += n
        if len(path) > 1 and path[-2].key in ("ln1", "ln2", "ln_final"):
            small += n
    return total, small


# ---- the checks, shared by the files of each grid ----------------------

def check_engine(runs, name):
    """Rank 0's transcripts and prefix outcomes equal JAX's TP engine's
    on the case (token-exact)."""
    ranks = runs["ranks"]
    tokens, hits = runs["jax"][name]
    assert ranks[0][name]["tokens"] == tokens
    assert ranks[0][name]["prefix_hit"] == hits
    if name == "paged_prefix":
        assert hits[-2:] == ["full", "partial"]


def check_sampled(runs, ref):
    want, _ = port_single(ref, "sampled")
    assert runs["ranks"][0]["sampled"]["tokens"] == want


def check_generate(runs, ref):
    rank0 = runs["ranks"][0]
    assert rank0["gen_greedy"]["tokens"] == runs["jax"]["gen_greedy"]
    assert rank0["gen_sampled"]["tokens"] == port_single_generate(ref)


def check_resident(runs, ref, world):
    """Every rank holds JAX's per-device bytes of
    ``shard_params_for_tp_decode``'s tree, but for the LayerNorm leaves,
    held whole and counted apart."""
    from pytorch_multiprocessing_distributed_tpu_torch.inference.tp import (
        SMALL_LEAVES)

    jax_total, jax_small = jax_device_bytes(ref["params"], world)
    names = {f"block_{i}.{leaf}" for i in range(GEOM["num_layers"])
             for leaf in SMALL_LEAVES[:4]} | {"ln_final.scale",
                                              "ln_final.bias"}
    for rank in runs["ranks"]:
        res = rank["dense"]["resident"]
        assert res["jax_params"] == jax_total
        assert res["small_jax"] == jax_small
        assert set(res["small_leaves"]) == names
        assert (res["params"] - sum(res["small_leaves"].values())
                == jax_total - jax_small)


def check_kv_pool(runs, ref, name, world):
    """A rank's pool holds the one-rank pool's bytes over M, its heads
    axis cut by M."""
    _, single = port_single(ref, name)
    got = runs["ranks"][0][name]
    assert got["kv_bytes"] * world == single.pool.kv_bytes
    pool = single.pool
    full = tuple((pool.k_pages if "paged" in name else pool.k_caches).shape)
    head_axis = 2 if "paged" in name else 3
    assert got["kv_shape"] == (full[:head_axis]
                               + (full[head_axis] // world,)
                               + full[head_axis + 1:])


def check_gathers(runs):
    """One all-gather a decode step for the embeddings and four a layer
    (attention's output, wo's, fc1's after the GELU, fc2's); the head is
    whole."""
    got = runs["ranks"][0]["dense"]
    assert got["decode_gathers"] == got["passes"] * (
        1 + 4 * GEOM["num_layers"])
