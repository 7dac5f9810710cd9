"""The port's ``ViT(seq_axis="seq")`` against the JAX package's, in f32
on the CPU.

Each rank of the seq axis embeds its own images (patches, class token,
positions) and the encoder's attention runs over the ring, its keys and
values the union of every rank's sequence (JAX ``models/vit.py``).
JAX's ViT runs under ``shard_map`` on 2 of the conftest's virtual CPU
devices (its ring through the Pallas flash kernels in interpret mode);
the port's on 2 gloo ranks (``tests/torch_sp_worker.py:vit_rank``,
PyTorch's native convolutions), on the same numpy weights (carried by
``load_jax_vit``), the same per-rank images and the same per-rank logit
cotangent. Each rank's logits and its parameter gradients agree within
1e-5 of each tensor's largest magnitude (at least 1e-5), the zoo tests'
bound (``tests/test_torch_model_zoo.py``): a gradient sums over the
batch and the tokens, up to ~20 here. With the same images on both
ranks the ring gives one device's logits, as attention over two equal
blocks does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu.models import vit as jax_vit
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    ViT, load_jax_vit)

from sp_cases import free_port
from torch_sp_worker import vit_rank
from zoo_carry import random_variables

GEOM = dict(patch_size=4, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, num_classes=10)
IMAGE, BATCH, WORLD = 8, 2, 2
TOL = 1e-5


def _bound(want):
    """1e-5 of the tensor's largest magnitude, at least 1e-5."""
    return TOL * max(1.0, float(np.abs(want).max()))


@pytest.fixture(autouse=True)
def _torch_cpu_state():
    """One intra-op thread and PyTorch's native convolutions, restored
    after."""
    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn


@pytest.fixture(scope="module")
def case():
    params, _ = random_variables(jax_vit.ViT(**GEOM),
                                 (BATCH, IMAGE, IMAGE, 3))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(WORLD, BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    c = rng.normal(size=(WORLD, BATCH, 10)).astype(np.float32)
    return params, x, c


def _jax_ranks(params, x, c):
    """Each device's logits and the gradients of its local loss, JAX's
    ViT under ``shard_map`` over a ``seq`` axis of WORLD devices."""
    model = jax_vit.ViT(seq_axis="seq", **GEOM)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))

    def local(p, xs, cs):
        def loss(q):
            logits = model.apply({"params": q}, xs[0])
            return (logits * cs[0]).sum(), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return logits[None], jax.tree.map(lambda g: g[None], grads)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), P("seq"), P("seq")),
                       out_specs=(P("seq"), P("seq")), check_vma=False)
    logits, grads = jax.jit(fn)(params, jnp.asarray(x), jnp.asarray(c))
    return np.asarray(logits), jax.device_get(grads)


def _port_ranks(params, x, c, tmp):
    path, out = tmp / "inputs.pt", tmp / "out"
    torch.save({"geometry": dict(GEOM, image_size=IMAGE),
                "state": load_jax_vit(params), "x": torch.from_numpy(x),
                "c": torch.from_numpy(c)}, path)
    mp.spawn(vit_rank, args=(WORLD, free_port(), str(path), str(out)),
             nprocs=WORLD, join=True)
    return [torch.load(f"{out}.{r}", weights_only=True)
            for r in range(WORLD)]


def test_vit_seq_logits_and_grads_match_jax_shard_map(case, tmp_path):
    params, x, c = case
    ranks = _port_ranks(params, x, c, tmp_path)
    logits, grads = _jax_ranks(params, x, c)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"].numpy(), logits[r],
                                   atol=_bound(logits[r]), rtol=0,
                                   err_msg=f"rank {r}")
        want = load_jax_vit(jax.tree.map(lambda g: g[r], grads))
        assert set(want) == set(got["grads"])
        for name, g in want.items():
            np.testing.assert_allclose(
                got["grads"][name].numpy(), g.numpy(), atol=_bound(g.numpy()),
                rtol=0, err_msg=f"rank {r} {name}")


def test_vit_seq_on_equal_blocks_is_one_device(case, tmp_path):
    """The same images on both ranks: every rank's logits are the
    single-device ViT's (attention over two equal blocks)."""
    params, x, c = case
    same = np.stack([x[0]] * WORLD)
    ranks = _port_ranks(params, same, c, tmp_path)
    one = ViT(**GEOM, image_size=IMAGE)
    one.load_state_dict(load_jax_vit(params))
    with torch.no_grad():
        want = one(torch.from_numpy(x[0])).numpy()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"].numpy(), want,
                                   atol=_bound(want), rtol=0,
                                   err_msg=f"rank {r}")
