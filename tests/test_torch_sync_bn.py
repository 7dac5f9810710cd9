"""The port's ``SyncBatchNorm`` at world size 2 (two gloo ranks spawned
through ``torch.multiprocessing``) against the JAX ``SyncBatchNorm``
under ``shard_map`` over 2 virtual devices, on the same numpy input
split the same way.

Each rank's output, each rank's input gradient of the GLOBAL loss
``sum(y * c)`` (the gradient flows through the all-reduced statistics,
as through ``lax.pmean``) and the running stats agree within 1e-5
absolute: the same f32 statistics summed in another order.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu.ops.batch_norm import (
    SyncBatchNorm as JaxSyncBatchNorm)
from pytorch_multiprocessing_distributed_tpu.utils.compat import shard_map
from pytorch_multiprocessing_distributed_tpu_torch.ops.batch_norm import (
    SyncBatchNorm)

from torch_image_worker import spawn_ranks, sync_bn_rank

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 3, 3, 5)) * 2 + 1).astype(np.float32)
    c = rng.normal(size=(4, 3, 3, 5)).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                   "bias": rng.normal(0, 0.1, 5).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.1, 5).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}}
    return x, c, variables


def _jax_reference(x, c, variables):
    """Per-rank (y, dx) and the running stats under shard_map on 2
    devices: each rank differentiates its own ``sum(y * c)``; the pmean's
    transpose carries the other rank's part of the gradient."""
    bn = JaxSyncBatchNorm(axis_name="data")

    def local(x, c):
        def loss(x):
            y, mut = bn.apply(variables, x, use_running_average=False,
                              mutable=["batch_stats"])
            return (y * c).sum(), (y, mut["batch_stats"])

        dx, (y, stats) = jax.grad(loss, has_aux=True)(x)
        return y, dx, stats

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    fn = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P()), check_vma=False)
    return jax.device_get(jax.jit(fn)(x, c))


def _state(variables):
    return {"weight": torch.from_numpy(variables["params"]["scale"]),
            "bias": torch.from_numpy(variables["params"]["bias"]),
            "running_mean": torch.from_numpy(
                variables["batch_stats"]["mean"]),
            "running_var": torch.from_numpy(
                variables["batch_stats"]["var"])}


def test_world2_matches_jax_pmean(case, tmp_path):
    x, c, variables = case
    y, dx, stats = _jax_reference(x, c, variables)
    inputs = tmp_path / "inputs.pt"
    torch.save({"x": torch.from_numpy(x), "c": torch.from_numpy(c),
                "state": _state(variables)}, inputs)
    spawn_ranks(sync_bn_rank, 2, (str(inputs), str(tmp_path)))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=True)
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(got["y"].numpy(), y[rows], atol=TOL)
        np.testing.assert_allclose(got["dx"].numpy(), dx[rows], atol=TOL)
        np.testing.assert_allclose(got["running_mean"].numpy(),
                                   stats["mean"], atol=TOL)
        np.testing.assert_allclose(got["running_var"].numpy(),
                                   stats["var"], atol=TOL)


def test_world1_matches_plain_jax_and_eval_mode(case):
    """One process (no collective): train mode against the JAX layer
    without an axis, then eval mode normalizes with the running stats."""
    x, c, variables = case
    bn = JaxSyncBatchNorm()

    def loss(x):
        y, mut = bn.apply(variables, x, use_running_average=False,
                          mutable=["batch_stats"])
        return (y * c).sum(), (y, mut["batch_stats"])

    dx, (y, stats) = jax.device_get(jax.grad(loss, has_aux=True)(x))
    port = SyncBatchNorm(5)
    port.load_state_dict(_state(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = port(xt)
    (out * torch.from_numpy(c).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), y,
                               atol=TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), dx,
                               atol=TOL)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"],
                               atol=TOL)
    port.eval()
    ref = bn.apply({"params": variables["params"], "batch_stats": stats},
                   x, use_running_average=True)
    np.testing.assert_allclose(
        port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
        .permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=TOL)
