"""The port's ring all-reduce (``ops/ring_allreduce.py``) against the JAX
package's ``ring_all_reduce`` (the Pallas RDMA ring, run as
``tests/test_pallas_kernels.py`` runs it: under ``shard_map`` on the
virtual CPU mesh, in interpret mode) on the same numpy inputs.

Tolerance 0 (bit-equal) against the JAX ring: both pad to the same
``[rows, 128]`` layout and add each element's ranks in the same order,
``x[c+n-1] + (... + (x[c+1] + x[c]))``, in f32, and cast back alike.
Against ``lax.psum`` (another summation order) 1e-5, the JAX test's
tolerance, on the f32 inputs. The plain list form and the gloo form (the
same hops as ``isend``/``irecv`` between spawned ranks) are both held to
the JAX ring; the CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu.ops.pallas import (
    ring_all_reduce as jax_ring_all_reduce)
from pytorch_multiprocessing_distributed_tpu_torch import allreduce_bw
from pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce import (
    ring_all_reduce, ring_all_reduce_loopback, ring_layout,
    torch_ring_all_reduce)
from torch_image_worker import spawn_ranks
from torch_ring_worker import ring_rank

REPO = Path(__file__).resolve().parents[1]
# per-rank shape and dtype of each case; values are normal * 1e3
CASES = {
    "f32_40x33": ((40, 33), "float32"),
    "one": ((1,), "float32"),
    "ragged_3007": ((3 * 1000 + 7,), "float32"),
    "bf16_40x33": ((40, 33), "bfloat16"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name, n):
    """``(n, *shape)`` f32 numpy inputs of a case, seeded by n."""
    shape, _ = CASES[name]
    rng = np.random.default_rng(n)
    return (rng.normal(size=(n, *shape)) * 1e3).astype(np.float32)


def _shard_map(fn, n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    return jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                                 in_specs=P("x"), out_specs=P("x"),
                                 check_vma=False))


@functools.lru_cache(maxsize=None)
def _jax_ring(name, n):
    """The JAX ring's result for every rank, as numpy."""
    x = jnp.asarray(_case(name, n), CASES[name][1])
    return np.asarray(_shard_map(lambda v: jax_ring_all_reduce(v, "x"),
                                 n)(x))


def _torch_inputs(name, n):
    dtype = getattr(torch, CASES[name][1])
    return torch.from_numpy(_case(name, n)).to(dtype)


def _bits(a):
    """The raw bits of an f32 or bf16 array or tensor, as numpy."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
        return a.numpy()
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_ring_bit_equal_to_jax_ring(n, name):
    want = _jax_ring(name, n)
    x = _torch_inputs(name, n)
    got = torch_ring_all_reduce(list(x))
    assert len(got) == n
    for r in range(n):
        assert got[r].shape == x[r].shape and got[r].dtype == x[r].dtype
        np.testing.assert_array_equal(_bits(got[r]), _bits(want[r]))
    # the loopback entry on CPU tensors is the plain version
    for g, w in zip(ring_all_reduce_loopback(list(x)), want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_ring_matches_psum(n):
    """Within 1e-5 of ``lax.psum`` (the JAX test's tolerance) on the JAX
    test's unscaled normal inputs, at every f32 case's shape."""
    for name, (shape, dtype) in CASES.items():
        if dtype != "float32":
            continue
        rng = np.random.default_rng(n)
        x = rng.normal(size=(n, *shape)).astype(np.float32)
        want = np.asarray(_shard_map(lambda v: jax.lax.psum(v, "x"), n)(
            jnp.asarray(x)))
        got = torch_ring_all_reduce(list(torch.from_numpy(x)))
        for r in range(n):
            np.testing.assert_allclose(got[r].numpy(), want[r], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ring_bit_equal_to_jax_ring(world, tmp_path):
    """One spawn per world size: every case through ``ring_all_reduce``
    on CPU tensors in a gloo group of ``world`` ranks."""
    inputs = {name: _torch_inputs(name, world) for name in CASES}
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    spawn_ranks(ring_rank, world, (str(path), str(tmp_path)))
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        for name in CASES:
            assert got[name].dtype == inputs[name].dtype
            np.testing.assert_array_equal(_bits(got[name]),
                                          _bits(_jax_ring(name, world)[r]))


def test_ring_layout_is_the_jax_padding():
    # rows of 128 lanes, rounded up to a multiple of 8n
    assert ring_layout(1, 8) == (64, 1024, 8192)
    assert ring_layout(3007, 4) == (32, 1024, 4096)
    assert ring_layout(40 * 33, 2) == (16, 1024, 2048)
    assert ring_layout(4_903_242, 4) == (38336, 1226752, 4907008)
    for size, n in ((1, 2), (129, 3), (4096, 4), (1_000_003, 8)):
        rows, chunk, padded = ring_layout(size, n)
        assert rows % (8 * n) == 0 and padded == rows * 128 >= size
        assert chunk * n == padded and padded - size < 8 * n * 128


def test_world_of_one_returns_the_input():
    """As JAX's ``ring_all_reduce`` returns ``x`` for an axis of one."""
    x = torch.arange(6.0).view(2, 3)
    assert ring_all_reduce(x) is x
    assert torch_ring_all_reduce([x])[0] is x
    assert ring_all_reduce_loopback([x])[0] is x


def test_impl_rules():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ring_all_reduce(x, impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ring_all_reduce_loopback([x, x], impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ring_all_reduce(x, impl="pallas")
    with pytest.raises(ValueError, match="rank 1's tensor"):
        torch_ring_all_reduce([x, torch.ones(11)])
    with pytest.raises(ValueError, match="rank 1's tensor"):
        ring_all_reduce_loopback([x, x.double()])
    with pytest.raises(ValueError, match="at least one"):
        torch_ring_all_reduce([])


def test_allreduce_bw_cli_gloo_world2():
    """The twin of ``benchmarks/allreduce_bw.py`` on two gloo ranks: one
    line per payload and implementation with the JAX script's keys; the
    ring checked bit for bit first."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "pytorch_multiprocessing_distributed_tpu_torch.allreduce_bw",
         "--device", "cpu", "--world_size", "2", "--ring", "--check",
         "--sizes-mb", "0.01", "--iters", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    assert [d["metric"] for d in lines] == ["psum_gloo_allreduce_bus_bw",
                                            "gloo_ring_allreduce_bus_bw"]
    for d in lines:
        assert {"metric", "payload_mb", "devices", "time_ms",
                "bus_gb_per_sec", "platform"} <= set(d)
        assert (d["payload_mb"], d["devices"], d["platform"]) == (0.01, 2,
                                                                  "cpu")
        assert d["time_ms"] > 0
        size = int(0.01 * 2 ** 20)
        assert d["bus_gb_per_sec"] == pytest.approx(
            size / d["time_ms"] * 1e3 / 2 ** 30)
    assert lines[1]["max_abs_err"] == 0.0


def test_allreduce_bw_loopback_and_device_rules(capsys):
    lines = allreduce_bw.main(["--device", "cpu", "--loopback", "4",
                               "--check", "--sizes-mb", "0.05", "--iters",
                               "1"])
    assert [d["metric"] for d in lines] == [
        "plain_ring_loopback_allreduce_bus_bw"]
    assert lines[0]["devices"] == 4 and lines[0]["max_abs_err"] == 0.0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == lines[0]
    with pytest.raises(SystemExit, match="--loopback takes"):
        allreduce_bw.main(["--device", "cpu", "--loopback", "1"])
    if not torch.cuda.is_available():  # the card is the default
        from pytorch_multiprocessing_distributed_tpu_torch.device import (
            CudaUnavailableError)
        with pytest.raises(CudaUnavailableError):
            allreduce_bw.main(["--sizes-mb", "0.01"])
