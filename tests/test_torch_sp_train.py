"""The port's chunked CE and sequence-parallel LM step on a (1, 2) grid
against the JAX package's.

``chunked_lm_ce``: values and the gradients of h, kernel, bias and
weights against JAX's, with and without a bias, at gpt_tiny's vocab of
257, which no chunk count here divides.

The SP step (``tests/sp_cases.py``): losses and params after 3 f32 SGD
steps, and the eval step, within 1e-5 of JAX's on a (data 1, seq 2)
grid in each ``sp_mode`` and with ``vocab_chunks``; the (2, 2) grid is
``tests/test_torch_sp_grid.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops import losses as jax_losses
from pytorch_multiprocessing_distributed_tpu_torch.ops.losses import (
    chunked_lm_ce)

import sp_cases

GRID = (1, 2)
RUNS = [("ring", 0), ("zigzag", 0), ("ulysses", 0), ("ring", 5)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("chunks", [3, 8])
@pytest.mark.parametrize("bias", [True, False])
def test_chunked_lm_ce_matches_jax(chunks, bias):
    rng = np.random.default_rng(chunks)
    b, s, d, v = 2, 5, 16, 257
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    bvec = rng.normal(size=(v,)).astype(np.float32) if bias else None
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    weights = (rng.random((b, s)) > 0.2).astype(np.float32)

    def jfn(h_, k_, b_, w_):
        return jax_losses.chunked_lm_ce(h_, k_, b_, jnp.asarray(targets),
                                        w_, chunks)

    args = [jnp.asarray(h), jnp.asarray(kernel),
            None if bvec is None else jnp.asarray(bvec),
            jnp.asarray(weights)]
    argnums = (0, 1, 2, 3) if bias else (0, 1, 3)
    ref = jax.value_and_grad(jfn, argnums=argnums)(*args)
    ts = [torch.from_numpy(x).requires_grad_() if x is not None else None
          for x in (h, kernel, bvec, weights)]
    got = chunked_lm_ce(ts[0], ts[1], ts[2], torch.from_numpy(targets),
                        ts[3], chunks)
    got.backward()
    assert abs(got.item() - float(ref[0])) < 1e-4
    # the dense value: the logits and each row's log-sum-exp in one piece
    logits = h.reshape(-1, d) @ kernel + (0 if bvec is None else bvec)
    top = logits.max(1)
    dense = (np.log(np.exp(logits - top[:, None]).sum(1)) + top
             - logits[np.arange(b * s), targets.reshape(-1)])
    assert abs(got.item() - float((dense * weights.reshape(-1)).sum())
               ) < 1e-3
    grads = [t.grad for t in ts if t is not None]
    for g, want in zip(grads, ref[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=sp_cases.TOL, rtol=0)


@pytest.fixture(scope="module")
def init():
    return sp_cases.jax_init()


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return sp_cases.port_run(GRID, RUNS, *init,
                             tmp_path_factory.mktemp("sp12"))


@pytest.mark.parametrize("mode,chunks", RUNS)
def test_sp_step_trajectory_matches_jax(port, init, mode, chunks):
    sp_cases.check_run(port[f"{mode}_{chunks}"], GRID, mode, chunks, *init,
                       evaluate=mode == "ring")
