"""The port's sequence-parallel step on a Mixture-of-Experts GPT against
the JAX package's, on a (data 1, seq 2) grid of gloo ranks
(``tests/sp_cases.py``'s ``MOE`` case: 2 layers, 2 heads, 4 top-1
experts at capacity factor 1.0, ``[4, 16]`` batches).

Each rank routes its own columns with the capacity of its local ``S``
(8 tokens: 2 slots an expert, so tokens drop) and the balance loss is a
per-shard statistic averaged over the shards, as in JAX. Losses,
balance losses, every param after 3 f32 SGD steps and the eval loss
within 1e-5 of JAX's under ring and Ulysses attention; zigzag (whose
slots follow the zigzag layout) is ``tests/test_torch_moe_sp_zigzag.py``
(JAX's zigzag steps take a minute here).
"""

import pytest
import torch

import sp_cases

GRID = (1, 2)
RUNS = [("ring", 0), ("ulysses", 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return sp_cases.jax_init(sp_cases.MOE)


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return sp_cases.port_run(GRID, RUNS, *init,
                             tmp_path_factory.mktemp("moe_sp12"),
                             sp_cases.MOE)


@pytest.mark.parametrize("mode,chunks", RUNS)
def test_moe_sp_trajectory_matches_jax(port, init, mode, chunks):
    ours = port[f"{mode}_{chunks}"]
    assert len(ours["aux"]) == sp_cases.STEPS
    sp_cases.check_run(ours, GRID, mode, chunks, *init, evaluate=True,
                       case=sp_cases.MOE)
