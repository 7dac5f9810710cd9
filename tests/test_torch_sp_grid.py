"""The port's sequence-parallel LM step on a (2, 2) grid of gloo ranks
(data 2 x seq 2: rank r at data index r // 2, seq index r % 2) against
the JAX package's on a (data, seq) mesh of four virtual devices: losses
and params after 3 f32 SGD steps within 1e-5 in each ``sp_mode``, and
the eval step (``tests/sp_cases.py``).
"""

import pytest
import torch

import sp_cases

GRID = (2, 2)
RUNS = [("ring", 0), ("zigzag", 0), ("ulysses", 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return sp_cases.jax_init()


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return sp_cases.port_run(GRID, RUNS, *init,
                             tmp_path_factory.mktemp("sp22"))


@pytest.mark.parametrize("mode,chunks", RUNS)
def test_sp_step_trajectory_matches_jax(port, init, mode, chunks):
    sp_cases.check_run(port[f"{mode}_{chunks}"], GRID, mode, chunks, *init,
                       evaluate=mode == "ring")
