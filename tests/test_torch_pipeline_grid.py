"""The port's pipelined LM step on a (data 2, pipe 2) grid against the
JAX package's on a (2, 2) mesh of the conftest's virtual devices
(``tests/mp_cases.py``): the vocab-parallel CE and its data-summed
gradients, 3-step f32 trajectories of gpipe and of 1f1b (losses, every
param and the eval loss within 1e-5), gpipe == 1f1b, and each stage's
resident bytes. The (1, 2) grid and the layout's own tests are
``tests/test_torch_pipeline.py``."""

import numpy as np
import pytest
import torch

import mp_cases
from test_torch_pipeline import check_grads

GRID = (2, 2)
RUNS = {s: {"kind": "pp", "grid": GRID, "schedule": s}
        for s in ("gpipe", "1f1b")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    return mp_cases.jax_init()


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    return mp_cases.port_run(GRID[0] * GRID[1], RUNS, *init,
                             tmp_path_factory.mktemp("pp22"))


def test_vocab_parallel_ce_and_grads_match_jax(init, tmp_path):
    check_grads(GRID, init, tmp_path)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipelined_trajectory_matches_jax(port, init, schedule):
    mp_cases.check_run(port[0][schedule],
                       mp_cases.jax_pp(GRID, schedule, *init))


def test_gpipe_equals_1f1b(port):
    a, b = port[0]["gpipe"], port[0]["1f1b"]
    np.testing.assert_allclose(a["losses"], b["losses"], atol=1e-6, rtol=0)
    for name, t in a["params"].items():
        torch.testing.assert_close(t, b["params"][name], atol=1e-6, rtol=0,
                                   msg=name)


def test_stages_hold_their_slices(port):
    """Ranks of one stage hold equal bytes across the data axis, and
    a stage holds about half of the blocks and vocab tables."""
    sizes = [rank["gpipe"]["resident"]["params"] for rank in port]
    assert len(set(sizes)) == 1
    g = mp_cases.GEOM
    d, v, layers = g["hidden_size"], g["vocab_size"], g["num_layers"]
    block = 4 * (d * 3 * d + 3 * d + d * d + d + 4 * d
                 + d * g["mlp_dim"] + g["mlp_dim"] + g["mlp_dim"] * d + d)
    vs = -(-v // GRID[1])
    stage = (4 * (vs * d + g["max_seq_len"] * d + 2 * d + d * vs + vs)
             + block * layers // GRID[1])
    assert sizes[0] == stage
