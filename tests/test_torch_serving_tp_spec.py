"""The port's tensor-parallel serving on a (1, 2) grid of gloo ranks
against the JAX package's TP engine and ``generate`` on ``make_mesh(4,
2)`` (``tests/serving_tp_cases.py``): decode horizon 4, n-gram and
draft-model speculation (the draft replicated and unsharded), token-
exact; ``generate(mesh=grid)`` greedy (token-exact) and sampled (the
port's single-shard stream from one seed); a top-2 MoE gpt_tiny with
its expert leaves on JAX's trailing-dim split, greedy, token-exact."""

import pytest
import torch

import serving_tp_cases as cases

WORLD = 2
ENGINE = ("horizon4", "ngram_k3", "draft_model_k3")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    return cases.jax_setup()


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    return cases.run(WORLD, ref, tmp_path_factory.mktemp("tp2s"),
                          ENGINE, ("greedy", "sampled", "moe"))


@pytest.mark.parametrize("name", ENGINE)
def test_engine_matches_jax_tp_engine(runs, name):
    cases.check_engine(runs, name)


def test_generate_matches_jax_tp_generate(runs, ref):
    cases.check_generate(runs, ref)


def test_moe_generate_matches_jax_tp_generate(runs):
    assert runs["ranks"][0]["gen_moe"]["tokens"] == runs["jax"]["gen_moe"]
