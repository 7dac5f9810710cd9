"""The port's tensor-parallel serving on a (1, 4) grid of gloo ranks
(one head a rank) against the JAX package's TP engine on
``make_mesh(2, 4)`` (``tests/serving_tp_cases.py``): dense, chunked,
paged with prefix hits, int8 dense and paged, token-exact; sampling
equal to the port's single-shard stream from one seed; a rank's
resident param bytes against JAX's per device, its KV pool against the
one-rank pool over M."""

import pytest
import torch

import serving_tp_cases as cases

WORLD = 4
ENGINE = ("dense", "chunked", "paged_prefix", "int8_dense", "int8_paged")


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
    return cases.run(WORLD, ref, tmp_path_factory.mktemp("tp4"),
                          ENGINE + ("sampled",))


@pytest.mark.parametrize("name", ENGINE)
def test_engine_matches_jax_tp_engine(runs, name):
    cases.check_engine(runs, name)


def test_sampled_engine_matches_single_shard(runs, ref):
    cases.check_sampled(runs, ref)


def test_resident_bytes_are_jax_bytes(runs, ref):
    cases.check_resident(runs, ref, WORLD)


@pytest.mark.parametrize("name", ENGINE)
def test_kv_pool_is_one_rank_pool_over_m(runs, ref, name):
    cases.check_kv_pool(runs, ref, name, WORLD)


def test_decode_step_gathers(runs):
    cases.check_gathers(runs)
