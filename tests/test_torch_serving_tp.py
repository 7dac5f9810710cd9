"""The port's tensor-parallel serving on a (1, 2) grid of gloo ranks
against the JAX package's TP engine on ``make_mesh(4, 2)``
(``tests/serving_tp_cases.py``): dense, chunked, paged with prefix hits,
int8 dense and paged, token-exact; sampling equal to the port's
single-shard stream from one seed; a rank's resident param bytes against
JAX's per device, its KV pool against the one-rank pool over M, the
all-gathers a decode step; and JAX's refusals of a mesh, in its
words."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu.inference import (
    generate as jax_generate)
from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.serving import (
    ServingEngine as JaxEngine)
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import Grid
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    ServingEngine, from_jax_params)

import serving_tp_cases as cases

WORLD = 2
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
    return cases.run(WORLD, ref, tmp_path_factory.mktemp("tp2"),
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


def _bound(ref):
    model = GPT(**cases.GEOM)
    model.load_state_dict(from_jax_params(ref["params"]), assign=True)
    return model


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_mesh_without_model_axis_is_refused_as_jax_does(ref):
    model = _bound(ref)
    port = Grid(1, 2, axis="seq")
    jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))
    prompt = cases.gen_prompt()
    want = _message(lambda: JaxEngine(ref["model"], ref["params"],
                                      max_slots=2, mesh=jmesh))
    assert "'model' mesh axis" in want
    assert _message(lambda: ServingEngine(model, max_slots=2,
                                          mesh=port)) == want
    want = _message(lambda: jax_generate(
        ref["model"], ref["params"], jax.numpy.asarray(prompt),
        max_new_tokens=2, mesh=jmesh))
    assert _message(lambda: generate(model, torch.from_numpy(prompt),
                                     max_new_tokens=2, mesh=port)) == want


def test_heads_not_divisible_is_refused_as_jax_does(ref):
    model = _bound(ref)
    jmesh = make_mesh(2, 3, devices=jax.devices()[:6])
    want = _message(lambda: JaxEngine(ref["model"], ref["params"],
                                      max_slots=2, mesh=jmesh))
    assert want == "num_heads=4 not divisible by the model axis size 3"
    assert _message(lambda: ServingEngine(model, max_slots=2,
                                          mesh=Grid(1, 3))) == want
    prompt = torch.from_numpy(cases.gen_prompt())
    assert _message(lambda: generate(model, prompt, max_new_tokens=2,
                                     mesh=Grid(1, 3))) == want
    # the CLI refuses before it starts a rank
    assert _message(lambda: serve_lm.main(
        ["--device", "cpu", "--tp", "3", "--random_init"])) == want


def test_chip_smoke_tp_bytes_are_jax_bytes():
    """``chip_smoke.TP_JAX_PARAM_BYTES`` (the script cannot import JAX):
    JAX's per-device f32 bytes of ``shard_params_for_tp_decode``'s tree
    of gpt_small and gpt_medium, by JAX's own ``tp_param_spec`` on the
    params' shapes, in all and of the LayerNorm leaves."""
    import importlib.util
    import os

    from jax.sharding import PartitionSpec

    from pytorch_multiprocessing_distributed_tpu import models as jax_models
    from pytorch_multiprocessing_distributed_tpu.train.step import (
        tp_param_spec)

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tp", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.TP_JAX_PARAM_BYTES) == set(smoke.TP_CONFIGS)
    for (name, m), want in smoke.TP_JAX_PARAM_BYTES.items():
        jmodel = jax_models.get_model(name)
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
            jax.ShapeDtypeStruct((1, 8), jax.numpy.int32))["params"]
        total = small = 0
        for path_, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            split = tp_param_spec(leaf, m) != PartitionSpec()
            n = int(np.prod(leaf.shape)) * 4 // (m if split else 1)
            total += n
            if len(path_) > 1 and path_[-2].key in ("ln1", "ln2",
                                                    "ln_final"):
                small += n
        assert (total, small) == want, (name, m)
