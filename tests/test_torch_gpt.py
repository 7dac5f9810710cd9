"""The port's GPT, registry and params against the JAX package's.

Weights cross from JAX as numpy arrays (``from_jax_params``); logits of
the port's ``GPT`` are held against JAX ``GPT(attn_impl="xla")`` on the
same weights and tokens in f32, atol 1e-4 (two frameworks' f32 matmul
and softmax orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.serving import (
    init_params as jax_init_params)
from pytorch_multiprocessing_distributed_tpu_torch import (
    CudaUnavailableError)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    GPT, LM_MODELS, MODEL_REGISTRY, get_model)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params, init_params, load_params)

GEOM = dict(vocab_size=61, max_seq_len=16, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            yield from _flat(val, path)
        else:
            yield path, np.asarray(val)


@pytest.fixture(scope="module")
def carried():
    jmodel = jax_models.GPT(attn_impl="xla", **GEOM)
    jparams = jax_init_params(jmodel, 3)
    model = GPT(**GEOM)
    model.load_state_dict(from_jax_params(jparams), assign=True)
    return jmodel, jparams, model


def test_from_jax_params_maps_every_leaf(carried):
    _, jparams, model = carried
    leaves = dict(_flat(jparams))
    sd = model.state_dict()
    assert set(sd) == {k.replace("/", ".") for k in leaves}
    for path, leaf in leaves.items():
        t = sd[path.replace("/", ".")]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.numpy(), leaf, err_msg=path)


def test_logits_match_jax(carried):
    jmodel, jparams, model = carried
    tokens = np.random.default_rng(0).integers(0, GEOM["vocab_size"],
                                               (2, 12))
    ref = np.asarray(jmodel.apply({"params": jparams},
                                  jnp.asarray(tokens)))
    got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_npz_load_roundtrip(carried, tmp_path):
    _, jparams, model = carried
    path = tmp_path / "params.npz"
    np.savez(path, **dict(_flat(jparams)))
    loaded = load_params(model, str(path))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(loaded[name], t, atol=0, rtol=0)


@pytest.mark.parametrize("name", ["gpt_tiny", "gpt_small", "gpt_medium"])
def test_registry_geometry_matches_jax(name):
    port = get_model(name)
    ref = jax_models.get_model(name)
    for field in ("vocab_size", "max_seq_len", "hidden_size",
                  "num_layers", "num_heads", "mlp_dim", "ln_eps"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.device.type == "meta"  # no memory until params bind


def test_registry_names_and_unknown():
    lm = {"gpt_tiny", "gpt_small", "gpt_medium"}
    assert LM_MODELS == lm
    assert set(MODEL_REGISTRY) == lm | {
        "res", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
        "vgg", "vgg11", "vgg13", "vgg16", "vgg19", "dense", "densenet121",
        "densenet_bc100", "vit_b16", "vit_s16", "vit_tiny", "convnext_t",
        "convnext_s", "convnext_b", "convnext_l"}
    with pytest.raises(KeyError, match="gpt_small"):
        get_model("gpt_huge")


# the id of the case before the seq_axis cases went (sequence parallelism
# is ported); MoE is ported, its expert parallelism (expert_axis) not yet
@pytest.mark.parametrize("kw", [dict(n_experts=2, expert_axis="model")],
                         ids=["kw2"])
def test_unported_model_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPT(**GEOM, **kw)


def test_init_params_distributions_and_seed():
    model = GPT(**GEOM)
    a = init_params(model, 7, "cpu")
    b = init_params(model, 7, "cpu")
    assert set(a) == set(model.state_dict())
    for name, t in a.items():
        torch.testing.assert_close(t, b[name], atol=0, rtol=0)
        if name.endswith(".scale"):
            assert torch.all(t == 1)
        elif name.endswith(".bias"):
            assert torch.all(t == 0)
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert not torch.equal(a["embed"], init_params(model, 8, "cpu")["embed"])


def test_init_params_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(CudaUnavailableError):
        init_params(GPT(**GEOM), 0)
