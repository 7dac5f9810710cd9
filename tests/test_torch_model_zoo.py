"""The port's image zoo against the JAX package's on carried weights:
ViT (``flash`` False and True), ConvNeXt, VGG11, DenseNet and ResNet-50
with the ImageNet stem.

Each family's JAX variables are random numpy draws (every leaf: kernels,
biases, norm scales, BN running stats, the class token, ``pos_embed``
and ConvNeXt's ``gamma``, so nothing is trivially zero or one), carried
into the port by its ``load_jax_*``. Both models see the same numpy
batch; the logits, in train and in eval mode, and the parameter
gradients of ``sum(logits * c)`` agree within 1e-5 in f32, each tensor
normwise: every entry within 1e-5 of the tensor's largest magnitude (at
least 1e-5 absolute; the head's gradient of ResNet-50 reaches ~60).
Two frameworks' f32 sums run in different orders, with the port on
PyTorch's native CPU convolutions (oneDNN off, restored after). Where
JAX itself moves by more than that when only the order of its sums
changes (the same batch in reverse order, so every sum over the batch,
BatchNorm's included, runs the other way), a tensor's absolute bound is
twice that move: BatchNorm in train mode over few rows (four at VGG's
1x1 features, eight in ResNet-50's last stage at batch 2) magnifies f32
rounding far past 1e-5, in JAX against itself as in the port against
JAX (the bf16 tests bound their steps the same way).

ReLU decisions are taken from the port's forward in both frameworks: a
ResNet-50 at 64x64 has about a million pre-activations, and every batch
tried puts some within 1e-6 of zero (1.3e-6 in ResNet-50's
``layer2.1.bn2`` here), where the two frameworks' roundings can land on
either side. Such a unit's ReLU gradient is 1 in one framework and 0 in
the other, and every earlier gradient moves by up to 1%. JAX therefore
runs with ``relu(x) = x * mask``, ``mask`` the port's ``x > 0`` at the
same call: the same function away from zero, the same decision at it.
JAX's ``flash=True`` runs the Pallas kernel in interpret mode, the
port's the kernel's plain version (the CPU path of the same wrapper).
"""

import math

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.models import (
    convnext as jax_convnext, densenet as jax_densenet, vgg as jax_vgg,
    vit as jax_vit)
from zoo_carry import random_variables

from pytorch_multiprocessing_distributed_tpu_torch.models import (
    LM_MODELS, MODEL_REGISTRY, ConvNeXt, DenseNet, ResNet50, VGG11, ViT,
    carry_jax_variables, get_model, init_model, load_jax_convnext,
    load_jax_densenet, load_jax_resnet, load_jax_vgg, load_jax_vit)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_cpu_state():
    """One intra-op thread and PyTorch's native convolutions, restored
    after."""
    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn


def _jax_grad(model, stats, train):
    """``f(params, x, c, masks) -> (grads, logits)``: the params'
    gradients of ``sum(logits * c)`` and the logits, jitted once, the
    ReLUs deciding by ``masks`` in call order."""
    def loss(p, x, c, masks):
        calls = iter(masks)
        relu = flax.linen.relu
        flax.linen.relu = lambda t: t * next(calls)
        try:
            logits = _apply(p, x)
        finally:
            flax.linen.relu = relu
        assert next(calls, None) is None  # one call for each of the port's
        return jnp.sum(logits * c), logits

    def _apply(p, x):
        variables = {"params": p}
        if stats:
            variables["batch_stats"] = stats
        if train and stats:
            return model.apply(variables, x, train=True,
                               mutable=["batch_stats"])[0]
        return model.apply(variables, x, train=train)

    fn = jax.jit(jax.grad(loss, has_aux=True))
    return lambda *args: jax.device_get(fn(*args))


def _bound(want, other):
    """The absolute bound of one tensor: 1e-5 of its largest magnitude
    (at least 1e-5), or twice JAX's own move under reversed sums
    (``other``) where that is larger."""
    return max(TOL * max(1.0, float(np.abs(want).max())),
               2 * float(np.abs(want - other).max()))


# (jax model, port model, port carrier, input shape)
CASES = {
    "vit": lambda: (
        jax_vit.ViT(patch_size=4, hidden_size=64, num_layers=2, num_heads=2,
                    mlp_dim=128),
        ViT(patch_size=4, hidden_size=64, num_layers=2, num_heads=2,
            mlp_dim=128, image_size=32), load_jax_vit, (4, 32, 32, 3)),
    "vit_flash": lambda: (
        jax_vit.ViT(patch_size=4, hidden_size=64, num_layers=2, num_heads=2,
                    mlp_dim=128, flash=True),
        ViT(patch_size=4, hidden_size=64, num_layers=2, num_heads=2,
            mlp_dim=128, image_size=32, flash=True), load_jax_vit,
        (4, 32, 32, 3)),
    "convnext": lambda: (
        jax_convnext.ConvNeXt((1, 1, 1, 1), (16, 32, 64, 128)),
        ConvNeXt((1, 1, 1, 1), (16, 32, 64, 128)), load_jax_convnext,
        (4, 32, 32, 3)),
    "vgg11": lambda: (jax_vgg.VGG11(), VGG11(), load_jax_vgg,
                      (4, 32, 32, 3)),
    "densenet": lambda: (
        jax_densenet.DenseNet((2, 2), growth_rate=8),
        DenseNet((2, 2), growth_rate=8), load_jax_densenet, (4, 32, 32, 3)),
    "resnet50_imagenet": lambda: (
        jax_models.get_model("resnet50", stem="imagenet"),
        ResNet50(stem="imagenet"), load_jax_resnet, (2, 64, 64, 3)),
}


@pytest.fixture(scope="module")
def carried():
    """Per case: the two models, the JAX variables and one batch."""
    cache = {}

    def get(name):
        if name not in cache:
            jax_model, port, carry, shape = CASES[name]()
            params, stats = random_variables(jax_model, shape)
            rng = np.random.default_rng(1)
            x = rng.normal(size=shape).astype(np.float32)
            c = rng.normal(size=(shape[0], 10)).astype(np.float32)
            cache[name] = (jax_model, port, carry, params, stats, x, c)
        return cache[name]

    return get


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_grads_match_jax(carried, monkeypatch, name, train):
    jax_model, port, carry, params, stats, x, c = carried(name)
    port.load_state_dict(carry(params, stats))
    port.train(train)
    port.zero_grad(set_to_none=True)
    masks = []  # the port's ReLU decisions, NHWC, in call order
    relu = F.relu

    def recording_relu(t, *args, **kwargs):
        masks.append(np.ascontiguousarray(
            (t > 0).permute(0, 2, 3, 1).numpy()).astype(np.float32))
        return relu(t, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(F, "relu", recording_relu)
        got = port(torch.from_numpy(x))
    (got * torch.from_numpy(c)).sum().backward()
    run = _jax_grad(jax_model, stats, train)
    grads, logits = run(params, x, c, masks)
    grads_back, back = run(params, x[::-1].copy(), c[::-1].copy(),
                           [mk[::-1].copy() for mk in masks])
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 10)
    np.testing.assert_allclose(got.detach().numpy(), logits,
                               atol=_bound(logits, back[::-1]), rtol=TOL)
    ref, ref_back = carry(grads, stats), carry(grads_back, stats)
    named = dict(port.named_parameters())
    assert set(named) <= set(ref)
    for key, p in named.items():
        want = ref[key].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=TOL, err_msg=key,
            atol=_bound(want, ref_back[key].numpy()))


@pytest.mark.parametrize("name", list(CASES))
def test_carried_state_dict_covers_the_model(carried, name):
    """The carrier's keys are exactly the port model's ``state_dict``
    keys, with its shapes (depthwise kernels ``[dim, 1, 7, 7]``)."""
    _, port, carry, params, stats, _, _ = carried(name)
    sd = carry(params, stats)
    ours = port.state_dict()
    assert set(sd) == set(ours)
    for key, t in sd.items():
        assert t.shape == ours[key].shape, key


def test_registry_names_match_jax():
    """Every JAX image name is registered in the port, with the same
    parameter count on 32x32 (224 for the ImageNet-sized ViT-S/16)."""
    jax_image = {n for n in jax_models.MODEL_REGISTRY
                 if n not in jax_models.LM_MODELS}
    port_image = {n for n in MODEL_REGISTRY if n not in LM_MODELS}
    assert jax_image == port_image
    for name, size in (("vgg11", 32), ("densenet_bc100", 32),
                       ("vit_tiny", 32), ("convnext_t", 32),
                       ("vit_s16", 224)):
        jax_model = jax_models.get_model(name, stem="cifar")
        shapes = jax.eval_shape(
            lambda x, m=jax_model: m.init(jax.random.PRNGKey(0), x),
            jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
        n_jax = sum(np.prod(a.shape) for a in
                    jax.tree.leaves(shapes["params"]))
        port = get_model(name, stem="cifar", image_size=size)
        assert sum(p.numel() for p in port.parameters()) == n_jax, name


def test_get_model_forwards_stem_only_where_taken():
    assert get_model("resnet50", stem="imagenet").stem == "imagenet"
    assert isinstance(get_model("vit_tiny", stem="imagenet"), ViT)
    with pytest.raises(TypeError, match="bogus"):
        get_model("vgg11", bogus=1)
    with pytest.raises(ValueError, match="ring attention"):
        ViT(seq_axis="seq")


@pytest.mark.parametrize("name", ["vit_tiny", "convnext_t", "vgg11",
                                  "densenet_bc100"])
def test_init_model_distributions(name):
    """Fresh weights follow the flax initialisers: Dense and (ViT,
    ConvNeXt) conv kernels lecun_normal (truncated at 2 std, fan-in),
    VGG/DenseNet convs He-normal over the fan-out, zero biases, unit
    norm scales, ``pos_embed`` normal(0.02), zero class token, ``gamma``
    1e-6; the same seed gives the same weights."""
    model = init_model(get_model(name, image_size=32), seed=3)
    again = init_model(get_model(name, image_size=32), seed=3)
    for (key, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), key
    he = name in ("vgg11", "densenet_bc100")
    for key, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and mod.weight.numel() > 2000:
            o, i, kh, kw = mod.weight.shape
            want = (math.sqrt(2.0 / (o * kh * kw)) if he
                    else math.sqrt(1.0 / (i * kh * kw)))
            assert mod.weight.std().item() == pytest.approx(want, rel=0.1)
            if not he:
                limit = 2 * want / .87962566103423978
                assert mod.weight.abs().max().item() <= limit + 1e-6
        if isinstance(mod, torch.nn.Linear):
            assert torch.all(mod.bias == 0)
    params = dict(model.named_parameters())
    if "pos_embed" in params:
        assert params["pos_embed"].std().item() == pytest.approx(0.02,
                                                                 rel=0.1)
        assert torch.all(params["cls"] == 0)
    gammas = [p for k, p in params.items() if k.endswith("gamma")]
    assert all(torch.all(g == 1e-6) for g in gammas)
    assert gammas or name != "convnext_t"


def test_carry_jax_variables_layouts():
    """HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``, scale -> weight,
    mean/var -> running stats."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 2, 5)).astype(np.float32)
    dense = rng.normal(size=(4, 6)).astype(np.float32)
    sd = carry_jax_variables(
        {"a": {"kernel": conv}, "b": {"kernel": dense, "bias": np.ones(6)},
         "n": {"scale": np.ones(5), "bias": np.zeros(5)}},
        {"n": {"mean": np.zeros(5), "var": np.ones(5)}})
    assert torch.equal(sd["a.weight"], torch.from_numpy(
        conv.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(sd["b.weight"], torch.from_numpy(dense.T.copy()))
    assert set(sd) == {"a.weight", "b.weight", "b.bias", "n.weight",
                       "n.bias", "n.running_mean", "n.running_var"}
