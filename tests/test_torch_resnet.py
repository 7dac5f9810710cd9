"""The port's ResNet-18 against the JAX package's on carried weights.

One set of JAX ResNet-18 variables (random, BN scales, biases and
running stats included, so neither mode normalizes trivially) is carried
into the port with ``load_jax_resnet``; both models then see the same numpy
batch of 4 NHWC images. Logits, the input gradient of ``sum(logits *
c)`` and (in train mode) the updated running stats agree within 1e-4
absolute: two frameworks' f32 convolutions sum in different orders (the
differences seen are ~1e-6).

In bf16 (``test_bf16_forward_and_step_match_jax``) the tolerances are in
bf16 units — the spacing of bf16 values at the compared magnitude,
``2**(floor(log2(|x|)) - 7)``: the eval logits and one train step's loss
within 2 units (seen: 1), and the step's parameter update within twice
the distance between JAX's own bf16 and f32 steps (the two frameworks
round the bf16 activations and gradients at different points; seen:
1.16x).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.models import (
    registry as jax_registry)
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu.utils import torch_interop
from pytorch_multiprocessing_distributed_tpu_torch.data import (
    normalize, synthetic_cifar10)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    MODEL_REGISTRY, ResNet18, get_model, init_resnet, load_jax_resnet)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_train_state, make_train_step, sgd)

from resnet_carry import random_variables

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def carried():
    """(jax model, params, batch_stats, x, c): JAX ResNet-18 variables
    with random BN affine params and running stats, and one batch."""
    model = jax_models.get_model("res")
    params, batch_stats = random_variables(model, seed=0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    c = rng.normal(size=(4, 10)).astype(np.float32)
    return model, params, batch_stats, x, c


def _jax_run(model, params, batch_stats, x, c, train):
    def loss(x):
        if train:
            logits, mut = model.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                train=True, mutable=["batch_stats"])
            new_stats = mut["batch_stats"]
        else:
            logits = model.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                train=False)
            new_stats = batch_stats
        return jnp.sum(logits * c), (logits, new_stats)

    dx, (logits, new_stats) = jax.jit(jax.grad(loss, has_aux=True))(x)
    return jax.device_get((logits, dx, new_stats))


def _port_model(params, batch_stats):
    model = ResNet18()
    model.load_state_dict(load_jax_resnet(params, batch_stats))
    return model


@pytest.mark.parametrize("train", [True, False])
def test_logits_grads_and_stats_match_jax(carried, train):
    model, params, batch_stats, x, c = carried
    logits, dx, new_stats = _jax_run(model, params, batch_stats, x, c,
                                     train)
    port = _port_model(params, batch_stats)
    port.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(c)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), logits, atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), dx, atol=TOL, rtol=0)
    ref = load_jax_resnet(params, new_stats)
    sd = port.state_dict()
    for key in ref:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), ref[key].numpy(),
                                       atol=TOL, rtol=0, err_msg=key)
            if not train:  # eval mode leaves the stats as they were
                assert torch.equal(sd[key], ref[key])


def test_load_jax_resnet_is_the_reference_state_dict(carried):
    """The port's carried state_dict is the JAX package's
    ``to_torch_state_dict`` (the reference's names and layouts) without
    ``num_batches_tracked``, and covers the port's model exactly."""
    _, params, batch_stats, _, _ = carried
    ours = load_jax_resnet(params, batch_stats)
    ref = {k: v for k, v in torch_interop.to_torch_state_dict(
        params, batch_stats).items()
        if not k.endswith("num_batches_tracked")}
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    assert set(ResNet18().state_dict()) == set(ours)


def test_bf16_forward_returns_f32_logits(carried):
    _, params, batch_stats, x, _ = carried
    model = ResNet18(dtype=torch.bfloat16)
    model.load_state_dict(load_jax_resnet(params, batch_stats))
    model.eval()
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    ref = _port_model(params, batch_stats).eval()(torch.from_numpy(x))
    torch.testing.assert_close(out, ref, atol=0.5, rtol=0.1)


def _bf16_units(scale: float) -> float:
    """The spacing of bf16 values at magnitude ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def test_bf16_forward_and_step_match_jax():
    """The port's bf16 ResNet-18 (eval forward, and one train step with
    Nesterov SGD at lr 0.01) against JAX's bf16 model and
    ``make_train_step`` on the same carried weights and batch."""
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # the native CPU convolutions
    try:
        jmodels = {dt: jax_models.get_model("res", bn_axis="data", dtype=dt)
                   for dt in (jnp.bfloat16, jnp.float32)}
        params, stats = random_variables(jmodels[jnp.bfloat16], seed=0,
                                         random_bn=False)
        x, y = synthetic_cifar10(4, seed=2)
        x = normalize(x)
        ref_logits = np.asarray(jmodels[jnp.bfloat16].apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=False), np.float32)
        port = get_model("res", dtype=torch.bfloat16)
        port.load_state_dict(load_jax_resnet(params, stats))
        logits = port.eval()(torch.from_numpy(x)).detach().numpy()
        assert logits.dtype == np.float32
        unit = _bf16_units(float(np.abs(ref_logits).max()))
        assert float(np.abs(logits - ref_logits).max()) <= 2 * unit

        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        jax_steps = {}
        for dt, jm in jmodels.items():
            state = JaxTrainState(
                params=params, batch_stats=stats,
                opt_state=jax_optim.OptState(
                    momentum=jax.tree.map(np.zeros_like, params),
                    count=np.zeros((), np.int32),
                    initialized=np.zeros((), np.bool_)),
                epoch=np.ones((), np.int32))
            step = jax_step.make_train_step(jm, jax_optim.sgd(0.01), mesh)
            state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
            jax_steps[dt] = (float(metrics["loss"]), jax.device_get(state))
        port = get_model("res", dtype=torch.bfloat16)
        port.load_state_dict(load_jax_resnet(params, stats))
        state = create_train_state(port)
        _, metrics = make_train_step(port, sgd(0.01))(
            state, torch.from_numpy(x), torch.from_numpy(y))
        ref_loss, ref_state = jax_steps[jnp.bfloat16]
        assert abs(float(metrics["loss"]) - ref_loss) <= 2 * _bf16_units(
            ref_loss)

        def flat(tree_state):
            sd = load_jax_resnet(tree_state.params, tree_state.batch_stats)
            return torch.cat([sd[k].reshape(-1)
                              for k in state.views(state.params)])

        ref_bf16, ref_f32 = flat(ref_state), flat(jax_steps[jnp.float32][1])
        noise = float((ref_bf16 - ref_f32).norm())
        assert 0.0 < float((state.params - ref_bf16).norm()) <= 2 * noise
    finally:
        torch.backends.mkldnn.enabled = mkldnn


@pytest.mark.parametrize("name", ["res", "resnet34", "resnet50"])
def test_registry_image_names_and_param_counts(name):
    """The port registers the JAX image names of the ResNet family; a
    model of each block type has the JAX model's parameter and BN-stat
    counts (JAX shapes from ``eval_shape``: nothing compiled)."""
    names = sorted(n for n in jax_registry.MODEL_REGISTRY
                   if n == "res" or n.startswith("resnet"))
    assert names == ["res", "resnet101", "resnet152", "resnet18",
                     "resnet34", "resnet50"]
    assert set(names) <= set(MODEL_REGISTRY)
    x0 = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jax_registry.get_model(name).init(
            jax.random.PRNGKey(0), x, train=False), x0)
    n_params = sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(shapes["params"]))
    n_stats = sum(int(np.prod(a.shape))
                  for a in jax.tree.leaves(shapes["batch_stats"]))
    with torch.device("meta"):
        port = get_model(name)
    assert sum(p.numel() for p in port.parameters()) == n_params
    assert sum(b.numel() for b in port.buffers()) == n_stats
    with pytest.raises(KeyError, match="Unknown model"):
        get_model("alexnet")


def test_init_resnet_distributions():
    """He-normal convs over fan-out, a truncated-normal head, unit BN
    scales and running variances; the same seed gives the same
    weights."""
    a = init_resnet(ResNet18(), seed=3)
    b = init_resnet(ResNet18(), seed=3)
    for (name, p), q in zip(a.state_dict().items(),
                            b.state_dict().values()):
        assert torch.equal(p, q), name
    w = a.layer4[0].conv2.weight.detach()
    assert abs(float(w.std()) - (2.0 / (512 * 9)) ** 0.5) < 2e-3
    head = a.linear.weight.detach()
    assert float(head.abs().max()) <= 2 * (1 / 512) ** 0.5 / .8796 + 1e-6
    assert torch.equal(a.bn1.weight, torch.ones(64))
    assert torch.equal(a.bn1.running_var, torch.ones(64))
