"""The port's image train and eval steps against the JAX package's
``make_train_step``/``make_eval_step`` on carried ResNet-18 weights and
the same numpy batches.

Three SGD steps (lr 0.01, Nesterov, weight decay 1e-4) on one global
batch of 4 synthetic CIFAR images in f32 (the loss must fall), from
weights drawn like the JAX init (BN at its defaults), with ``sgd`` and
with ``sgd_fused``: losses, params, momenta and BN running stats agree
within 1e-5 absolute — two frameworks' f32 convolutions and reductions
in different orders (seen: 2e-6). The lr is not the reference's 0.1: on
a batch of 4 that step overshoots (the loss rises at step 2), and JAX
on 1 and on 2 devices then differ from each other by 1e-3 by step 3.
The port's convolutions run PyTorch's native CPU kernels here (oneDNN
off, restored after): oneDNN's, the CPU default, differ from XLA's by
up to ~1e-4 relative per step, which three steps grow to 2e-3 in the
momenta.

On 1 device the port runs in this process, against JAX ``sgd`` on 1
device; on 2 it runs as two gloo ranks (spawned), each holding half of
every batch, against JAX ``sgd_pallas`` (its Pallas update in interpret
mode) on 2 virtual devices. Each JAX program compiles once for both of
the port's optimizers: the port's two run the same arithmetic on the CPU
(``tests/test_torch_fused_sgd.py``), and the JAX package pins its two
against each other (``tests/test_pallas_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.ops.pallas.fused_update import (
    sgd_pallas)
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu_torch.data import (
    normalize, synthetic_cifar10)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    get_model, load_jax_resnet)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_train_state, make_eval_step, make_train_step, sgd, sgd_fused)
from pytorch_multiprocessing_distributed_tpu_torch.train.checkpoint import (
    load_checkpoint, save_checkpoint)

from resnet_carry import random_variables
from torch_image_worker import image_train_rank, spawn_ranks

TOL = 1e-5
BATCH, STEPS = 4, 3
LR = 0.01
OPTIMIZERS = ("sgd", "sgd_fused")
JAX_OPTIMIZER = {1: "sgd", 2: "sgd_fused"}  # the reference per device count


@pytest.fixture(autouse=True)
def _torch_cpu_state():
    """One intra-op thread and PyTorch's native convolutions (oneDNN
    off) for this file's torch work, both restored after."""
    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn


@pytest.fixture(scope="module")
def carried():
    """(jax model, params, batch_stats, images, labels)."""
    model = jax_models.get_model("res", bn_axis="data")
    params, stats = random_variables(model, seed=0, random_bn=False)
    x, y = synthetic_cifar10(BATCH, seed=2)
    images = np.stack([normalize(x)] * STEPS)
    labels = np.stack([y] * STEPS)
    return model, params, stats, images, labels


@pytest.fixture(scope="module")
def jax_references(carried):
    """``{n_dev: (losses, final state)}``, each compiled on first use."""
    cache = {}

    def get(n_dev):
        if n_dev not in cache:
            cache[n_dev] = _jax_trajectory(carried, n_dev,
                                           JAX_OPTIMIZER[n_dev])
        return cache[n_dev]

    return get


@pytest.fixture(scope="module")
def world2_runs(carried, tmp_path_factory):
    """The port at world 2 (two spawned gloo ranks), both optimizers in
    one spawn: ``{optimizer: (losses, params, momentum, stats)}``."""
    _, _, _, images, labels = carried
    tmp = tmp_path_factory.mktemp("world2")
    inputs, out = tmp / "inputs.pt", tmp / "out.pt"
    torch.save({"state_dict": _port_model(carried).state_dict(),
                "images": torch.from_numpy(images),
                "labels": torch.from_numpy(labels),
                "optimizers": list(OPTIMIZERS), "lr": LR,
                "mkldnn": False}, inputs)
    spawn_ranks(image_train_rank, 2, (str(inputs), str(out)))
    runs = torch.load(out, weights_only=True)
    return {name: (r["losses"], r["params"], r["momentum"], r["stats"])
            for name, r in runs.items()}


def _jax_trajectory(carried, n_dev, optimizer):
    model, params, stats, images, labels = carried
    opt = (sgd_pallas(LR, interpret=True) if optimizer == "sgd_fused"
           else jax_optim.sgd(LR))
    state = _jax_state(params, stats)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    step = jax_step.make_train_step(model, opt, mesh)
    losses = []
    for x, y in zip(images, labels):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state)


def _jax_state(params, stats):
    """A JAX train state over numpy leaves (the step places them): no
    per-leaf device op, so no per-leaf compile."""
    return JaxTrainState(
        params=params, batch_stats=stats,
        opt_state=jax_optim.OptState(
            momentum=jax.tree.map(np.zeros_like, params),
            count=np.zeros((), np.int32),
            initialized=np.zeros((), np.bool_)),
        epoch=np.ones((), np.int32))


def _port_model(carried):
    _, params, stats, _, _ = carried
    model = get_model("res")
    model.load_state_dict(load_jax_resnet(params, stats))
    return model


def _flat_reference(state, tree, stats_tree):
    """The JAX state's params/momenta/stats in the port's flat order."""
    sd = load_jax_resnet(tree, stats_tree)
    views = list(state.views(state.params))
    flat = torch.cat([sd[k].reshape(-1) for k in views])
    stats = torch.cat([sd[k].reshape(-1) for k in state.stat_views()])
    return flat, stats


def _assert_matches(got, ref_losses, ref_state, state):
    losses, params, momentum, stats = got
    np.testing.assert_allclose(losses, ref_losses, atol=TOL, rtol=0)
    ref_p, ref_s = _flat_reference(state, ref_state.params,
                                   ref_state.batch_stats)
    ref_m, _ = _flat_reference(state, ref_state.opt_state.momentum,
                               ref_state.batch_stats)
    torch.testing.assert_close(params, ref_p, atol=TOL, rtol=0)
    torch.testing.assert_close(momentum, ref_m, atol=TOL, rtol=0)
    torch.testing.assert_close(stats, ref_s, atol=TOL, rtol=0)


def _port_run(carried, optimizer):
    _, _, _, images, labels = carried
    model = _port_model(carried)
    state = create_train_state(model)
    make = sgd_fused if optimizer == "sgd_fused" else sgd
    step = make_train_step(model, make(LR))
    losses = [float(step(state, torch.from_numpy(x),
                         torch.from_numpy(y))[1]["loss"])
              for x, y in zip(images, labels)]
    return state, losses


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("n_dev", [1, 2])
def test_trajectory_matches_jax(carried, jax_references, world2_runs, n_dev,
                                optimizer):
    ref_losses, ref_state = jax_references(n_dev)
    state, losses = _port_run(carried, optimizer)  # the flat layout
    print('LOSSES', losses, ref_losses)
    got = (losses, state.params, state.momentum, state.stats)
    if n_dev == 2:
        got = world2_runs[optimizer]
    _assert_matches(got, ref_losses, ref_state, state)
    assert int(state.count) == STEPS and bool(state.initialized)


def test_eval_step_matches_jax_with_valid_mask(carried):
    """Eval mode (running stats) with the last row masked out as a
    padding duplicate: masked sums equal JAX's on 2 devices."""
    model, params, stats, images, labels = carried
    valid = np.array([True, True, True, False])
    jstate = _jax_state(params, stats)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    ref = jax.device_get(jax_step.make_eval_step(model, mesh)(
        jstate, jnp.asarray(images[0]), jnp.asarray(labels[0]),
        jnp.asarray(valid)))
    port = _port_model(carried)
    state = create_train_state(port)
    got = make_eval_step(port)(state, torch.from_numpy(images[0]),
                               torch.from_numpy(labels[0]),
                               torch.from_numpy(valid))
    assert float(got["count"]) == float(ref["count"]) == 3
    for key in ("correct", "correct5"):
        assert float(got[key]) == float(ref[key]), key
    for key in ("loss_sum", "loss", "prec1", "prec5"):
        assert abs(float(got[key]) - float(ref[key])) < 1e-4, key


def test_nan_guard_skips_and_restores_bn_stats(carried):
    state, _ = _port_run(carried, "sgd_fused")
    with torch.no_grad():
        state.params.mul_(1e20)
    before = (state.params.clone(), state.momentum.clone(),
              state.stats.clone(), int(state.count))
    step = make_train_step(state.model, sgd_fused(0.1))
    _, m = step(state, torch.from_numpy(carried[3][0]),
                torch.from_numpy(carried[4][0]))
    assert int(m["skipped"]) == 1
    assert torch.equal(state.params, before[0])
    assert torch.equal(state.momentum, before[1])
    assert torch.equal(state.stats, before[2])  # the forward moved them
    assert int(state.count) == before[3]


def test_state_binds_bn_stats_and_checkpoints_them(carried, tmp_path):
    """The running stats are views of ``state.stats`` (outside the
    gradient buffer and the optimizer), and a checkpoint carries them."""
    state, _ = _port_run(carried, "sgd")
    model = state.model
    names = [n for n, _ in model.named_buffers()]
    assert set(state.stat_views()) == set(names)
    lo, hi = state.stats.data_ptr(), state.stats.data_ptr() + 4 * len(
        state.stats)
    for name, buf in model.named_buffers():
        assert lo <= buf.data_ptr() < hi, name
    assert state.grads.numel() == state.n + 2  # loss and correct slots
    path = save_checkpoint(str(tmp_path), state, 3)
    assert path.endswith("model_3.pth")
    payload = torch.load(path, weights_only=True)
    assert "batch_stats/layer1/0/bn1/running_var" in payload
    fresh = create_train_state(_port_model(carried))
    load_checkpoint(path, fresh)
    for a, b in ((fresh.params, state.params), (fresh.stats, state.stats),
                 (fresh.momentum, state.momentum)):
        assert torch.equal(a, b)
    assert fresh.epoch == state.epoch and int(fresh.count) == STEPS


def test_metrics_match_jax():
    """``topk_accuracy``/``accuracy``/``correct_count`` on the same
    logits (ties excluded): equal values and masks."""
    from pytorch_multiprocessing_distributed_tpu.utils import metrics as jm
    from pytorch_multiprocessing_distributed_tpu_torch.utils import metrics

    rng = np.random.default_rng(5)
    logits = rng.normal(size=(12, 10)).astype(np.float32)
    targets = rng.integers(0, 10, 12).astype(np.int32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets).long()
    precs, correct = metrics.topk_accuracy(lt, tt, topk=(1, 5))
    jprecs, jcorrect = jm.topk_accuracy(jnp.asarray(logits),
                                        jnp.asarray(targets), topk=(1, 5))
    assert [float(p) for p in precs] == pytest.approx(
        [float(p) for p in jprecs], abs=1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
    p1, mask = metrics.accuracy(lt, tt)
    jp1, jmask = jm.accuracy(jnp.asarray(logits), jnp.asarray(targets))
    assert float(p1) == pytest.approx(float(jp1), abs=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(metrics.correct_count(lt, tt)) == int(jm.correct_count(
        jnp.asarray(logits), jnp.asarray(targets)))


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_smooth_cross_entropy_matches_jax(eps):
    """``--label_smoothing``'s loss against JAX ``ops/losses.py``'s, per
    sample and mean, within 1e-6."""
    from pytorch_multiprocessing_distributed_tpu.ops import losses as jl
    from pytorch_multiprocessing_distributed_tpu_torch.ops import losses

    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(8, 10)) * 4).astype(np.float32)
    targets = rng.integers(0, 10, 8).astype(np.int32)
    ours = losses.smooth_cross_entropy_loss(eps)
    ref = jl.smooth_cross_entropy_loss(eps)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    jl_, jt = jnp.asarray(logits), jnp.asarray(targets)
    np.testing.assert_allclose(ours.per_sample(tl, tt).numpy(),
                               np.asarray(ref.per_sample(jl_, jt)),
                               atol=1e-6, rtol=0)
    assert abs(float(ours(tl, tt)) - float(ref(jl_, jt))) < 1e-6
