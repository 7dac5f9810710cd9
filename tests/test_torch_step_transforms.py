"""The image step's transforms in the port (``grad_accum``,
``clip_grad_norm``, ``ema_decay``, ``remat`` and all four together)
against the JAX package's ``make_train_step`` with the same transforms.

The case is ``tests/image_step_cases.py``'s: a small ResNet (CIFAR
stem, one BasicBlock in each of two stages, 8x8 inputs), a global batch
of 16, three steps in f32 with ``sgd`` and ``sgd_fused`` (the port's
fused update runs its plain version on the CPU) and ``lamb``, each step
from JAX's state before it (see that module for why). The step's loss,
and the params, moments, BN running stats and EMA after it, agree
within 1e-5 absolute: two frameworks' f32 sums in different orders.

On 1 device the port runs in this process against JAX ``sgd`` or
``lamb`` on 1 device; on 2 it runs as two spawned gloo ranks against JAX
``sgd_pallas`` (interpret mode) or ``lamb`` on 2 virtual devices. The
clip bound of ``clip_hit`` lies under every step's gradient norm and
that of ``clip_miss`` over it, and the tests say so. ``remat`` is also
held bit for bit against the step without it, over 3 chained steps. The
port's convolutions run PyTorch's native CPU kernels here (oneDNN off,
restored after; see ``tests/test_torch_image_train.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_train_state, make_train_step)

from image_step_cases import (ARCH, LR, RELU_MARGIN, STEPS,
                              assert_transitions_match, family, jax_model,
                              jax_state, jax_trajectory, make_spec, port_run,
                              transitions, worker_inputs)
from torch_image_worker import (build_model, make_optimizer, run_steps,
                                spawn_ranks, steps_rank)

CLIP_HIT, CLIP_MISS = 0.5, 1e3
TRANSFORMS = {
    "accum2": {"grad_accum": 2},
    "accum4": {"grad_accum": 4},
    "clip_hit": {"clip_grad_norm": CLIP_HIT},
    "clip_miss": {"clip_grad_norm": CLIP_MISS},
    "ema": {"ema_decay": 0.9},
    "remat": {"remat": True},
    "all": {"grad_accum": 2, "clip_grad_norm": CLIP_HIT, "ema_decay": 0.9,
            "remat": True},
}
OPTIMIZERS = ("sgd", "sgd_fused", "lamb")


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
def spec():
    return make_spec()


@pytest.fixture(scope="module")
def jax_runs(spec):
    """``get(transform, family, n_dev) -> (losses, host states)``, each
    JAX program compiled once."""
    cache = {}

    def get(name, fam, n_dev):
        if (name, fam, n_dev) not in cache:
            cache[name, fam, n_dev] = jax_trajectory(spec, fam, n_dev,
                                                     TRANSFORMS[name])
        return cache[name, fam, n_dev]

    return get


def _transitions(name, optimizer, states):
    return transitions(name, optimizer, TRANSFORMS[name], states)


@pytest.fixture(scope="module")
def world2(spec, jax_runs, tmp_path_factory):
    """On two spawned gloo ranks in one spawn: every transform's three
    steps with every optimizer, each from JAX's state on 2 devices
    (``{name-optimizer: [result of step t]}``), and the untransformed
    and ``remat`` runs' 3 chained steps (``{chain-name-optimizer:
    result}``)."""
    tmp = tmp_path_factory.mktemp("transforms2")
    inputs, out = tmp / "inputs.pt", tmp / "out.pt"
    runs = [port_run(f"chain-{name}", opt, TRANSFORMS.get(name, {}))
            for name in ("none", "remat") for opt in OPTIMIZERS]
    for name in TRANSFORMS:
        for opt in OPTIMIZERS:
            states = jax_runs(name, family(opt), 2)[1]
            runs += [r | {"name": f"{r['name']}@{r['tag']}"}
                     for r in _transitions(name, opt, states)]
    torch.save(worker_inputs(spec, runs), inputs)
    spawn_ranks(steps_rank, 2, (str(inputs), str(out)))
    results = torch.load(out, weights_only=True)
    for name in TRANSFORMS:
        for opt in OPTIMIZERS:
            key = f"{name}-{opt}"
            results[key] = [results.pop(f"{key}@{t}") for t in range(STEPS)]
    return results


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("n_dev", [1, 2])
def test_transform_matches_jax(spec, jax_runs, world2, n_dev, name,
                               optimizer):
    losses, states = jax_runs(name, family(optimizer), n_dev)
    steps = ([run_steps(spec, run)
              for run in _transitions(name, optimizer, states)]
             if n_dev == 1 else world2[f"{name}-{optimizer}"])
    assert_transitions_match(steps, losses, states)
    clip = TRANSFORMS[name].get("clip_grad_norm")
    for got in steps:
        assert any(k.startswith("ema_params/") for k in got["state"]) == (
            "ema_decay" in TRANSFORMS[name])
        # the bound is hit at every step (the clipped norm is the bound)
        # or at none
        if clip == CLIP_HIT:
            np.testing.assert_allclose(got["norms"], CLIP_HIT, rtol=1e-5)
        elif clip == CLIP_MISS:
            assert max(got["norms"]) < CLIP_MISS / 10


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_relu_inputs_keep_their_margin(spec, jax_runs, monkeypatch,
                                       optimizer):
    """The precondition of the comparisons above: in the port's forward
    of every step compared on 1 device, every ReLU input lies at least
    ``RELU_MARGIN`` from zero (the two frameworks round pre-activations
    near 1 differently by ~1e-7)."""
    margins = []
    relu = torch.nn.functional.relu

    def recording_relu(t, *args, **kwargs):
        margins.append(float(t.detach().abs().min()))
        return relu(t, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "relu", recording_relu)
    for name in TRANSFORMS:
        states = jax_runs(name, family(optimizer), 1)[1]
        for run in _transitions(name, optimizer, states):
            run_steps(spec, run)
    assert len(margins) > 0 and min(margins) >= RELU_MARGIN, min(margins)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("n_dev", [1, 2])
def test_remat_is_bit_equal_to_no_remat(spec, world2, n_dev, optimizer):
    """``remat`` recomputes the forward in the backward, and the BN
    running stats still take one update a forward: params, moments and
    stats bit-equal to the run without it."""
    if n_dev == 1:
        plain = run_steps(spec, port_run("none", optimizer, {}))
        remat = run_steps(spec, port_run("remat", optimizer,
                                         TRANSFORMS["remat"]))
    else:
        plain = world2[f"chain-none-{optimizer}"]
        remat = world2[f"chain-remat-{optimizer}"]
    assert plain["losses"] == remat["losses"]
    for k, v in plain["state"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, remat["state"][k]), k


@pytest.mark.parametrize("optimizer", ["sgd_fused", "lamb"])
def test_nan_step_under_clip_and_ema_keeps_state(spec, optimizer):
    """A step whose gradients are not finite (params scaled by 1e20)
    under clipping and an EMA: skipped, and params, moments, BN stats,
    EMA and count all as they were."""
    model = build_model(ARCH)
    model.load_state_dict(spec["state_dict"])
    opt = make_optimizer(optimizer, LR[optimizer])
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, opt, clip_grad_norm=CLIP_HIT,
                           ema_decay=0.9, grad_accum=2)
    x, y = spec["images"][0], spec["labels"][0]
    step(state, x, y)
    with torch.no_grad():
        state.params.mul_(1e20)
    before = {k: v.clone() for k, v in state.to_dict().items()
              if isinstance(v, torch.Tensor)}
    _, m = step(state, x, y)
    assert int(m["skipped"]) == 1
    after = state.to_dict()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k


def test_grad_accum_needs_a_divisible_batch(spec):
    """The JAX step's refusal, naming the per-device batch: 16 rows on
    one rank do not split into 3 microbatches."""
    model = build_model(ARCH)
    model.load_state_dict(spec["state_dict"])
    opt = make_optimizer("sgd", 0.01)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, grad_accum=3)
    with pytest.raises(ValueError) as port_err:
        step(state, spec["images"][0], spec["labels"][0])
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jax_step.make_train_step(jax_model(), jax_optim.sgd(0.01), mesh,
                                     grad_accum=3)
    with pytest.raises(ValueError) as jax_err:
        jstep(jax_state(spec["params"], spec["stats"], "sgd", False),
              spec["images"][0].numpy(), spec["labels"][0].numpy())
    expected = "per-device batch 16 is not divisible by grad_accum=3"
    assert str(port_err.value).startswith(expected)
    assert str(jax_err.value).startswith(expected)


@pytest.mark.parametrize("kw", [{"grad_accum": 0}, {"clip_grad_norm": -1.0},
                                {"ema_decay": 1.5}, {"ema_decay": -0.5}])
def test_transform_arguments_are_checked_as_in_jax(kw):
    """Out-of-range transform arguments raise JAX's ``ValueError`` with
    its message, when the step is built."""
    model = build_model(ARCH)
    with pytest.raises(ValueError) as port_err:
        make_train_step(model, make_optimizer("sgd", 0.01), **kw)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError) as jax_err:
        jax_step.make_train_step(jax_model(), jax_optim.sgd(0.01), mesh,
                                 **kw)
    assert str(port_err.value) == str(jax_err.value)
