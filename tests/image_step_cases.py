"""The shared case of the port's image-step parity tests
(``tests/test_torch_step_transforms.py``, ``tests/test_torch_zero.py``):
a small ResNet, its random weights and batches, the JAX reference runs
and the port's runs from JAX's states.

The model is the JAX ``ResNet`` class with one BasicBlock in each of its
first two stages and the CIFAR stem, on 8x8 inputs (its window-4 pool is
then global; 307,274 parameters), a global batch of 16 a step, three
steps, in f32, with ``sgd``/``sgd_fused`` (lr 0.01, Nesterov, weight
decay 1e-4) or ``lamb`` (lr 1e-3, weight decay 1e-4).

Each step is compared from a common state: JAX's state before it,
carried into the port (``zoo_carry.port_payload``). Three chained steps
are not comparable at 1e-5: at batch 16 the trajectory crosses a ReLU's
kink within rounding (a 1e-7 relative nudge to the port's own params
before a step moves its momenta by up to 6e-3), so where the two
frameworks' rounding puts one unit on either side, every later step
differs. A single step is comparable only where no ReLU input of its
forward lies within the two frameworks' rounding of zero: the data's
seed (``DATA_SEED``) is one whose every compared forward keeps each ReLU
input at least ``RELU_MARGIN`` from zero, which
``tests/test_torch_step_transforms.py`` asserts. At seed 1 a
``grad_accum=2`` microbatch puts one at 8.9e-8, and that step's momenta
then differ by 2.7e-4: one unit's gradient, on in one framework and off
in the other.
"""

import jax
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu.models import resnet as jresnet
from pytorch_multiprocessing_distributed_tpu.ops.pallas.fused_update import (
    sgd_pallas)
from pytorch_multiprocessing_distributed_tpu.parallel import zero as jzero
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.lamb import (
    LambState, lamb as jax_lamb)
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from zoo_carry import port_payload, random_variables

TOL = 1e-5
ARCH = {"blocks": [1, 1, 0, 0], "stem": "cifar", "num_classes": 10}
IMAGE, BATCH, STEPS = 8, 16, 3
LR = {"sgd": 0.01, "sgd_fused": 0.01, "lamb": 1e-3}
DATA_SEED = 6
RELU_MARGIN = 5e-7


def jax_model():
    return jresnet.ResNet(block=jresnet.BasicBlock,
                          num_blocks=tuple(ARCH["blocks"]), stem=ARCH["stem"],
                          num_classes=ARCH["num_classes"], bn_axis="data")


def make_spec():
    """The carried weights and the global batches of every step (the
    port's run inputs, with the JAX trees beside them)."""
    params, stats = random_variables(jax_model(), (2, IMAGE, IMAGE, 3),
                                     seed=0)
    rng = np.random.default_rng(DATA_SEED)
    images = rng.normal(size=(STEPS, BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32)
    labels = rng.integers(0, ARCH["num_classes"], (STEPS, BATCH)).astype(
        np.int64)
    return {"arch": ARCH, "params": params, "stats": stats,
            "state_dict": load_jax_resnet(params, stats),
            "images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels), "mkldnn": False}


def worker_inputs(spec, runs):
    """What a spawned ``torch_image_worker.steps_rank`` reads (no JAX
    trees)."""
    return {k: v for k, v in spec.items()
            if k not in ("params", "stats")} | {"runs": runs}


def family(optimizer):
    return "lamb" if optimizer == "lamb" else "sgd"


def port_run(name, optimizer, kw, **extra):
    """A run of ``torch_image_worker.run_steps``."""
    return {"name": f"{name}-{optimizer}", "optimizer": optimizer,
            "lr": LR[optimizer], "kw": kw} | extra


def transitions(name, optimizer, kw, states, **extra):
    """The port's three steps, each from JAX's state before it."""
    return [port_run(name, optimizer, kw,
                     resume=port_payload(states[t], load_jax_resnet),
                     start=t, steps=1, **extra) | {"tag": t}
            for t in range(STEPS)]


def jax_optimizer(fam, n_dev, zero=False):
    """JAX ``lamb``; or ``sgd`` on 1 device (and under ``zero``, which
    refuses the fused update), ``sgd_pallas`` in interpret mode on 2."""
    if fam == "lamb":
        return jax_lamb(LR["lamb"], weight_decay=1e-4)
    return (sgd_pallas(LR["sgd"], interpret=True) if n_dev == 2 and not zero
            else jax_optim.sgd(LR["sgd"]))


def jax_state(params, stats, fam, ema):
    """A JAX train state over numpy leaves (no per-leaf device op)."""
    zeros = jax.tree.map(np.zeros_like, params)
    count = np.zeros((), np.int32)
    opt = (LambState(mu=zeros, nu=jax.tree.map(np.zeros_like, params),
                     count=count) if fam == "lamb" else
           jax_optim.OptState(momentum=zeros, count=count,
                              initialized=np.zeros((), np.bool_)))
    return JaxTrainState(params=params, batch_stats=stats, opt_state=opt,
                         epoch=np.ones((), np.int32),
                         ema_params=params if ema else {})


def jax_trajectory(spec, fam, n_dev, kw, zero=False):
    """JAX ``make_train_step`` (``zero=True``: on a ``zeroify_state``
    state) over the spec's steps: ``(losses, host states)``, the states
    before and after each step in the replicated format (a zero state's
    moments gathered by JAX's ``gather_opt_state``). Compiled once: the
    state is placed replicated first, as the jitted step returns it."""
    state = jax_state(spec["params"], spec["stats"], fam,
                      "ema_decay" in kw)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    if zero:
        state = jzero.zeroify_state(state, mesh)
    step = jax_step.make_train_step(jax_model(),
                                    jax_optimizer(fam, n_dev, zero), mesh,
                                    zero=zero, **kw)

    def host(s):
        s = jax.device_get(s)
        if zero:
            s = s.replace(opt_state=jzero.gather_opt_state(s.opt_state,
                                                           s.params))
        return s

    losses, states = [], [host(state)]
    for x, y in zip(spec["images"].numpy(), spec["labels"].numpy()):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        states.append(host(state))
    return losses, states


def assert_payloads_close(got, ref, tol=TOL):
    """Every tensor of the reference payload (but ``initialized``, which
    LAMB has none of in JAX) within ``tol`` of the port's."""
    keys = [k for k in ref if isinstance(ref[k], torch.Tensor)
            and k != "opt_state/initialized"]
    assert set(keys) <= set(got), set(keys) - set(got)
    for k in keys:
        torch.testing.assert_close(got[k].float(), ref[k].float(), atol=tol,
                                   rtol=0, msg=k)


def assert_transitions_match(steps, losses, states):
    """The port's results of :func:`transitions` against JAX's."""
    for t, got in enumerate(steps):
        np.testing.assert_allclose(got["losses"], losses[t:t + 1], atol=TOL,
                                   rtol=0)
        assert_payloads_close(got["state"],
                              port_payload(states[t + 1], load_jax_resnet))
        assert int(got["state"]["opt_state/count"]) == t + 1
