"""Kernel row 8's plain version (the port's fused SGD on the CPU) against
the JAX package's fused update in interpret mode, its ``sgd`` transform
and ``torch.optim.SGD``, on the same numpy params and gradients.

Five steps: the first (lazy momentum init), a skipped one (``keep``
False with NaN gradients, which the JAX train step's guard turns into
"state carried through"), and three more; Nesterov on and off, weight
decay on and off. Params and momenta agree within 1e-6 absolute (values
of order 1; XLA may fuse a multiply-add that the port rounds twice).
The card's kernel is held bit for bit against this plain version in
``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.ops.pallas import (
    fused_update as jax_fused)
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu_torch.ops import (
    fused_sgd_, torch_fused_sgd_)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    SGD, multistep_lr, sgd, sgd_fused)

TOL = 1e-6
SHAPES = {"a": (37,), "b": (5, 7)}  # two leaves, flattened into one
KEEP = (True, True, False, True, True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(rng):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    return torch.from_numpy(np.concatenate(
        [np.asarray(tree[k]).reshape(-1) for k in SHAPES]))


@pytest.fixture(scope="module")
def trajectory_inputs():
    rng = np.random.default_rng(0)
    return _tree(rng), [_tree(rng) for _ in KEEP]


def _port(params, grads, nesterov, wd, update):
    p, buf = _flat(params), torch.zeros(sum(np.prod(s)
                                            for s in SHAPES.values()))
    init = torch.zeros((), dtype=torch.bool)
    count = torch.zeros((), dtype=torch.int32)
    for g, keep in zip(grads, KEEP):
        gt = _flat(g)
        if not keep:
            gt[3] = float("nan")
        update(p, gt, buf, init, count, torch.tensor(keep), lr=0.1,
               momentum=0.9, weight_decay=wd, nesterov=nesterov)
    return p, buf, init, count


def _jax_fused(params, grads, nesterov, wd):
    apply = jax.jit(lambda p, g, buf, init: jax_fused.fused_sgd_apply(
        p, g, buf, 0.1, momentum=0.9, weight_decay=wd, nesterov=nesterov,
        initialized=init, interpret=True))
    p = jax.tree.map(jnp.asarray, params)
    buf = jax.tree.map(jnp.zeros_like, p)
    init = False
    for g, keep in zip(grads, KEEP):
        if not keep:  # the train step's guard carries the state through
            continue
        p, buf = apply(p, g, buf, jnp.float32(init))
        init = True
    return _flat(jax.device_get(p)), _flat(jax.device_get(buf))


def _jax_sgd(params, grads, nesterov, wd):
    opt = jax_optim.sgd(0.1, momentum=0.9, weight_decay=wd,
                        nesterov=nesterov)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    for g, keep in zip(grads, KEEP):
        if keep:
            upd, state = opt.update(g, state, p, lr_step=1)
            p = jax_optim.apply_updates(p, upd)
    return _flat(jax.device_get(p)), _flat(jax.device_get(state.momentum))


@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("wd", [1e-4, 0.0])
def test_plain_matches_jax_fused_and_sgd(trajectory_inputs, nesterov, wd):
    params, grads = trajectory_inputs
    p, buf, init, count = _port(params, grads, nesterov, wd,
                                torch_fused_sgd_)
    assert bool(init) and int(count) == sum(KEEP)
    for ref_p, ref_buf in (_jax_fused(params, grads, nesterov, wd),
                           _jax_sgd(params, grads, nesterov, wd)):
        torch.testing.assert_close(p, ref_p, atol=TOL, rtol=0)
        torch.testing.assert_close(buf, ref_buf, atol=TOL, rtol=0)


def test_skip_leaves_everything_and_first_step_inits(trajectory_inputs):
    """keep False writes nothing (NaN gradients included); the first
    applied step sets the momentum to the decayed gradient."""
    params, grads = trajectory_inputs
    p, g = _flat(params), _flat(grads[0])
    buf = torch.full_like(p, 7.0)  # stale values the first step ignores
    init = torch.zeros((), dtype=torch.bool)
    count = torch.zeros((), dtype=torch.int32)
    nan_g = g.clone()
    nan_g[0] = float("nan")
    saved = p.clone()
    fused_sgd_(p, nan_g, buf, init, count, torch.tensor(False), lr=0.1)
    assert torch.equal(p, saved) and bool((buf == 7.0).all())
    assert not bool(init) and int(count) == 0
    fused_sgd_(p, g, buf, init, count, torch.tensor(True), lr=0.1)
    torch.testing.assert_close(buf, g + 1e-4 * saved, atol=0, rtol=0)
    assert bool(init) and int(count) == 1


def test_wrapper_dispatch_on_cpu(trajectory_inputs):
    """``auto`` runs the plain version on CPU tensors without counting a
    launch; ``cuda`` on a CPU tensor raises. ``sgd_fused`` is ``sgd``
    through the wrapper: the same update on the CPU."""
    params, grads = trajectory_inputs
    before = fused_sgd_.launches
    a = _port(params, grads, True, 1e-4, fused_sgd_)
    b = _port(params, grads, True, 1e-4, torch_fused_sgd_)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fused_sgd_.launches == before
    p, g = _flat(params), _flat(grads[0])
    flags = (torch.zeros((), dtype=torch.bool),
             torch.zeros((), dtype=torch.int32), torch.tensor(True))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        fused_sgd_(p, g, torch.zeros_like(p), *flags, lr=0.1, impl="cuda")
    assert isinstance(sgd_fused(0.1), SGD) and sgd_fused(0.1).fused
    assert not sgd(0.1).fused
    runs = []
    for opt in (sgd(0.1), sgd_fused(0.1)):
        state = (p.clone(), g, torch.full_like(p, 0.5),
                 torch.ones((), dtype=torch.bool),
                 torch.zeros((), dtype=torch.int32), torch.tensor(True))
        opt.apply_(*state, lr_step=1)
        runs.append(state)
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_multistep_lr_matches_jax():
    ours = multistep_lr(0.1, milestones=[60, 80], gamma=0.1)
    ref = jax_optim.multistep_lr(0.1, milestones=[60, 80], gamma=0.1)
    for epoch in (1, 59, 60, 61, 79, 80, 81, 120):
        assert ours(epoch) == float(ref(epoch)), epoch
    assert SGD(ours).lr(80) == float(np.float32(0.1) * np.float32(0.01))


@pytest.mark.parametrize("nesterov", [True, False])
def test_plain_matches_torch_optim_sgd(trajectory_inputs, nesterov):
    """The same rule as ``torch.optim.SGD(momentum, weight_decay,
    nesterov)`` on one flat parameter over the applied steps (torch's
    optimizer has no skip: it sees only the kept gradients)."""
    params, grads = trajectory_inputs
    p, buf, _, _ = _port(params, grads, nesterov, 1e-4, torch_fused_sgd_)
    ref = torch.nn.Parameter(_flat(params))
    opt = torch.optim.SGD([ref], lr=0.1, momentum=0.9, weight_decay=1e-4,
                          nesterov=nesterov)
    for g, keep in zip(grads, KEEP):
        if keep:
            ref.grad = _flat(g)
            opt.step()
    torch.testing.assert_close(p, ref.detach(), atol=TOL, rtol=0)
    torch.testing.assert_close(buf, opt.state[ref]["momentum_buffer"],
                               atol=TOL, rtol=0)
