"""The port's LAMB (``train/lamb.py``) against the JAX package's ``lamb``
transform: three updates of a small parameter set, one leaf of which is
all zeros (its trust ratio is the guarded 1), with a non-finite step
among them (the guard keeps the params, both moments and the count),
within 1e-6; and the LAMB state's checkpoint payload."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from pytorch_multiprocessing_distributed_tpu.train.lamb import (
    lamb as jax_lamb)
from pytorch_multiprocessing_distributed_tpu.train.optim import (
    apply_updates)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    TrainState, lamb)
from pytorch_multiprocessing_distributed_tpu_torch.train.optim import (
    multistep_lr)

TOL = 1e-6
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}  # b starts at zero


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Leaves(nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, v in values.items():
            setattr(self, name, nn.Parameter(torch.from_numpy(v.copy())))


def _values(seed):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=s).astype(np.float32)
           for k, s in SHAPES.items()}
    out["b"][:] = 0
    return out


def _grads(rng, finite=True):
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    g["b"] *= 1e-3
    if not finite:
        g["c"][1, 0, 2] = np.nan
    return g


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 0.3])
def test_three_updates_match_jax(weight_decay):
    params = _values(0)
    rng = np.random.default_rng(1)
    steps = [_grads(rng), _grads(rng, finite=False), _grads(rng),
             _grads(rng)]
    lr = multistep_lr(0.01, milestones=[2], gamma=0.5)

    state = TrainState.bind(Leaves(params), second_moment=True)
    opt = lamb(learning_rate=lr, weight_decay=weight_decay)
    tx = jax_lamb(learning_rate=lambda e: np.float32(lr(int(e))),
                  weight_decay=weight_decay)
    ref_p, ref_s = dict(params), tx.init(params)
    for epoch, g in enumerate(steps, start=1):
        state.epoch = epoch
        flat = torch.cat([torch.from_numpy(g[k]).reshape(-1)
                          for k, _, _ in state.layout])
        keep = torch.isfinite(flat).all()
        opt.update_(state, flat, keep)
        if all(np.isfinite(v).all() for v in g.values()):
            upd, ref_s = tx.update(g, ref_s, ref_p, lr_step=epoch)
            ref_p = jax.device_get(apply_updates(ref_p, upd))
            ref_s = jax.device_get(ref_s)
        views = {"params": state.views(state.params),
                 "mu": state.views(state.momentum),
                 "nu": state.views(state.nu)}
        for k in SHAPES:
            np.testing.assert_allclose(views["params"][k].numpy(), ref_p[k],
                                       atol=TOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(views["mu"][k].numpy(), ref_s.mu[k],
                                       atol=TOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(views["nu"][k].numpy(), ref_s.nu[k],
                                       atol=TOL, rtol=0, err_msg=k)
        assert int(state.count) == int(ref_s.count)
    assert int(state.count) == 3  # the non-finite step did not count
    assert views["params"]["b"].abs().max() > 0  # the zero leaf moved


def test_state_payload_round_trips_the_moments():
    state = TrainState.bind(Leaves(_values(0)), second_moment=True)
    opt = lamb(learning_rate=0.01)
    for seed in (1, 2):
        g = _grads(np.random.default_rng(seed))
        flat = torch.cat([torch.from_numpy(g[k]).reshape(-1)
                          for k, _, _ in state.layout])
        opt.update_(state, flat, torch.tensor(True))
    payload = state.to_dict()
    assert {"opt_state/mu/a", "opt_state/nu/c", "opt_state/count"} <= set(
        payload)
    assert not any(k.startswith("opt_state/momentum") for k in payload)
    fresh = TrainState.bind(Leaves(_values(3)), second_moment=True)
    fresh.load_dict(payload)
    for a, b in ((fresh.params, state.params), (fresh.momentum,
                                                state.momentum),
                 (fresh.nu, state.nu), (fresh.count, state.count)):
        assert torch.equal(a, b)
    sgd_state = TrainState.bind(Leaves(_values(0)))
    assert sgd_state.nu is None
    assert "opt_state/momentum/a" in sgd_state.to_dict()
