"""The port's GSPMD train and eval steps (``--zero1``, ``--fsdp``,
``--model_parallel``; ``pytorch_multiprocessing_distributed_tpu_torch/
train/gspmd.py`` on ``train/placement.py``) against the JAX package's
``make_train_step_tp`` and ``make_eval_step_tp``.

On ``tests/image_step_cases.py``'s small ResNet (BN built with
``bn_axis=None`` on the JAX side, as the JAX CLI builds it for this
path), each of three steps from JAX's state (gathered to the host, carried
into the port's payload and placed on the port's grid), on spawned gloo
ranks laid out as a ``(data, model)`` grid, against JAX on as many
virtual devices laid out by ``make_mesh``, within 1e-5 in params, BN
stats, moments, EMA and the loss:

- ``--zero1`` at (4, 1) with SGD and LAMB;
- ``--fsdp`` at (4, 1), also with ``grad_accum=2`` and with clipping;
- ``--model_parallel 2`` at (2, 2), with ``--zero1`` (SGD and LAMB) and
  with ``--fsdp``, the EMA and ``remat``;
- ``--model_parallel 4`` at (1, 4);
- the eval step at (2, 2), with padding rows masked out.

Every rank's resident bytes equal JAX's per-device bytes of that
placement. On a 1 x 1 grid (one process, no group) each mode is
bit-equal to the plain data-parallel step: params, stats, moments.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.parallel.mesh import make_mesh
from pytorch_multiprocessing_distributed_tpu.runtime import hbm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train import step as jax_step
from pytorch_multiprocessing_distributed_tpu.train.lamb import (
    lamb as jax_lamb)
from pytorch_multiprocessing_distributed_tpu.models import resnet as jresnet
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from image_step_cases import (ARCH, BATCH, IMAGE, LR, STEPS, TOL,
                              assert_transitions_match, family, jax_state,
                              make_spec, port_run, transitions,
                              worker_inputs)
from torch_image_worker import gspmd_steps_rank, run_steps, spawn_ranks
from zoo_carry import port_payload

CLIP = {"clip_grad_norm": 0.5}
ACCUM = {"grad_accum": 2}
EMA_REMAT = {"ema_decay": 0.9, "remat": True}
# (name, grid, optimizer, transforms, zero1, fsdp)
CASES = [
    ("zero1", (4, 1), "sgd", {}, True, False),
    ("zero1", (4, 1), "lamb", {}, True, False),
    ("fsdp", (4, 1), "sgd", {}, False, True),
    ("fsdp-accum", (4, 1), "sgd", ACCUM, False, True),
    ("fsdp-clip", (4, 1), "sgd", CLIP, False, True),
    ("mp2", (2, 2), "sgd", {}, False, False),
    ("mp2-zero1", (2, 2), "sgd", {}, True, False),
    ("mp2-zero1", (2, 2), "lamb", {}, True, False),
    ("mp2-fsdp-ema-remat", (2, 2), "sgd", EMA_REMAT, False, True),
    ("mp4", (1, 4), "sgd", {}, False, False),
]
EVAL_GRID = (2, 2)


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


def _jax_model():
    return jresnet.ResNet(block=jresnet.BasicBlock,
                          num_blocks=tuple(ARCH["blocks"]), stem=ARCH["stem"],
                          num_classes=ARCH["num_classes"], bn_axis=None)


def _mesh(grid):
    return make_mesh(*grid, devices=jax.devices()[:grid[0] * grid[1]])


def _jax_optimizer(fam):
    return (jax_lamb(LR["lamb"], weight_decay=1e-4) if fam == "lamb"
            else jax_optim.sgd(LR["sgd"]))


def jax_tp_trajectory(spec, fam, grid, kw, zero1, fsdp):
    """JAX ``make_train_step_tp`` on a ``make_mesh(*grid)`` over the
    spec's steps: ``(losses, host states, per-device bytes)``, the states
    gathered before and after each step, the bytes of each part of the
    placed state."""
    mesh = _mesh(grid)
    state = jax_step.shard_state(
        jax_state(spec["params"], spec["stats"], fam, "ema_decay" in kw),
        mesh, zero1=zero1, fsdp=fsdp)
    step = jax_step.make_train_step_tp(_jax_model(), _jax_optimizer(fam),
                                       mesh, zero1=zero1, fsdp=fsdp, **kw)
    shapes = {"params": hbm.tree_shard_nbytes(state.params),
              "batch_stats": hbm.tree_shard_nbytes(state.batch_stats),
              "opt_state": hbm.tree_shard_nbytes(
                  [state.opt_state.momentum] if fam == "sgd" else
                  [state.opt_state.mu, state.opt_state.nu]),
              "ema_params": hbm.tree_shard_nbytes(state.ema_params)}
    losses, states = [], [jax.device_get(state)]
    for x, y in zip(spec["images"].numpy(), spec["labels"].numpy()):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        states.append(jax.device_get(state))
    return losses, states, shapes


def _eval_batch():
    rng = np.random.default_rng(11)
    images = rng.normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, ARCH["num_classes"], BATCH).astype(np.int64)
    valid = np.arange(BATCH) % 5 != 3  # padding rows masked out
    return images, labels, valid


def _tag(name, opt):
    return f"{name}-{opt}"


@pytest.fixture(scope="module")
def gspmd_case(tmp_path_factory):
    """Every case's JAX trajectory and, one spawn of gloo ranks a grid,
    the port's three steps of each from JAX's states, and the eval
    step."""
    spec = make_spec()
    jax_runs, by_grid = {}, {}
    for name, grid, opt, kw, zero1, fsdp in CASES:
        fam = family(opt)
        losses, states, nbytes = jax_tp_trajectory(spec, fam, grid, kw,
                                                   zero1, fsdp)
        jax_runs[_tag(name, opt)] = (losses, states, nbytes)
        by_grid.setdefault(grid, []).extend(
            r | {"name": f"{r['name']}@{r['tag']}"}
            for r in transitions(name, opt, kw, states,
                                 placement={"zero1": zero1, "fsdp": fsdp}))
    images, labels, valid = _eval_batch()
    mesh = _mesh(EVAL_GRID)
    start = jax_state(spec["params"], spec["stats"], "sgd", False)
    jax_eval = jax_step.make_eval_step_tp(_jax_model(), mesh)(
        jax_step.shard_state(start, mesh), images, labels, valid)
    by_grid[EVAL_GRID].append(
        {"name": "eval", "kind": "eval", "placement": {"zero1": False,
                                                       "fsdp": False},
         "resume": port_payload(start, load_jax_resnet)})
    results = {}
    for grid, runs in by_grid.items():
        tmp = tmp_path_factory.mktemp(f"gspmd{grid[0]}x{grid[1]}")
        inputs, out = tmp / "inputs.pt", tmp / "out.pt"
        torch.save(worker_inputs(spec, runs) | {
            "grid": list(grid), "eval_images": torch.from_numpy(images),
            "eval_labels": torch.from_numpy(labels),
            "eval_valid": torch.from_numpy(valid)}, inputs)
        spawn_ranks(gspmd_steps_rank, grid[0] * grid[1],
                    (str(inputs), str(out)))
        results[grid] = torch.load(out, weights_only=True)
    return jax_runs, results, {k: float(np.asarray(v))
                               for k, v in jax_eval.items()}


@pytest.mark.parametrize("name,grid,opt,kw,zero1,fsdp", CASES,
                         ids=[_tag(c[0], c[2]) for c in CASES])
def test_gspmd_step_matches_jax(gspmd_case, name, grid, opt, kw, zero1,
                                fsdp):
    """Each of three steps from JAX's state: the port's GSPMD step on
    the grid's gloo ranks against JAX ``make_train_step_tp`` on as many
    virtual devices, within 1e-5; every rank holds JAX's per-device
    bytes of params, stats, moments and EMA."""
    jax_runs, results, _ = gspmd_case
    losses, states, nbytes = jax_runs[_tag(name, opt)]
    steps = [results[grid][f"{_tag(name, opt)}@{t}"] for t in range(STEPS)]
    assert_transitions_match(steps, losses, states)
    for got in steps:
        assert len(got["resident"]) == grid[0] * grid[1]
        for rank_bytes, opt_bytes in zip(got["resident"], got["opt_bytes"]):
            assert rank_bytes | {"opt_state": opt_bytes} == nbytes


def test_gspmd_eval_matches_jax(gspmd_case):
    """``make_eval_step_tp`` at (2, 2) with padding rows masked: the
    masked loss within 1e-5, the counts exact."""
    _, results, ref = gspmd_case
    got = results[EVAL_GRID]["eval"]
    for k in ("count", "correct", "correct5"):
        assert got[k] == ref[k], k
    assert abs(got["loss"] - ref["loss"]) < TOL
    assert ref["count"] == float(_eval_batch()[2].sum())


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
def test_one_by_one_grid_is_the_plain_step(opt):
    """One process, a 1 x 1 grid: every slice is the whole leaf and each
    mode's three steps give the plain data-parallel step's bits."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)

    spec = make_spec()
    make_grid(1, 1)
    try:
        plain = run_steps(spec, port_run("plain", opt, {}))
        for zero1, fsdp in ((False, False), (True, False), (False, True)):
            got = run_steps(spec, port_run("placed", opt, {}, placement={
                "zero1": zero1, "fsdp": fsdp}))
            assert got["losses"] == plain["losses"]
            for k, v in plain["state"].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, got["state"][k]), (zero1, fsdp, k)
    finally:
        reset_grid()
