"""Data-parallel ranks of the port's image path, for
``tests/test_torch_sync_bn.py``, ``tests/test_torch_image_train.py``,
``tests/test_torch_step_transforms.py``, ``tests/test_torch_zero.py``
and ``tests/test_torch_gspmd.py``:
started by ``torch.multiprocessing`` with the gloo backend. jax-free, so
the spawned processes import PyTorch only.

Each rank runs on one intra-op thread, joins the group through the
``PMDT_*`` env of its own process and leaves it before returning.
:func:`spawn_ranks` starts them and waits a bounded time.
"""

import os
import socket
import time

import torch
import torch.multiprocessing as mp


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world, args, timeout_s=120.0):
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned
    processes and join them within ``timeout_s``; a rank that raised
    re-raises here, and ranks still alive at the deadline are terminated
    and reported."""
    ctx = mp.start_processes(fn, args=(world, free_port(), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks of {fn.__name__} still running after "
                    f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def _join(rank, world, port):
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist

    dist.init_process("cpu")
    return dist


def sync_bn_rank(rank, world, port, inputs_path, out_dir):
    """One train-mode forward and backward of ``SyncBatchNorm`` on this
    rank's rows of ``x`` (NHWC, as the JAX layer takes it) with the loss
    ``sum(y * c)``; saves ``y``, the input gradient and the running
    stats to ``out_dir/rank{rank}.pt``."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.ops.batch_norm import (
        SyncBatchNorm)

    inputs = torch.load(inputs_path, weights_only=True)
    per = inputs["x"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    x = inputs["x"][rows].permute(0, 3, 1, 2).requires_grad_()
    c = inputs["c"][rows].permute(0, 3, 1, 2)
    bn = SyncBatchNorm(x.shape[1])
    bn.load_state_dict(inputs["state"])
    y = bn(x)
    (y * c).sum().backward()
    torch.save({"y": y.detach().permute(0, 2, 3, 1),
                "dx": x.grad.permute(0, 2, 3, 1),
                "running_mean": bn.running_mean,
                "running_var": bn.running_var},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def image_train_rank(rank, world, port, inputs_path, out_path):
    """For each optimizer named in the inputs, image train steps of
    ResNet-18 (at the inputs' lr, with oneDNN on or off as they say) from
    the carried weights on this rank's rows of each global batch; rank 0
    saves each run's losses, params, momenta and BN stats."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, local_rows, make_train_step, sgd, sgd_fused)

    inputs = torch.load(inputs_path, weights_only=True)
    torch.backends.mkldnn.enabled = inputs["mkldnn"]
    runs = {}
    for name in inputs["optimizers"]:
        model = get_model("res")
        model.load_state_dict(inputs["state_dict"])
        state = create_train_state(model)
        make = sgd_fused if name == "sgd_fused" else sgd
        step = make_train_step(model, make(inputs["lr"]))
        losses = []
        for images, labels in zip(inputs["images"].numpy(),
                                  inputs["labels"].numpy()):
            _, m = step(state, torch.from_numpy(local_rows(images)),
                        torch.from_numpy(local_rows(labels)))
            losses.append(float(m["loss"]))
        runs[name] = {"losses": losses, "params": state.params,
                      "momentum": state.momentum, "stats": state.stats}
    if dist.is_primary():
        torch.save(runs, out_path)
    dist.destroy_process_group()


def build_model(arch):
    """The port's ResNet of ``arch``: ``{"blocks", "stem",
    "num_classes"}``."""
    from pytorch_multiprocessing_distributed_tpu_torch.models.resnet import (
        BasicBlock, ResNet)

    return ResNet(BasicBlock, tuple(arch["blocks"]), stem=arch["stem"],
                  num_classes=arch["num_classes"])


def make_optimizer(name, lr):
    """``sgd``/``sgd_fused`` (Nesterov, weight decay 1e-4) or ``lamb``
    (weight decay 1e-4, the CLI's)."""
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        lamb, sgd, sgd_fused)

    if name == "lamb":
        return lamb(lr, weight_decay=1e-4)
    return (sgd_fused if name == "sgd_fused" else sgd)(lr)


def placed_state(model, opt, run, ema=False):
    """The run's train state over ``model``: a fresh one with its
    ``resume`` payload loaded, then placed on the grid when the run
    names a ``placement`` (``{"zero1", "fsdp"}``)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        get_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state)
    from pytorch_multiprocessing_distributed_tpu_torch.train.placement import (
        plan_placement, shard_state)

    state = create_train_state(model, opt, ema=ema)
    if run.get("resume") is not None:
        state.load_dict(run["resume"])
    if run.get("placement") is not None:
        grid = get_grid()
        state = shard_state(state, plan_placement(
            model, grid.data, grid.model, **run["placement"]), grid)
    return state


def run_steps(spec, run, world=1, rank=0):
    """One run of the port's image step: ``spec`` holds the ``arch``,
    the carried ``state_dict`` and the global ``images``/``labels`` of
    each step; ``run`` names the ``optimizer``, ``lr``, the step's
    transforms (``kw``), ``zero`` (with an optional ``bucket_bytes``) or
    a GSPMD ``placement`` (on the grid of the spawn: the rows of this
    rank's data index), the ``steps`` to take from step ``start`` and an
    optional ``resume`` payload loaded first. Returns the losses, the
    global norm of the reduced gradients after each step (replicated
    runs), the final state's checkpoint payload (moments gathered, a
    placed state's slices gathered), this rank's optimizer-state bytes
    and each resident buffer's bytes."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import zero
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        get_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, local_rows, make_train_step)
    from pytorch_multiprocessing_distributed_tpu_torch.train.gspmd import (
        make_train_step_tp)

    model = build_model(spec["arch"])
    model.load_state_dict(spec["state_dict"])
    opt = make_optimizer(run["optimizer"], run["lr"])
    kw = run.get("kw", {})
    placed = run.get("placement") is not None
    plan = (zero.plan_buckets(model, world,
                              bucket_bytes=run.get("bucket_bytes"))
            if run.get("zero") else None)
    if placed:
        state = placed_state(model, opt, run, ema=bool(kw.get("ema_decay")))
        step = make_train_step_tp(model, opt, **kw)
        rank, world = get_grid().data_index, get_grid().data
    else:
        state = create_train_state(model, opt,
                                   ema=bool(kw.get("ema_decay")), plan=plan)
        if run.get("resume") is not None:
            state.load_dict(run["resume"])
        step = make_train_step(model, opt, **kw)
    if plan is not None:
        zero.zeroify_state(state, plan, rank)
    start = run.get("start", 0)
    losses, norms = [], []
    for t in range(start, start + run.get("steps", len(spec["images"]))):
        x = local_rows(spec["images"][t].numpy(), rank, world)
        y = local_rows(spec["labels"][t].numpy(), rank, world)
        _, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(m["loss"]))
        if plan is None and not placed:
            norms.append(float(torch.linalg.vector_norm(
                state.grads[:state.n])))
    moments = zero.gather_opt_state(state) if plan is not None else {}
    return {"losses": losses, "norms": norms,
            "state": state.to_dict(**moments),
            "opt_bytes": zero.opt_state_bytes(state),
            "resident": {k: 0 if t is None else t.numel() * 4
                         for k, t in (("params", state.params),
                                      ("batch_stats", state.stats),
                                      ("ema_params", state.ema))}}


def run_eval(spec, run):
    """The GSPMD eval step on the placed state of ``run`` (its
    ``resume`` payload) over the rows of this rank's data index of the
    spec's ``eval_images``/``eval_labels``/``eval_valid``: the metrics
    as floats."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        get_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        local_rows)
    from pytorch_multiprocessing_distributed_tpu_torch.train.gspmd import (
        make_eval_step_tp)

    model = build_model(spec["arch"])
    state = placed_state(model, None, run)
    grid = get_grid()

    def rows(key):
        return torch.from_numpy(local_rows(spec[key].numpy(),
                                           grid.data_index, grid.data))

    m = make_eval_step_tp(model)(state, rows("eval_images"),
                                 rows("eval_labels"), rows("eval_valid"))
    return {k: float(v) for k, v in m.items()}


def gspmd_steps_rank(rank, world, port, inputs_path, out_path):
    """The inputs' ``runs`` (:func:`run_steps`, or :func:`run_eval` for
    a run of ``kind`` ``eval``) on this rank of the inputs' ``grid``
    ``[data, model]``; rank 0 saves ``{name: result}`` with every rank's
    resident bytes."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        all_gather_objects)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)

    spec = torch.load(inputs_path, weights_only=True)
    torch.backends.mkldnn.enabled = spec["mkldnn"]
    make_grid(*spec["grid"])
    results = {}
    for run in spec["runs"]:
        if run.get("kind") == "eval":
            results[run["name"]] = run_eval(spec, run)
            continue
        out = run_steps(spec, run, world, rank)
        out["resident"] = all_gather_objects(out["resident"])
        out["opt_bytes"] = all_gather_objects(out["opt_bytes"])
        results[run["name"]] = out
    if dist.is_primary():
        torch.save(results, out_path)
    dist.destroy_process_group()


def steps_rank(rank, world, port, inputs_path, out_path):
    """Every run of the inputs' ``runs`` (see :func:`run_steps`) on this
    rank, in order; a run whose ``resume_from`` names an earlier run
    loads that run's final payload first. Rank 0 saves ``{name:
    result}``, with each rank's optimizer-state bytes."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        all_gather_objects)

    spec = torch.load(inputs_path, weights_only=True)
    torch.backends.mkldnn.enabled = spec["mkldnn"]
    results = {}
    for run in spec["runs"]:
        if run.get("resume_from"):
            run = dict(run, resume=results[run["resume_from"]]["state"])
        out = run_steps(spec, run, world, rank)
        out["opt_bytes"] = all_gather_objects(out["opt_bytes"])
        results[run["name"]] = out
    if dist.is_primary():
        torch.save(results, out_path)
    dist.destroy_process_group()


def gspmd_cuda_rank(rank, world, port, out_dir):
    """One NCCL rank (one card) of the card test of ``--fsdp``: ResNet-18
    from seeded weights, one step of this rank's rows of a seeded global
    batch of 64, plain and with ``--fsdp`` on a (world, 1) grid, f32
    with TF32 off and deterministic cuDNN; saves both checkpoint
    payloads (the placed one gathered)."""
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist

    dist.init_process("cuda")
    payloads = gspmd_card_steps(world, dist.device_for_rank("cuda"))
    if dist.is_primary():
        torch.save(payloads, os.path.join(out_dir, "payloads.pt"))
    dist.destroy_process_group()


def gspmd_card_steps(world, device, modes=("plain", "fsdp"), steps=1,
                     optimizer="sgd"):
    """``{mode: checkpoint payload}`` after ``steps`` steps of ResNet-18
    on the card, each mode from the same seeded weights and batches
    (``zero1``/``fsdp`` placed on a (world, 1) grid)."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        get_rank)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, make_train_step)
    from pytorch_multiprocessing_distributed_tpu_torch.train.gspmd import (
        make_train_step_tp)
    from pytorch_multiprocessing_distributed_tpu_torch.train.placement import (
        plan_placement, shard_state)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    grid = make_grid(world, 1)
    gen = torch.Generator().manual_seed(7)
    images = torch.randn(steps, 64, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (steps, 64), generator=gen)
    rows = slice(get_rank() * 64 // world, (get_rank() + 1) * 64 // world)
    out = {}
    for mode in modes:
        model = init_model(get_model("res"), 0).to(device)
        opt = make_optimizer(optimizer, 0.01 if optimizer == "sgd"
                             else 1e-3)
        state = create_train_state(model, opt)
        if mode == "plain":
            step = make_train_step(model, opt)
        else:
            state = shard_state(state, plan_placement(
                model, world, 1, **{mode: True}), grid)
            step = make_train_step_tp(model, opt)
        for t in range(steps):
            step(state, images[t, rows].to(device),
                 labels[t, rows].to(device))
        out[mode] = state.to_dict()
    return out
