"""Data-parallel ranks of the port's image path, for
``tests/test_torch_sync_bn.py`` and ``tests/test_torch_image_train.py``:
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
