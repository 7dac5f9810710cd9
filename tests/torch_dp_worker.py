"""A data-parallel rank of the port's LM train step, for
``tests/test_torch_lm_train.py``: started by ``torch.multiprocessing``
with the gloo backend. jax-free, so the spawned processes import PyTorch
only."""

import os

import torch


def train_rank(rank, world, port, inputs_path, out_path):
    """Join the group through the ``PMDT_*`` env, take this rank's rows
    of each global batch, step, and (rank 0) save the losses and the
    final flat params."""
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, local_rows, make_lm_eval_step,
        make_lm_train_step, sgd)

    dist.init_process("cpu")
    inputs = torch.load(inputs_path, weights_only=True)
    model = get_model("gpt_tiny")
    state = create_lm_train_state(model, inputs["params"])
    step = make_lm_train_step(model, sgd(0.1),
                              grad_accum=int(inputs["grad_accum"]))
    losses = []
    for batch in inputs["batches"].numpy():
        _, m = step(state, torch.from_numpy(local_rows(batch)))
        losses.append(float(m["loss"]))
    ev = make_lm_eval_step(model)(
        state, torch.from_numpy(local_rows(inputs["batches"][0].numpy())))
    if dist.is_primary():
        torch.save({"losses": losses, "params": state.params,
                    "eval": float(ev["loss"])}, out_path)
    dist.destroy_process_group()
