"""Ranks of the port's model-parallel LM paths on the CPU (pipeline and
tensor parallelism, ``--zero`` and ``remat``), for
``tests/test_torch_pipeline.py``, ``tests/test_torch_pipeline_grid.py``,
``tests/test_torch_lm_tp.py`` and ``tests/test_torch_mp_cli.py``:
started by ``torch.multiprocessing`` with the gloo backend, one
intra-op thread each (and :func:`card_mp_rank`, one NCCL rank a card,
for ``tests/test_torch_cuda_kernels.py``). jax-free, so the spawned
processes import PyTorch only. Each rank writes its results to
``{out_path}.{rank}``."""

import os

import torch

from torch_sp_worker import _join


def _dense(state, kind, vocab):
    """The whole params of a run's state, under the GPT's names (a
    collective)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)

    if kind == "pp":
        return {k: v.clone() for k, v in gp.unstack_pipeline_params(
            state.stacked(state.params), vocab).items()}
    if kind == "tp":
        full = state.gathered()
        return {k: v.clone() for k, v in full.views(full.params).items()}
    return {k: v.clone() for k, v in state.views(state.params).items()}


def _state(run, model, params, grid_shape, rank):
    """The run's state and its train and eval steps."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.zero import (
        plan_buckets, zeroify_state)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, make_lm_eval_step, make_lm_eval_step_tp,
        make_lm_train_step, make_lm_train_step_tp, sgd)
    from pytorch_multiprocessing_distributed_tpu_torch.train.placement import (
        plan_placement, shard_state)

    dp, deg = grid_shape
    lr = run["lr"]
    params = {k: v.clone() for k, v in params.items()}
    if run["kind"] == "pp":
        make_grid(dp, deg, axis="pipe")
        state = gp.create_pipelined_lm_state(model, params, deg)
        return (state, gp.make_pipelined_lm_train_step(
                    model, sgd(lr), schedule=run["schedule"]),
                gp.make_pipelined_lm_eval_step(model))
    if run["kind"] == "tp":
        grid = make_grid(dp, deg)
        plain = create_lm_train_state(model, params)
        pl = plan_placement(model, dp, deg, zero1=run.get("zero1", False),
                            fsdp=run.get("fsdp", False))
        return (shard_state(plain, pl, grid),
                make_lm_train_step_tp(model, sgd(lr),
                                      remat=run.get("remat", False)),
                make_lm_eval_step_tp(model))
    make_grid(dp * deg, 1)
    plan = plan_buckets(model, dp * deg) if run.get("zero") else None
    state = create_lm_train_state(model, params, plan=plan)
    if plan is not None:
        zeroify_state(state, plan, rank)
    return (state, make_lm_train_step(model, sgd(lr),
                                      remat=run.get("remat", False)),
            make_lm_eval_step(model))


def steps_rank(rank, world, port, inputs_path, out_path):
    """Each run of ``inputs["runs"]`` on the grid: the losses (and an
    MoE model's balance losses) of the given batches' SGD steps from the
    given params, the final whole params, one eval step on the first
    batch and this rank's resident bytes."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        get_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        local_rows)

    inputs = torch.load(inputs_path, weights_only=False)
    batches = inputs["batches"].numpy()
    out = {}
    for name, run in inputs["runs"].items():
        grid_shape = run["grid"]
        model = GPT(**inputs["geometry"])
        state, step, eval_step = _state(run, model, inputs["params"],
                                        grid_shape, rank)
        data_index = get_grid().data_index
        dp = get_grid().data

        def rows(batch):
            return torch.from_numpy(local_rows(batch, data_index, dp))

        losses, aux = [], []
        for b in batches:
            m = step(state, rows(b))[1]
            losses.append(float(m["loss"]))
            if "moe_aux" in m:
                aux.append(float(m["moe_aux"]))
        ev = eval_step(state, rows(batches[0]))
        resident = (state.resident_bytes() if run["kind"] == "pp" else
                    state.placement.resident_bytes() if run["kind"] == "tp"
                    else {"params": 4 * state.n,
                          "opt_state": 4 * state.momentum.numel()})
        out[name] = {"losses": losses, "aux": aux,
                     "params": _dense(state, run["kind"],
                                      model.vocab_size),
                     "eval": float(ev["loss"]), "count": float(ev["count"]),
                     "resident": resident}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()


def grads_rank(rank, world, port, inputs_path, out_path):
    """The GPipe objective's CE sum and the stacked gradients of
    ``ce_sum / count`` summed over the data group (the vocab-parallel
    CE and its gradient), on a ``(dp, pipe)`` grid."""
    dist = _join(rank, world, port)
    import torch.distributed as tdist

    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        axis, make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        local_rows)

    inputs = torch.load(inputs_path, weights_only=False)
    dp, deg = inputs["grid"]
    grid = make_grid(dp, deg, axis="pipe")
    model = GPT(**inputs["geometry"])
    state = gp.create_pipelined_lm_state(
        model, {k: v.clone() for k, v in inputs["params"].items()}, deg)
    tokens = torch.from_numpy(local_rows(inputs["tokens"], grid.data_index,
                                         dp))
    b, s = tokens.shape
    count = float(b * dp * (s - 1))
    state.grads.zero_()
    ce = gp._forward_ce(model, state.model, tokens, axis("pipe"), deg)
    (ce / count).backward()
    sums = torch.stack([ce.detach()])
    if dp > 1:
        tdist.all_reduce(state.grads, group=grid.data_group)
        tdist.all_reduce(sums, group=grid.data_group)
    torch.save({"ce_sum": float(sums[0]), "count": count,
                "grads": state.stacked(state.grads[:state.n])},
               f"{out_path}.{rank}")
    dist.destroy_process_group()


def cli_rank(rank, world, port, argv, params_path, layers):
    """``train_lm.main(argv)`` on this rank, the model cut to ``layers``
    blocks and started from the given params (the JAX CLI's init); each
    rank writes its summary, with what it printed under ``stdout``, to
    ``{save_path}/summary.{rank}.pt``."""
    _join(rank, world, port)
    import contextlib
    import io

    from pytorch_multiprocessing_distributed_tpu_torch import train_lm

    params = torch.load(params_path, weights_only=True)
    get_model = train_lm.get_model
    train_lm.get_model = lambda name, **kw: get_model(name, num_layers=layers,
                                                      **kw)
    train_lm.init_params = lambda model, seed, device: {
        k: v.clone() for k, v in params.items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train_lm.main(argv)
    summary["stdout"] = buf.getvalue()
    save = argv[argv.index("--save_path") + 1]
    torch.save(summary, os.path.join(save, f"summary.{rank}.pt"))


def card_mp_rank(rank, world, port, geometry, out_dir):
    """One NCCL rank a card: one f32 SGD step (lr 0.01) of a GPT of
    ``geometry`` from seed 0's params on seed 0's tokens ``[4, 128]`` in
    each of pp gpipe, pp 1f1b and tp at degree ``world``; rank 0 writes
    each run's loss and whole params to ``{out_dir}/mp.pt``."""
    dist = _join(rank, world, port, "cuda")
    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        reset_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)

    dev = dist.device_for_rank("cuda")
    tokens = card_tokens().to(dev)
    out = {}
    for name, run in CARD_RUNS.items():
        model = GPT(**geometry)
        state, step, _ = _state(dict(run, lr=0.01), model,
                                init_params(model, 0, dev), (1, world), rank)
        _, m = step(state, tokens)
        whole = _dense(state, run["kind"], model.vocab_size)
        out[name] = (float(m["loss"]), {k: v.cpu() for k, v in whole.items()})
        reset_grid()
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "mp.pt"))
    dist.destroy_process_group()


CARD_RUNS = {"pp_gpipe": {"kind": "pp", "schedule": "gpipe"},
             "pp_1f1b": {"kind": "pp", "schedule": "1f1b"},
             "tp": {"kind": "tp"}}


def card_tokens():
    """The card tests' tokens: ``[4, 128]`` of a 257 vocab, seed 0."""
    return torch.randint(0, 257, (4, 128),
                         generator=torch.Generator().manual_seed(0))
