"""Ranks of the port's sequence-parallel paths on the CPU, for
``tests/test_torch_ring_attention.py`` and
``tests/test_torch_sp_train.py``: started by ``torch.multiprocessing``
with the gloo backend, one intra-op thread each. jax-free, so the
spawned processes import PyTorch only. Each rank writes its results to
``{out_path}.{rank}``."""

import os

import torch


def _join(rank, world, port, device="cpu"):
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist

    dist.init_process(device)
    return dist


def attention_rank(rank, world, port, inputs_path, out_path):
    """Ring (causal and not, contiguous and zigzag) and Ulysses attention
    over a 1 x ``world`` seq grid: each case's local output and the
    local gradients of q, k, v under the given output cotangent."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.ring_attention \
        import ring_attention, zigzag_indices
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.ulysses \
        import ulysses_attention

    make_grid(1, world, axis="seq")
    inputs = torch.load(inputs_path, weights_only=True)
    s = inputs["q"].shape[1]
    out = {}
    for case in inputs["cases"]:
        kind, causal = case.split("_")
        causal = causal == "causal"
        cols = (torch.from_numpy(zigzag_indices(s, world)[rank])
                if kind == "zigzag"
                else torch.arange(rank * s // world, (rank + 1) * s // world))
        q, k, v = (inputs[n][:, cols].clone().requires_grad_()
                   for n in ("q", "k", "v"))
        if kind == "ulysses":
            o = ulysses_attention(q, k, v, causal=causal)
        else:
            o = ring_attention(q, k, v, causal=causal,
                               zigzag=kind == "zigzag")
        o.backward(inputs["do"][:, cols])
        out[case] = {"out": o.detach(), "dq": q.grad, "dk": k.grad,
                     "dv": v.grad}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()


def lm_rank(rank, world, port, inputs_path, out_path):
    """``make_lm_train_step`` on a ``grid`` of ranks for each run of
    ``inputs["runs"]`` (``(sp_mode, vocab_chunks)``): the losses (and an
    MoE model's balance losses) of ``steps`` SGD steps from the given
    params and the final flat params, then one eval step on the first
    batch."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, local_rows, make_lm_eval_step,
        make_lm_train_step, sgd)

    inputs = torch.load(inputs_path, weights_only=False)
    dp, deg = inputs["grid"]
    grid = make_grid(dp, deg, axis="seq")
    batches = inputs["batches"].numpy()
    out = {}
    for mode, chunks in inputs["runs"]:
        model = GPT(**inputs["geometry"], seq_axis="seq", sp_mode=mode)
        state = create_lm_train_state(model, {
            k: v.clone() for k, v in inputs["params"].items()})
        step = make_lm_train_step(model, sgd(inputs["lr"]), seq_axis="seq",
                                  vocab_chunks=chunks)
        losses, aux = [], []
        for batch in batches:
            rows = torch.from_numpy(local_rows(batch, grid.data_index, dp))
            _, m = step(state, rows)
            losses.append(float(m["loss"]))
            if "moe_aux" in m:
                aux.append(float(m["moe_aux"]))
        ev = make_lm_eval_step(model, seq_axis="seq", vocab_chunks=chunks)(
            state, torch.from_numpy(local_rows(batches[0], grid.data_index,
                                               dp)))
        out[f"{mode}_{chunks}"] = {"losses": losses, "aux": aux,
                                   "params": {
                                       k: t.clone() for k, t in
                                       state.views(state.params).items()},
                                   "eval": float(ev["loss"]),
                                   "count": float(ev["count"])}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()


def cli_rank(rank, world, port, argv, params_path, layers):
    """``train_lm.main(argv)`` on this rank, the model cut to ``layers``
    blocks and started from the given params (the JAX CLI's init);
    rank 0 writes the summary to ``{save_path}/summary.pt``."""
    _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch import train_lm

    params = torch.load(params_path, weights_only=True)
    get_model = train_lm.get_model
    train_lm.get_model = lambda name, **kw: get_model(name, num_layers=layers,
                                                      **kw)
    train_lm.init_params = lambda model, seed, device: {
        k: v.clone() for k, v in params.items()}
    summary = train_lm.main(argv)
    if rank == 0:
        save = argv[argv.index("--save_path") + 1]
        torch.save(summary, os.path.join(save, "summary.pt"))


def card_attention_rank(rank, world, port, out_dir):
    """One NCCL rank a card: ring (causal and not), zigzag and Ulysses
    attention at degree ``world`` in f32 and bf16 against the flash
    kernels on the whole sequence on this card; writes the largest
    differences of the output and the q/k/v gradients to
    ``{out_dir}/{rank}.pt``."""
    dist = _join(rank, world, port, "cuda")
    from pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention \
        import flash_attention
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.ring_attention \
        import ring_attention, zigzag_indices
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.ulysses \
        import ulysses_attention

    make_grid(1, world, axis="seq")
    dev = dist.device_for_rank("cuda")
    b, s, h, d = 2, 256 * world, 4, 64
    gen = torch.Generator().manual_seed(0)
    full = {n: torch.randn(b, s, h, d, generator=gen)
            for n in ("q", "k", "v", "do")}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = {n: t.to(dev, dtype) for n, t in full.items()}
        for case in ("ring_causal", "ring_full", "zigzag_causal",
                     "ulysses_causal"):
            kind, causal = case.split("_")
            causal = causal == "causal"
            q, k, v = (x[n].clone().requires_grad_() for n in "qkv")
            ref = flash_attention(q, k, v, causal=causal)
            ref.backward(x["do"])
            want = (ref, q.grad, k.grad, v.grad)
            cols = (torch.from_numpy(zigzag_indices(s, world)[rank])
                    if kind == "zigzag"
                    else torch.arange(rank * s // world,
                                      (rank + 1) * s // world)).to(dev)
            q, k, v = (x[n][:, cols].clone().requires_grad_() for n in "qkv")
            if kind == "ulysses":
                out = ulysses_attention(q, k, v, causal=causal)
            else:
                out = ring_attention(q, k, v, causal=causal,
                                     zigzag=kind == "zigzag")
            out.backward(x["do"][:, cols])
            got = (out, q.grad, k.grad, v.grad)
            errs[f"{case}_{str(dtype)[6:]}"] = [
                float((g.float() - w[:, cols].float()).abs().max())
                for g, w in zip(got, want)]
    torch.save(errs, os.path.join(out_dir, f"{rank}.pt"))
    dist.destroy_process_group()


def vit_rank(rank, world, port, inputs_path, out_path):
    """``ViT(seq_axis="seq")`` on this rank of a 1 x ``world`` seq grid,
    PyTorch's native convolutions: the logits of this rank's images and
    the parameters' gradients of ``(logits * cotangent).sum()``."""
    dist = _join(rank, world, port)
    torch.backends.mkldnn.enabled = False
    from pytorch_multiprocessing_distributed_tpu_torch.models import ViT
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)

    make_grid(1, world, axis="seq")
    inputs = torch.load(inputs_path, weights_only=True)
    model = ViT(**inputs["geometry"], seq_axis="seq")
    model.load_state_dict(inputs["state"])
    logits = model(inputs["x"][rank])
    (logits * inputs["c"][rank]).sum().backward()
    torch.save({"logits": logits.detach(),
                "grads": {n: p.grad for n, p in model.named_parameters()}},
               f"{out_path}.{rank}")
    dist.destroy_process_group()
