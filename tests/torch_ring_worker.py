"""Gloo ranks of the port's ring all-reduce, for
``tests/test_torch_ring_allreduce.py``: started by
``torch.multiprocessing`` through :func:`torch_image_worker.spawn_ranks`
(one intra-op thread a rank, a bounded join). jax-free, so the spawned
processes import PyTorch only."""

import os

import torch

from torch_image_worker import _join


def ring_rank(rank, world, port, inputs_path, out_dir):
    """``ring_all_reduce`` of this rank's row of every input (CPU tensors:
    the plain hops over gloo); saves the results to
    ``out_dir/rank{rank}.pt``."""
    dist = _join(rank, world, port)
    from pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce \
        import ring_all_reduce

    inputs = torch.load(inputs_path, weights_only=True)
    out = {name: ring_all_reduce(x[rank]) for name, x in inputs.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def ring_cuda_rank(rank, world, port, calls, out_dir):
    """``calls`` consecutive ``ring_all_reduce`` calls on this rank's card
    (NCCL group, the kernel over peer memory), each on fresh seeded
    inputs of a size and dtype that cycle (the slots grow on the way),
    each held bit for bit against the plain version of every rank's
    inputs computed here; saves the worst error and the launches."""
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.allreduce_bw import (
        seeded_inputs)
    from pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce \
        import release_peer_buffers, ring_all_reduce, torch_ring_all_reduce
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist

    dist.init_process("cuda")
    device = dist.device_for_rank("cuda")
    sizes = (1, 40 * 33, 3 * 1000 + 7, 1_000_003, 70_000)
    worst, mismatches = 0.0, 0
    for call in range(calls):
        dtype = (torch.float32, torch.bfloat16)[call % 2]
        xs = [x.to(dtype) for x in seeded_inputs(sizes[call % len(sizes)],
                                                 world, device, seed=call)]
        got = ring_all_reduce(xs[rank])
        want = torch_ring_all_reduce(xs)[rank]
        mismatches += int(not torch.equal(got, want))
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    torch.save({"worst": worst, "mismatches": mismatches,
                "launches": ring_all_reduce.launches},
               os.path.join(out_dir, f"rank{rank}.pt"))
    release_peer_buffers()
    dist.destroy_process_group()
