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
    inputs of a size and dtype that cycle, then one of 64 MiB, each held
    bit for bit against the plain version of every rank's inputs
    computed here; saves the worst error, the launches, the distinct
    comm buffers the calls used, and the names of the work on the card
    (``torch.profiler``) of one more contiguous f32 call."""
    torch.set_num_threads(1)
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_INIT_TIMEOUT="60")
    from pytorch_multiprocessing_distributed_tpu_torch.allreduce_bw import (
        seeded_inputs)
    from pytorch_multiprocessing_distributed_tpu_torch.ops import (
        ring_allreduce as ring)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist

    dist.init_process("cuda")
    device = dist.device_for_rank("cuda")
    sizes = (1, 40 * 33, 3 * 1000 + 7, 1_000_003, 70_000)
    worst, mismatches, buffers = 0.0, 0, set()
    for call in range(calls + 1):
        dtype = (torch.float32, torch.bfloat16)[call % 2]
        size = sizes[call % len(sizes)] if call < calls else 16 * 2 ** 20
        xs = [x.to(dtype) for x in seeded_inputs(size, world, device,
                                                 seed=call)]
        got = ring.ring_all_reduce(xs[rank])
        want = ring.torch_ring_all_reduce(xs)[rank]
        mismatches += int(not torch.equal(got, want))
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        buffers |= {(id(r), r.own) for r in ring._rings.values()}
        del xs
    x = seeded_inputs(4_903_242, 1, device, seed=calls + 1)[0]
    torch.cuda.synchronize()
    launches = ring.ring_all_reduce.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ring.ring_all_reduce(x)
        torch.cuda.synchronize()
    kernels = sorted({"ring_kernel" if "ring_kernel" in e.name else e.name
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA})
    torch.save({"worst": worst, "mismatches": mismatches,
                "launches": launches, "buffers": len(buffers),
                "kernels": kernels},
               os.path.join(out_dir, f"rank{rank}.pt"))
    ring.release_peer_buffers()
    dist.destroy_process_group()
