"""A rank of ``tests/test_torch_heal.py``'s heartbeat drill, jax-free,
run as a script with the ``PMDT_*`` env naming its group:
``python tests/torch_heal_worker.py peer_loss``.

Both ranks join over gloo (``PMDT_HEARTBEAT`` arms the monitor at
rendezvous), pass one gate and a barrier; rank 1 then exits at once
(code 3) without leaving the group, and rank 0 keeps gating, as a
trainer does at its window boundaries, until the gate names the lost
rank (``raised PeerLostError who=1``, code 0) or 30 s pass (code 1)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist  # noqa: E402
from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal  # noqa: E402
from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (  # noqa: E402
    PeerLostError)


def peer_loss() -> None:
    torch.set_num_threads(1)
    dist.init_process("cpu")
    if heal.active_monitor() is None:
        print("no monitor armed", flush=True)
        os._exit(2)
    dist.gate_collectives()
    dist.barrier()
    if dist.get_rank() == 1:
        os._exit(3)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30:
        try:
            dist.gate_collectives()
        except PeerLostError as e:
            print(f"raised PeerLostError who={e.who} after "
                  f"{time.monotonic() - t0:.2f} s: {e}", flush=True)
            os._exit(0)  # the peer is gone: leave without a teardown
        time.sleep(0.02)
    os._exit(1)


if __name__ == "__main__":
    {"peer_loss": peer_loss}[sys.argv[1]]()
