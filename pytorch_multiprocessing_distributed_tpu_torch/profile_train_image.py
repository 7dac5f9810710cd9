"""Where an image train step's device time goes, on the card.

    python -m pytorch_multiprocessing_distributed_tpu_torch.profile_train_image

Builds the image train step of ``main`` (ResNet-18, random init from
seed 0, f32 with PyTorch's default TF32 convolutions, as the CLI runs
it; ``--optimizer sgd_fused``; one card, lr 0.1) on batches of 64
synthetic CIFAR images already on the card, warms it up, then times 20
steps with the host clock around a ``torch.cuda.synchronize()`` and
traces 20 more with ``torch.profiler``. Prints the card's name and power
limit, the step time, images/s, each kernel group's device time per step
and share of the step, the device's idle share and the top kernels; then
the host time the CLI's loader spends on one batch (augmentation,
normalisation, the pinned copy), which the CLI's loop adds to every step
(``main``'s steady step). Needs a CUDA card.
"""

from __future__ import annotations

import time

import torch

from .data import ShardedLoader, normalize, prefetch, synthetic_cifar10
from .device import resolve_device
from .models import get_model, init_resnet
from .profile_train_lm import card, profile_steps, report
from .train import create_train_state, make_train_step, sgd_fused

GROUPS = (
    ("fused SGD (ours)", ("fused_sgd",)),
    ("convolution (cuDNN)", ("conv", "Conv", "cudnn", "wgrad", "dgrad",
                             "implicit", "xmma", "sm90_", "cutlass",
                             "gemm", "Gemm", "nvjet")),
    ("reductions (BatchNorm stats, loss)", ("reduce", "Reduce",
                                            "logsumexp", "LogSumExp")),
)
BATCH, STEPS, SEED, TOP = 64, 20, 0, 15


def main() -> dict:
    device = resolve_device("cuda")
    smi = card()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, the CLI's
    model = init_resnet(get_model("res"), SEED).to(device)
    state = create_train_state(model)
    step = make_train_step(model, sgd_fused(0.1))
    x, y = synthetic_cifar10(STEPS * BATCH, seed=SEED)
    images = torch.from_numpy(normalize(x)).to(device).view(
        STEPS, BATCH, 32, 32, 3)
    labels = torch.from_numpy(y).to(device).view(STEPS, BATCH)
    for i in range(3):  # warm-up: kernel builds, cuDNN heuristics
        step(state, images[i], labels[i])
    step_s, kernels, groups = profile_steps(
        lambda i: step(state, images[i], labels[i]), STEPS, GROUPS)
    print(smi)
    print(f"[profile] ResNet-18 f32 (TF32 convolutions) B={BATCH}: "
          f"{BATCH / step_s:.1f} images/s on device-resident batches")
    busy_ms = report(f"ResNet-18 f32 B={BATCH}", step_s, kernels, groups,
                     STEPS, smi, TOP)

    loader = ShardedLoader(x, y, batch_size=BATCH, world_size=1)
    loader.set_epoch(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in prefetch(loader, device):
        n += 1
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"[profile] loader: {host_ms:.2f} ms of host time per batch of "
          f"{BATCH} (crop, flip, normalise, pinned copy), {n} batches "
          f"[{smi}]")
    return {"step_ms": step_s * 1e3, "busy_ms": busy_ms,
            "loader_ms": host_ms,
            "groups_ms": {k: v / 1e3 / STEPS for k, v in groups.items()}}


if __name__ == "__main__":
    main()
