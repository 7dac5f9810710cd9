"""Where a training step's device time goes, on the card.

    python -m pytorch_multiprocessing_distributed_tpu_torch.profile_train_lm

Builds the LM train step of ``train_lm`` (gpt_small, random init from
seed 0, bf16, 8 x 1024 random tokens a step on one card, lr 0.01),
warms it up, then times 5 steps with the host clock around a
``torch.cuda.synchronize()`` and traces 5 more with ``torch.profiler``.
Prints the card's name and power limit, the step time, tokens/s, each
kernel group's device time per step and share of the step, the device's
idle share (1 - summed kernel time / step wall time; the step runs on
one stream, so kernels do not overlap), and the top kernels by device
time. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from .device import resolve_device
from .models import get_model
from .serving.params import init_params
from .train import create_lm_train_state, make_lm_train_step, sgd

# kernel groups by name, first match wins
GROUPS = (
    ("flash attention (ours)", ("flash_fwd", "flash_bwd")),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass", "xmma", "sm90_",
                         "cublas", "gemv", "nvjet")),
    ("reductions / softmax", ("reduce", "Reduce", "softmax", "logsumexp",
                              "LogSumExp")),
    ("index / embedding", ("index", "Index", "gather", "scatter",
                           "embedding")),
)


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "elementwise / copies / other"


MODEL, BATCH, SEQ, LR, STEPS, SEED, TOP = ("gpt_small", 8, 1024, 0.01, 5,
                                           0, 20)


def main() -> dict:
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    model = get_model(MODEL, dtype=torch.bfloat16)
    state = create_lm_train_state(model, init_params(model, SEED, device))
    step = make_lm_train_step(model, sgd(LR))
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(rng.integers(
        0, model.vocab_size, (BATCH, SEQ))).to(device) for _ in range(STEPS)]

    for b in batches[:2]:  # warm-up: kernel builds, cuBLAS heuristics
        step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        step(state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
    kernels = defaultdict(float)  # device us per kernel name, all steps
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and getattr(evt, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += dev_us
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups = defaultdict(float)
    for name, us in kernels.items():
        groups[_group(name)] += us
    busy_ms = sum(kernels.values()) / 1e3 / STEPS
    step_ms = step_s * 1e3
    tokens = BATCH * SEQ
    print(smi)
    print(f"[profile] {MODEL} bfloat16 B={BATCH} S={SEQ}: step "
          f"{step_ms:.2f} ms (host clock, {STEPS} steps), "
          f"{tokens / step_s:.1f} tokens/s, device "
          f"busy {busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f} [{smi}]")
    for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / STEPS
        print(f"[profile] group {label}: {ms:.2f} ms/step, "
              f"{ms / step_ms:.3f} of the step")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile] kernel {us / 1e3 / STEPS:8.3f} ms/step  "
              f"{name[:110]}")
    return {"step_ms": step_ms, "busy_ms": busy_ms,
            "groups_ms": {k: v / 1e3 / STEPS for k, v in groups.items()}}


if __name__ == "__main__":
    main()
