"""Where a training step's device time goes, on the card.

    python -m pytorch_multiprocessing_distributed_tpu_torch.profile_train_lm
    python -m pytorch_multiprocessing_distributed_tpu_torch.profile_train_lm \
        --dtype float32

Builds the LM train step of ``train_lm`` (gpt_small, random init from
seed 0, bf16 or, with ``--dtype float32``, ``train_lm``'s default f32
with TF32 off, 8 x 1024 random tokens a step on one card, lr 0.01),
warms it up, then times 5 steps with the host clock around a
``torch.cuda.synchronize()`` and traces 5 more with ``torch.profiler``.
Prints the card's name and power limit, the step time, tokens/s, each
kernel group's device time per step and share of the step, the device's
idle share (1 - summed kernel time / step wall time; the step runs on
one stream, so kernels do not overlap), and the top kernels by device
time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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


def _group(name: str, groups=GROUPS) -> str:
    for label, keys in groups:
        if any(k in name for k in keys):
            return label
    return "elementwise / copies / other"


MODEL, BATCH, SEQ, LR, STEPS, SEED, TOP = ("gpt_small", 8, 1024, 0.01, 5,
                                           0, 20)


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def profile_steps(run_step, steps: int, groups=GROUPS):
    """Time ``steps`` calls of ``run_step(i)`` with the host clock
    around a synchronize, then trace as many more with ``torch.profiler``
    (call it warm). Returns ``(step seconds, {kernel: device us over the
    traced steps}, {group: device us})``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        run_step(i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(steps):
            run_step(i)
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
    by_group = defaultdict(float)
    for name, us in kernels.items():
        by_group[_group(name, groups)] += us
    return step_s, kernels, by_group


def report(label: str, step_s: float, kernels, by_group, steps: int,
           smi: str, top: int = TOP) -> float:
    """Print the step, the device's busy time and idle share (1 - summed
    kernel time / step wall time; one stream, so kernels do not
    overlap), the groups and the top kernels; returns busy ms/step."""
    busy_ms = sum(kernels.values()) / 1e3 / steps
    step_ms = step_s * 1e3
    print(f"[profile] {label}: step {step_ms:.2f} ms (host clock, {steps} "
          f"steps), device busy {busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f} [{smi}]")
    for name, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / steps
        print(f"[profile] group {name}: {ms:.2f} ms/step, "
              f"{ms / step_ms:.3f} of the step")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile] kernel {us / 1e3 / steps:8.3f} ms/step  "
              f"{name[:110]}")
    return busy_ms


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    dtype_name = p.parse_args(argv).dtype
    dtype = getattr(torch, dtype_name)
    device = resolve_device("cuda")
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False  # train_lm's f32
    model = get_model(MODEL, dtype=dtype)
    state = create_lm_train_state(model, init_params(model, SEED, device))
    step = make_lm_train_step(model, sgd(LR))
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(rng.integers(
        0, model.vocab_size, (BATCH, SEQ))).to(device) for _ in range(STEPS)]

    for b in batches[:2]:  # warm-up: kernel builds, cuBLAS heuristics
        step(state, b)
    step_s, kernels, groups = profile_steps(
        lambda i: step(state, batches[i]), STEPS)
    print(smi)
    label = f"{MODEL} {dtype_name} B={BATCH} S={SEQ}"
    print(f"[profile] {label}: {BATCH * SEQ / step_s:.1f} tokens/s")
    busy_ms = report(label, step_s, kernels, groups, STEPS, smi)
    return {"step_ms": step_s * 1e3, "busy_ms": busy_ms,
            "groups_ms": {k: v / 1e3 / STEPS for k, v in groups.items()}}


if __name__ == "__main__":
    main()
