#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints its lines; any failure raises and exits non-zero,
nothing is caught):

1. device  — CUDA present; the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them.
2. build   — every kernel of ``ops/csrc`` compiled from the checkout,
   one ``nvcc`` per source started together; build seconds.
3. kernel  — the decode-attention kernel against its plain PyTorch
   version at gpt_small decode shapes (8 slots, 12 heads, Dh 64), KV
   windows 16/64/256/1024 with ragged positions including 0, W-1 and
   one beyond the window, in f32 and bf16. Device times per call (CUDA
   graph of 20 calls replayed 100 times between CUDA events, median) of
   the kernel, the plain version and the library yardstick
   ``F.scaled_dot_product_attention`` (timed here only; the port never
   calls it), beside the HBM-bytes bound; and the kernel's eager
   per-call time (median of 100 single calls, host launch cost
   included).
4. serve   — the port's ``serve_lm.main`` (its normal entry) on
   full-width gpt_small, random weights from a seed, bf16, 8 slots, 16
   synthetic requests, 32 new tokens each, decode horizon 4. Every
   request must complete and the kernel must have launched exactly
   ``num_layers`` times per decode step; tokens/s and TTFT p50/p99 from
   the run's metrics.
5. exact   — gpt_small in f32 (TF32 off for matmuls and cuDNN): 4
   requests through the engine are token-exact with the port's
   ``generate``.

The line before the last is ``{"kernels": [...]}`` (one entry per
ported kernel: launches on the main path, error against the plain
version, and the times at the main path's largest decode window); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# peak HBM bytes/s by card name (NVIDIA data sheets, SXM parts unless
# named); the roofline bound's denominator
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 PCIe", 2.0e12),
                   ("H100 NVL", 3.9e12), ("H100", 3.35e12))
# f32 outside the tensor cores (the kernel's math), H100 SXM
F32_FLOPS_PER_S = 67e12

DECODE_SHAPE = dict(slots=8, heads=12, head_dim=64)  # gpt_small decode
WINDOWS = (16, 64, 256, 1024)
TOL = {"float32": 1e-4, "bfloat16": 1e-4}
REPS = 100
GRAPH_CALLS = 20


def _print(*parts):
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def _hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM peak on record for card {name!r}")


def _eager_ms(fn, torch, reps=REPS, warmup=10):
    """Median over ``reps`` single calls timed with CUDA events: the
    device time of one call as the eager caller gets it, host launch
    cost included (the card idles while the host prepares the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, torch, calls=GRAPH_CALLS, reps=REPS):
    """Device time of one call: ``calls`` calls captured into a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, the
    median replay divided by ``calls`` — no host work inside the timed
    window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _decode_inputs(torch, window, dtype, seed):
    """q/k/v/positions at gpt_small decode shapes; positions hold 0,
    W-1, one beyond the window and random columns."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, d = (DECODE_SHAPE[k] for k in ("slots", "heads", "head_dim"))
    q = torch.randn(n, 1, h, d, generator=gen, device="cuda").to(dtype)
    # k/v as the engine passes them: a window view of an s_max cache
    s_max = max(WINDOWS)
    k = torch.randn(n, s_max, h, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(n, s_max, h, d, generator=gen, device="cuda").to(dtype)
    pos = torch.randint(0, window, (n,), generator=gen, device="cuda")
    pos[0], pos[1], pos[2] = 0, window - 1, window + 5
    return q, k[:, :window], v[:, :window], pos.to(torch.int32)


def _bound(q, k, positions, rate):
    """Least time for the work these inputs need: each row reads
    min(pos, W-1)+1 key and value columns once, plus q, positions and
    the f32 output; the f32 math is 4 flops per K/V element read."""
    n, _, h, d = q.shape
    cols = int((positions.clamp(max=k.shape[1] - 1) + 1).sum())
    elt = k.element_size()
    nbytes = (2 * cols * h * d * elt + q.numel() * elt + n * 4
              + q.numel() * 4)
    flops = 2 * cols * h * d * 2
    t_bytes, t_ops = nbytes / rate, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_decode(torch, F, decode_attention, torch_decode_attention, q, k,
                 v, pos, rate):
    """Device times of the kernel, the plain version and the library
    call, the kernel's eager per-call time, and the bound, for one
    input. Launches made here are not counted."""
    scale = q.shape[-1] ** -0.5
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    launches = decode_attention.launches

    def kernel():
        decode_attention(q, k, v, pos, impl="cuda")

    ms = _device_ms(kernel, torch)
    eager_ms = _eager_ms(kernel, torch)
    decode_attention.launches = launches
    plain_ms = _device_ms(lambda: torch_decode_attention(q, k, v, pos),
                          torch)
    library_ms = _device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               scale=scale), torch)
    bound_ms, bound_by = _bound(q, k, pos, rate)
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def main() -> int:
    import numpy as np
    import torch

    # -- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
    from pytorch_multiprocessing_distributed_tpu_torch.inference import (
        generate)
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.ops import _build
    from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
        import decode_attention, torch_decode_attention
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = _hbm_rate(name)
    _print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
           f"python {sys.version.split()[0]}; card {name}; "
           f"{torch.cuda.device_count()} device(s)")
    _print(smi)

    # -- phase 2: build
    t0 = time.perf_counter()
    reports = _build.build_all()
    _print(f"[build] {len(reports)} source(s) in "
           f"{time.perf_counter() - t0:.2f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _print(f"[build] {src}: {line.strip()}")

    # -- phase 3: kernel against its plain version
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        for w in WINDOWS:
            q, k, v, pos = _decode_inputs(torch, w, dtype, seed=w)
            got = decode_attention(q, k, v, pos, impl="cuda")
            torch.cuda.synchronize()
            ref = torch_decode_attention(q, k, v, pos)
            err = float((got - ref).abs().max())
            if not err <= TOL[tname]:
                raise AssertionError(
                    f"decode_attention {tname} W={w}: max|err| {err} > "
                    f"{TOL[tname]}")
            worst = max(worst, err)
            t = _time_decode(torch, F, decode_attention,
                             torch_decode_attention, q, k, v, pos, rate)
            _print(f"[kernel] decode_attention {tname} N=8 H=12 Dh=64 "
                   f"W={w} positions={pos.tolist()} max_abs_err={err:.3e} "
                   f"(tol {TOL[tname]}) ms={t['ms']:.5f} "
                   f"eager_ms={t['eager_ms']:.5f} "
                   f"plain_ms={t['plain_ms']:.5f} "
                   f"library_ms={t['library_ms']:.5f} "
                   f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                   f"[{smi}]")

    # -- phase 4: serve through the port's CLI entry
    decode_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        metrics_path = os.path.join(tmp, "metrics.json")
        t0 = time.perf_counter()
        snap = serve_lm.main([
            "--model", "gpt_small", "--random_init", "--dtype", "bfloat16",
            "--max_slots", "8", "--synthetic", "16", "--max_new_tokens",
            "32", "--decode_horizon", "4", "--seed", "0", "--quiet",
            "--metrics_out", metrics_path])
        wall = time.perf_counter() - t0
    launches = decode_attention.launches
    if snap["requests_completed"] != 16:
        raise AssertionError(f"served {snap['requests_completed']}/16")
    steps = round(snap["decode_horizon_avg"] * snap["decode_dispatches"])
    if steps < 1 or launches != 12 * steps:
        raise AssertionError(
            f"decode_attention launched {launches} times over {steps} "
            "decode steps; expected 12 (layers) per step")
    _print(f"[serve] gpt_small bf16 16 requests x 32 tokens, 8 slots, "
           f"horizon 4: wall {wall:.2f} s, decode steps {steps}, kernel "
           f"launches {launches} (12 per step), decode tokens/s "
           f"{snap['decode_tokens_per_sec']:.1f}, TTFT p50 "
           f"{snap['ttft_p50_s'] * 1e3:.1f} ms p99 "
           f"{snap['ttft_p99_s'] * 1e3:.1f} ms, windows "
           f"{snap['decode_windows']} [{smi}]")

    # -- phase 5: engine == generate on the card, f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("gpt_small", dtype=torch.float32)
    model.load_state_dict(init_params(model, 1, "cuda"), assign=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.vocab_size, (n,)).tolist()
               for n in (5, 11, 17, 23)]
    engine = ServingEngine(model, max_slots=4, s_max=64, decode_horizon=4)
    served = engine.serve([(p, 12) for p in prompts])
    for request, prompt in zip(served, prompts):
        ref = generate(model, torch.tensor([prompt], device="cuda"),
                       max_new_tokens=12)[0, -12:].tolist()
        if request.tokens != ref:
            raise AssertionError(
                f"engine {request.tokens} != generate {ref} (prompt len "
                f"{len(prompt)})")
    _print("[exact] gpt_small f32: 4 requests through the engine are "
           "token-exact with generate")

    # the kernels line: the kernel at the main path's largest window
    w_main = max(snap["decode_windows"])
    q, k, v, pos = _decode_inputs(torch, w_main, torch.bfloat16, seed=1)
    err = float((decode_attention(q, k, v, pos, impl="cuda")
                 - torch_decode_attention(q, k, v, pos)).abs().max())
    t = _time_decode(torch, F, decode_attention, torch_decode_attention,
                     q, k, v, pos, rate)
    _print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/decode_attention.cu",
        "replaces": "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
                    "decode_attention.py:71",
        "launches": launches, "max_abs_err": max(worst, err),
        "ms": t["ms"], "kernel_ms": t["ms"], "eager_ms": t["eager_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"bf16 N=8 H=12 Dh=64 W={w_main}"}]}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
