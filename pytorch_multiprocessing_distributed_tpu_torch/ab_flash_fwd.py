"""A/B of the bf16 flash forward's CTA shape, on one card.

    python -m pytorch_multiprocessing_distributed_tpu_torch.ab_flash_fwd

Builds variants of ``ops/csrc/flash_attention.cu`` that differ only in
the forward's ``FwdSmem`` constants (consumer warpgroups a CTA, ring
stages, CTAs an SM), one ``nvcc`` each, all started together, into
``_build/ab/``. Each variant's forward is checked against the plain
version at ragged and straddling lengths (output within 2e-2, lse within
1e-4, as ``chip_smoke.py`` holds it), then all are timed in one process,
in turns (a, b, ..., b, a), at gpt_small's training shape and a few
others, beside SDPA's forward. Device time per call: a CUDA graph of 10
calls replayed between CUDA events, the median replay. Prints the
card's name and power limit and one line per variant and shape. Needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import importlib
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

from .ops import _build
from .profile_train_lm import card

# the module (the package's ``flash_attention`` name is the function)
fa = importlib.import_module(__package__ + ".ops.flash_attention")

# (label, consumer warpgroups, ring stages, CTAs an SM at Dh 32 and 64);
# the first is the committed shape
VARIANTS = (("2 warpgroups, 128 rows", 2, 3, 2),
            ("1 warpgroup, 64 rows, 3 CTAs an SM", 1, 3, 3),
            ("1 warpgroup, 2 stages, 4 CTAs an SM", 1, 2, 4),
            ("3 warpgroups, 192 rows", 3, 3, 1),
            ("2 warpgroups, 2 stages", 2, 2, 2),
            ("2 warpgroups, 4 stages", 2, 4, 2))
CHECKS = ((2, 197, 300, 12, 64, False), (2, 129, 129, 12, 64, True),
          (2, 193, 193, 3, 64, True), (2, 97, 33, 3, 64, False),
          (2, 512, 512, 4, 32, True), (2, 512, 512, 4, 128, True))
SHAPES = ((8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
          (4, 2048, 12, 64, True), (8, 1024, 6, 128, True),
          (8, 1024, 24, 32, True))


def variant_source(wgs: int, stages: int, min_blocks: int) -> str:
    """The committed source with the forward's constants replaced."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    start = src.index("struct FwdSmem {")
    end = src.index("};", start)
    body, n = re.subn(r"kWgs = \d+;", f"kWgs = {wgs};", src[start:end])
    body, m = re.subn(r"kMinBlocks = D == 128 \? 1 : \d+;",
                      f"kMinBlocks = D == 128 ? 1 : {min_blocks};", body)
    body, k = re.subn(r"kStages = \d+;", f"kStages = {stages};", body)
    if (n, m, k) != (1, 1, 1):
        raise RuntimeError("FwdSmem no longer holds the constants this "
                           "A/B replaces")
    return src[:start] + body + src[end:]


def build() -> list:
    """One library a variant, the builds run in parallel."""
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (_, wgs, stages, blocks) in enumerate(VARIANTS):
        src = out / f"flash_fwd_{i}.cu"
        src.write_text(variant_source(wgs, stages, blocks))
        lib = out / f"libflash_fwd_{i}.so"
        procs.append((lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"nvcc failed on {lib}:\n{log}")
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def use(lib) -> None:
    """Route the forward wrapper to ``lib`` (an entry's signature as
    ``flash_attention._entry`` sets it)."""
    def entry(name, n_ptrs):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn
    fa._entry = entry


def inputs(b, sq, skv, h, d, seed=0):
    """bf16 q/k/v as the model hands them over: views of one fused QKV
    projection (row stride 3 H Dh)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fq = torch.randn(b, sq, 3 * h * d, generator=gen, device="cuda")
    fk = torch.randn(b, skv, 3 * h * d, generator=gen, device="cuda")
    q = fq.bfloat16()[..., :h * d].view(b, sq, h, d)
    k = fk.bfloat16()[..., h * d:2 * h * d].view(b, skv, h, d)
    v = fk.bfloat16()[..., 2 * h * d:].view(b, skv, h, d)
    return q, k, v


def check(label: str) -> None:
    for seed, (b, sq, skv, h, d, causal) in enumerate(CHECKS):
        q, k, v = inputs(b, sq, skv, h, d, seed)
        out, lse = fa.flash_fwd(q, k, v, causal=causal, impl="cuda")
        ref, ref_lse = fa.torch_flash_fwd(q, k, v, scale=d ** -0.5,
                                          causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"{label}: out")
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4,
                                   msg=f"{label}: lse")


def device_ms(fn, calls=10, reps=30) -> float:
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
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("ab_flash_fwd needs a CUDA card")
    entry = fa._entry
    try:
        return run(card(), build())
    finally:
        fa._entry = entry  # the wrapper's own library again


def run(smi: str, libs: list) -> dict:
    for (label, *_), lib in zip(VARIANTS, libs):
        use(lib)
        check(label)
    print(f"[ab] {len(libs)} variants agree with the plain forward [{smi}]")
    result = {}
    for b, s, h, d, causal in SHAPES:
        q, k, v = inputs(b, s, s, h, d)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        order = list(range(len(libs)))
        times = {i: [] for i in order}
        for i in order + order[::-1]:
            use(libs[i])
            times[i].append(device_ms(lambda: fa.flash_fwd(
                q, k, v, causal=causal, impl="cuda")))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        shape = (f"bf16 B={b} S={s} H={h} Dh={d} "
                 f"{'causal' if causal else 'non-causal'}")
        print(f"[ab] {shape}: SDPA forward {sdpa:.5f} ms [{smi}]")
        for i, (label, *_) in enumerate(VARIANTS):
            ms = statistics.mean(times[i])
            print(f"[ab]   {label}: {times[i][0]:.5f} / {times[i][1]:.5f} "
                  f"ms, {flops / ms / 1e9:.1f} TFLOP/s, / SDPA "
                  f"{ms / sdpa:.3f}")
            result[(shape, label)] = ms
    return result


if __name__ == "__main__":
    main()
