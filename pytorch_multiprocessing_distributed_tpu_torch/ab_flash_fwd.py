"""A/B of the flash forward's CTA shape, bf16 and f32, on one card.

    python -m pytorch_multiprocessing_distributed_tpu_torch.ab_flash_fwd
    python -m pytorch_multiprocessing_distributed_tpu_torch.ab_flash_fwd \
        --dtype float32

Builds variants of ``ops/csrc/flash_attention.cu`` that differ only in
one forward's shape constants (bf16: ``FwdSmem``'s consumer warpgroups a
CTA, ring stages and CTAs an SM; f32: ``FwdTf32Shape``'s ring stages),
one ``nvcc`` each, all started together, into
``_build/ab/``. Each variant's forward is checked against the plain
version at ragged and straddling lengths (bf16: output within 2e-2, f32:
within 1e-4; lse within 1e-4, as ``chip_smoke.py`` holds them), then all
are timed in one process, in turns (a, b, ..., b, a), at gpt_small's
training shape and a few others, beside SDPA's forward in the same
dtype. Device time per call: a CUDA graph of 10 calls replayed between
CUDA events, the median replay. Prints the card's name and power limit
and one line per variant and shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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

# per dtype: the struct whose constants a variant replaces, and (label,
# {constant: C++ expression in D}) per variant; the first is the
# committed shape
VARIANTS = {
    "bfloat16": ("FwdSmem", (
        ("2 warpgroups, 128 rows",
         dict(kWgs="2", kStages="3", kMinBlocks="D == 128 ? 1 : 2")),
        ("1 warpgroup, 64 rows, 3 CTAs an SM",
         dict(kWgs="1", kStages="3", kMinBlocks="D == 128 ? 1 : 3")),
        ("1 warpgroup, 2 stages, 4 CTAs an SM",
         dict(kWgs="1", kStages="2", kMinBlocks="D == 128 ? 1 : 4")),
        ("3 warpgroups, 192 rows",
         dict(kWgs="3", kStages="3", kMinBlocks="D == 128 ? 1 : 1")),
        ("2 warpgroups, 2 stages",
         dict(kWgs="2", kStages="2", kMinBlocks="D == 128 ? 1 : 2")),
        ("2 warpgroups, 4 stages",
         dict(kWgs="2", kStages="4", kMinBlocks="D == 128 ? 1 : 2")))),
    # a third ring stage fits beside the 128 query rows at Dh 32 and 128,
    # not at Dh 64 (there both variants build the same kernel)
    "float32": ("FwdTf32Shape", (
        ("2 stages", dict(kStages="2")),
        ("3 stages at Dh 32 and 128", dict(kStages="D == 64 ? 2 : 3")))),
}
KERNELS = {"bfloat16": "flash_fwd_wgmma_kernel",
           "float32": "flash_fwd_tf32x3_kernel"}
CHECKS = ((2, 197, 300, 12, 64, False), (2, 129, 129, 12, 64, True),
          (2, 193, 193, 3, 64, True), (2, 97, 33, 3, 64, False),
          (2, 512, 512, 4, 32, True), (2, 512, 512, 4, 128, True))
SHAPES = {"bfloat16": ((8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
                       (4, 2048, 12, 64, True), (8, 1024, 6, 128, True),
                       (8, 1024, 24, 32, True)),
          "float32": ((8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
                      (8, 1024, 24, 32, True), (8, 1024, 6, 128, True))}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # the output's; lse 1e-4


def variant_source(struct: str, constants: dict) -> str:
    """The committed source with one struct's constants replaced."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    start = src.index(f"struct {struct} {{")
    end = src.index("};", start)
    body = src[start:end]
    for name, value in constants.items():
        body, n = re.subn(rf"({name} = )[^;]+;", rf"\g<1>{value};", body)
        if n != 1:
            raise RuntimeError(f"{struct} no longer holds the constant "
                               f"{name} this A/B replaces")
    return src[:start] + body + src[end:]


def build(dtypes) -> dict:
    """One library a variant, every build run in parallel."""
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {dtype: [] for dtype in dtypes}
    for dtype in dtypes:
        struct, variants = VARIANTS[dtype]
        for i, (_, constants) in enumerate(variants):
            src = out / f"flash_fwd_{dtype}_{i}.cu"
            src.write_text(variant_source(struct, constants))
            lib = out / f"libflash_fwd_{dtype}_{i}.so"
            procs[dtype].append((lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for dtype, started in procs.items():
        libs[dtype] = []
        for (label, _), (lib, proc) in zip(VARIANTS[dtype][1], started):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise _build.KernelBuildError(
                    f"nvcc failed on {lib}:\n{log}")
            print(f"[ab] {dtype} {label}: {registers(log, KERNELS[dtype])}")
            libs[dtype].append(ctypes.CDLL(str(lib)))
    return libs


def registers(log: str, kernel: str) -> str:
    """Registers and spill bytes of each Dh of ``kernel`` in an
    ``-Xptxas -v`` report, and whether ptxas serialised its wgmma
    (C7512)."""
    parts = []
    for entry in _build.ptxas_entries(log):
        dh = re.search(rf"{kernel}ILi(\d+)E", entry.name)
        if dh:
            parts.append(f"Dh {dh.group(1)}: {entry.registers} registers, "
                         f"spills {entry.spill_stores}/{entry.spill_loads} B"
                         + (", C7512 (wgmma serialised)"
                            if entry.serialised else ""))
    return "; ".join(parts)


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


def inputs(b, sq, skv, h, d, dtype, seed=0):
    """q/k/v as the model hands them over: views of one fused QKV
    projection (row stride 3 H Dh)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fq = torch.randn(b, sq, 3 * h * d, generator=gen, device="cuda")
    fk = torch.randn(b, skv, 3 * h * d, generator=gen, device="cuda")
    q = fq.to(dtype)[..., :h * d].view(b, sq, h, d)
    k = fk.to(dtype)[..., h * d:2 * h * d].view(b, skv, h, d)
    v = fk.to(dtype)[..., 2 * h * d:].view(b, skv, h, d)
    return q, k, v


def check(label: str, dtype) -> None:
    tol = TOL[str(dtype).split(".")[1]]
    for seed, (b, sq, skv, h, d, causal) in enumerate(CHECKS):
        q, k, v = inputs(b, sq, skv, h, d, dtype, seed)
        out, lse = fa.flash_fwd(q, k, v, causal=causal, impl="cuda")
        ref, ref_lse = fa.torch_flash_fwd(q, k, v, scale=d ** -0.5,
                                          causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=f"{label}: out")
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", nargs="+", default=["float32",
                                                       "bfloat16"],
                        choices=sorted(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_flash_fwd needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = fa._entry
    try:
        smi, libs = card(), build(args.dtype)
        return {dtype: run(smi, dtype, libs[dtype]) for dtype in args.dtype}
    finally:
        fa._entry = entry  # the wrapper's own library again


def run(smi: str, tname: str, libs: list) -> dict:
    dtype = getattr(torch, tname)
    variants = VARIANTS[tname][1]
    for (label, _), lib in zip(variants, libs):
        use(lib)
        check(label, dtype)
    print(f"[ab] {tname}: {len(libs)} variants agree with the plain "
          f"forward [{smi}]")
    result = {}
    for b, s, h, d, causal in SHAPES[tname]:
        q, k, v = inputs(b, s, s, h, d, dtype)
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
        shape = (f"{tname} B={b} S={s} H={h} Dh={d} "
                 f"{'causal' if causal else 'non-causal'}")
        print(f"[ab] {shape}: SDPA forward {sdpa:.5f} ms [{smi}]")
        for i, (label, _) in enumerate(variants):
            ms = statistics.mean(times[i])
            print(f"[ab]   {label}: {times[i][0]:.5f} / {times[i][1]:.5f} "
                  f"ms, {flops / ms / 1e9:.1f} TFLOP/s, / SDPA "
                  f"{ms / sdpa:.3f}")
            result[(shape, label)] = ms
    return result


if __name__ == "__main__":
    main()
