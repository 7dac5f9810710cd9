"""Flash-decode attention: one cached query per slot over a KV window,
dense or through a page table, over model-dtype or int8 K/V; and its
k-query twin, the speculative verify pass (``K1`` query rows per slot,
row ``i`` attending columns ``[0, position + i]``).

The serving engine's decode step: ONE query token per slot attending
over the slot's cached columns ``[0, position]`` (``[start, position]``
for a left-padded row of a ragged ``generate`` batch: ``starts``, dense
model-dtype K/V only). On the card this runs
the hand-written CUDA kernels of ``csrc/decode_attention.cu`` (the port
of the JAX package's Pallas ``_decode_kernel`` and
``_paged_decode_kernel``): the window is cut into key splits, one CTA
each (:func:`decode_split_plan`), K/V are read once through their
strides or the page table, int8 rows are dequantized in the stream, the
softmax is an online recurrence in registers, and a slot pays for its
own length, not the window's. A window of one split is one launch; a
longer one adds a second kernel that folds the splits' partials (the
workspace is allocated here). On the CPU it runs the plain versions
(:func:`torch_decode_attention`, the masked-softmax math of the JAX
package's ``xla_decode_attention``; :func:`torch_paged_decode_attention`,
its gather-then-dense ``xla_paged_decode_attention``), which are also
the kernel's references on the card.

Layouts are the JAX package's: q ``[B, 1, H, Dh]``; dense k/v ``[B, W,
H, Dh]`` (the engine passes the window view ``k_cache[:, :W]``, never a
copy); pages ``[P, H, page_size, Dh]`` with a ``[B, n_win]`` int32 table;
int8 K/V are a :class:`.kv_quant.QuantizedKV` whose scale drops the
trailing Dh axis; positions ``[B]`` int32; the output is f32 ``[B, 1, H,
Dh]`` and the caller casts back to the model dtype.

The verify entries (:func:`verify_decode_attention`,
:func:`paged_verify_decode_attention`) take q ``[B, K1, H, Dh]`` and
return f32 ``[B, K1, H, Dh]``; on the card they run the kernels of the
same source that replace the JAX package's ``_verify_kernel`` and
``_paged_verify_kernel``, on the CPU the plain versions
(:func:`torch_verify_decode_attention`, the einsum and row-staggered
masked softmax of ``xla_verify_decode_attention``;
:func:`torch_paged_verify_decode_attention`, gather then dense).

On the card a verify call cuts the window into key splits in the same
way, one set per tile of 16 query rows (:func:`verify_split_plan`).

Launch counts, one per variant (incremented where the kernel launches,
nowhere else; a call's split and merge launches count once):
``decode_attention.launches`` (dense, model dtype),
``decode_attention.int8_launches``, ``paged_decode_attention.launches``,
``paged_decode_attention.int8_launches``, and the same four names on
``verify_decode_attention`` and ``paged_verify_decode_attention``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import head_dim_tile, kernel_head_dim, pad_head_dim, resolve_impl
from ._build import load
from .kv_quant import QuantizedKV, dequantize_kv

__all__ = ["decode_attention", "paged_decode_attention",
           "verify_decode_attention", "paged_verify_decode_attention",
           "torch_decode_attention", "torch_paged_decode_attention",
           "torch_verify_decode_attention",
           "torch_paged_verify_decode_attention", "VerifyRowsError",
           "DecodeSplitPlan", "decode_split_plan", "decode_split_ranges",
           "VerifySplitPlan", "verify_split_plan", "verify_split_ranges"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the verify wrappers take up to 8 * 65535 query rows; the kernel puts
# them in tiles of 16 on its grid's z axis (at most 65535 tiles)
MAX_VERIFY_ROWS = 8 * 65535
VERIFY_TILE_ROWS = 16  # query rows of a verify CTA: one mma.sync row tile
VERIFY_KEY_TILE = 64  # keys of one shared-memory ring tile
VERIFY_SPLIT = 128  # keys a verify CTA walks (chip_smoke phase 15's A/B)
DECODE_SPLIT = 128  # keys a decode CTA walks (chip_smoke phase 12's A/B)


class VerifyRowsError(ValueError):
    """A query-row count ``K1`` the verify kernel cannot take."""


def torch_decode_attention(q: torch.Tensor, k, v, positions: torch.Tensor,
                           starts: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch reference: f32 logits, masked softmax over columns
    ``<= positions[b]`` (and ``>= starts[b]`` where given: JAX's
    ``kv_valid`` of a ragged batch), f32 PV (the JAX package's
    ``xla_decode_attention`` with the mask built from positions); f64
    inputs stay f64 throughout. int8 K/V are dequantized to q's dtype
    first. A position beyond the window attends the whole window."""
    if isinstance(k, QuantizedKV):
        k, v = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    cols = torch.arange(k.shape[1], device=k.device)
    mask = cols[None, :] <= positions.to(torch.long)[:, None]  # [B, W]
    if starts is not None:
        mask = mask & (cols[None, :] >= starts.to(torch.long)[:, None])
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(ct))


def _gather_paged_window(pages, page_table: torch.Tensor, q_dtype,
                         window: Optional[int] = None) -> torch.Tensor:
    """Gather the table's pages into the contiguous ``[B, W, H, Dh]``
    window the dense reference reads (int8 pages gather both parts and
    dequantize with the kernel's expression), trimmed to ``window``."""
    b, n_win = page_table.shape
    idx = page_table.long()
    h, ps, d = pages.shape[1], pages.shape[2], pages.shape[3]
    if isinstance(pages, QuantizedKV):
        data = pages.data[idx].permute(0, 1, 3, 2, 4).reshape(
            b, n_win * ps, h, d)
        scale = pages.scale[idx].permute(0, 1, 3, 2).reshape(
            b, n_win * ps, h)
        g = dequantize_kv(QuantizedKV(data, scale), q_dtype)
    else:
        g = pages[idx].permute(0, 1, 3, 2, 4).reshape(b, n_win * ps, h, d)
    if window is not None and window < n_win * ps:
        g = g[:, :window]
    return g


def torch_paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                                 page_table: torch.Tensor,
                                 positions: torch.Tensor,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain reference of the paged path (the JAX package's
    ``xla_paged_decode_attention``): gather the windowed pages, then the
    dense reference math, so paged and dense agree bit for bit on the
    same logical columns."""
    k_win = _gather_paged_window(k_pages, page_table, q.dtype, window)
    v_win = _gather_paged_window(v_pages, page_table, q.dtype, window)
    return torch_decode_attention(q, k_win, v_win, positions)


def torch_verify_decode_attention(q: torch.Tensor, k, v,
                                  positions: torch.Tensor) -> torch.Tensor:
    """Plain reference of the k-query verify pass (the JAX package's
    ``xla_verify_decode_attention``): f32 logits, row ``i`` of slot
    ``b`` masked to columns ``<= positions[b] + i``, softmax, f32 PV.
    int8 K/V are dequantized to q's dtype first. ``K1 = 1`` is
    :func:`torch_decode_attention` bit for bit; a row reaching past the
    window attends the whole window."""
    if isinstance(k, QuantizedKV):
        k, v = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    rows = torch.arange(q.shape[1], device=k.device)
    cols = torch.arange(k.shape[1], device=k.device)
    mask = (cols[None, None, :]
            <= positions.to(torch.long)[:, None, None]
            + rows[None, :, None])  # [B, K1, W]
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def torch_paged_verify_decode_attention(q: torch.Tensor, k_pages, v_pages,
                                        page_table: torch.Tensor,
                                        positions: torch.Tensor,
                                        window: Optional[int] = None
                                        ) -> torch.Tensor:
    """Plain reference of the paged verify pass (the JAX package's
    ``xla_paged_verify_decode_attention``): gather the windowed pages,
    then :func:`torch_verify_decode_attention`."""
    k_win = _gather_paged_window(k_pages, page_table, q.dtype, window)
    v_win = _gather_paged_window(v_pages, page_table, q.dtype, window)
    return torch_verify_decode_attention(q, k_win, v_win, positions)


# ---- the CUDA kernels --------------------------------------------------

class DecodeSplitPlan(NamedTuple):
    """How the decode kernel cuts one call: each (slot, head) gets
    ``n_splits`` CTAs of ``split`` keys over the window. ``grid`` is the
    split kernel's launch grid and ``partials`` the shape of the f32
    workspace its CTAs write: one ``(acc[Dh], m, l)`` row per (slot x
    head, split), padded to ``Dh + 4`` floats (16-byte rows); None where
    the window fits one split (one launch writes the output, no
    workspace, no merge)."""
    split: int
    n_splits: int
    grid: Tuple[int, int]
    partials: Optional[Tuple[int, int, int]]


def _checked_split(split: int) -> int:
    if split < VERIFY_KEY_TILE or split % VERIFY_KEY_TILE:
        raise ValueError(
            f"split must be a positive multiple of {VERIFY_KEY_TILE}, got "
            f"{split}")
    return split


def decode_split_plan(batch: int, heads: int, window: int, head_dim: int,
                      split: Optional[int] = None) -> DecodeSplitPlan:
    """The decode kernel's split plan for ``batch`` slots x ``heads``
    heads over a ``window`` of columns (``split`` defaults to
    :data:`DECODE_SPLIT`). It takes no layout and no page size: dense
    and paged windows are cut alike, so they walk the same keys in the
    same order and agree bit for bit."""
    split = _checked_split(DECODE_SPLIT if split is None else split)
    n_splits = -(-window // split)
    partials = ((batch * heads, n_splits, head_dim + 4) if n_splits > 1
                else None)
    return DecodeSplitPlan(split, n_splits, (batch * heads, n_splits),
                           partials)


def decode_split_ranges(plan: DecodeSplitPlan, position: int, window: int,
                        start: int = 0) -> List[Tuple[int, int]]:
    """The key ranges ``[lo, hi)`` that the live CTAs of a slot at
    ``position`` with first valid column ``start`` walk, by the rule the
    kernel applies on the card: the slot reaches column ``min(position,
    window - 1)``; split s is live iff it holds a column of ``[start,
    reach]``, and walks that part of it. A split past the reach, or
    ending at or before the start, returns before it reads anything, and
    the merge folds the live ones in split order."""
    reach = min(position, window - 1)
    out = []
    for s in range(plan.n_splits):
        lo = max(s * plan.split, start)
        hi = min((s + 1) * plan.split, reach + 1)
        if lo < hi:
            out.append((lo, hi))
    return out


class VerifySplitPlan(NamedTuple):
    """How the verify kernel cuts one call: each (slot, head) gets
    ``n_splits`` CTAs of ``split`` keys over the window for each of its
    ``row_tiles`` tiles of 16 query rows. ``grid`` is the split kernel's
    launch grid and ``partials`` the shape of the f32 workspace its CTAs
    write: one ``(acc[Dh], m, l)`` row per (slot x head, row tile, split,
    tile row), padded to ``Dh + 4`` floats (16-byte rows)."""
    split: int
    n_splits: int
    row_tiles: int
    grid: Tuple[int, int, int]
    partials: Tuple[int, int, int, int, int]


def verify_split_plan(batch: int, heads: int, window: int, k1: int,
                      head_dim: int,
                      split: Optional[int] = None) -> VerifySplitPlan:
    """The verify kernel's split plan for ``batch`` slots x ``heads``
    heads, a ``window`` of columns and ``k1`` query rows (``split``
    defaults to :data:`VERIFY_SPLIT`). It takes no layout and no page
    size: dense and paged windows are cut alike, so they walk the same
    keys in the same order and agree bit for bit."""
    split = _checked_split(VERIFY_SPLIT if split is None else split)
    n_splits = -(-window // split)
    row_tiles = -(-k1 // VERIFY_TILE_ROWS)
    return VerifySplitPlan(
        split, n_splits, row_tiles, (batch * heads, n_splits, row_tiles),
        (batch * heads, row_tiles, n_splits, VERIFY_TILE_ROWS,
         head_dim + 4))


def verify_split_ranges(plan: VerifySplitPlan, position: int, window: int,
                        k1: int) -> List[List[Tuple[int, int]]]:
    """For each row tile, the key ranges ``[start, end)`` that the live
    CTAs of a slot at ``position`` walk, by the rule the kernel applies on
    the card: tile t reaches column ``min(position + r_last, window - 1)``
    (r_last its last real row); split s is live iff its first key
    ``s * split`` lies within that reach, and walks up to the reach. A
    split past the reach returns before it reads anything, and the merge
    folds the live ones in split order."""
    ranges = []
    for t in range(plan.row_tiles):
        r_last = min((t + 1) * VERIFY_TILE_ROWS, k1) - 1
        reach = min(position + r_last, window - 1)
        ranges.append([(s * plan.split, min((s + 1) * plan.split, reach + 1))
                       for s in range(plan.n_splits)
                       if s * plan.split <= reach])
    return ranges


class _Args(ctypes.Structure):
    """``PmdtDecodeArgs`` of ``csrc/decode_attention.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "k_scale", "v_scale", "positions", "table", "out")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "W", "D", "dtype", "quant", "page_size",
            "table_stride")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_sh", "k_s0", "k_s1", "k_s2", "v_s0", "v_s1", "v_s2",
            "ks_s0", "ks_s1", "ks_s2", "vs_s0", "vs_s1", "vs_s2")]
        + [("scale", ctypes.c_float), ("starts", ctypes.c_void_p)])


class _DecodeArgs(ctypes.Structure):
    """``PmdtDecodeSplitArgs`` of ``csrc/decode_attention.cu``: the
    decode block, and the split plan's workspace (null for one split),
    split and split count."""
    _fields_ = [("d", _Args), ("partials", ctypes.c_void_p),
                ("split", ctypes.c_int), ("n_splits", ctypes.c_int)]


class _VerifyArgs(ctypes.Structure):
    """``PmdtVerifyArgs`` of ``csrc/decode_attention.cu``: the decode
    block (its ``out`` is ``[B, K1, H, Dh]``), the row count, q's row
    stride, and the split plan's workspace, split and split count."""
    _fields_ = [("d", _Args), ("k1", ctypes.c_int),
                ("q_sq", ctypes.c_longlong), ("partials", ctypes.c_void_p),
                ("split", ctypes.c_int), ("n_splits", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _kernel(verify: bool = False):
    """The C entry point (``pmdt_decode_attention``, or
    ``pmdt_verify_attention``) with its ctypes signature (built at first
    use)."""
    lib = load("decode_attention")
    fn = lib.pmdt_verify_attention if verify else lib.pmdt_decode_attention
    fn.argtypes = [ctypes.POINTER(_VerifyArgs if verify else _DecodeArgs),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_q(q, positions, verify=False):
    if q.dim() != 4:
        raise ValueError(f"q must be 4-d, got {tuple(q.shape)}")
    b, k1, h, d = q.shape
    if not verify and k1 != 1:
        raise ValueError(f"q must be [B, 1, H, Dh], got {tuple(q.shape)}")
    if verify and not 1 <= k1 <= MAX_VERIFY_ROWS:
        raise VerifyRowsError(
            f"the verify kernel takes 1 <= K1 <= {MAX_VERIFY_ROWS} query "
            f"rows, got q {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(
            f"the kernel takes f32 or bf16 q, got {q.dtype}")
    head_dim_tile(d)
    if positions.shape != (b,) or positions.dtype != torch.int32:
        raise ValueError(
            f"positions must be int32 [{b}], got {positions.dtype} "
            f"{tuple(positions.shape)}")
    if not positions.is_contiguous():
        raise ValueError("positions must be contiguous")


def _check_kv(q, k, v, name="k"):
    """k/v (dense ``[B, W, H, Dh]`` or pages ``[P, H, ps, Dh]``, model
    dtype or int8 pairs): one dtype, unit Dh stride."""
    quant = isinstance(k, QuantizedKV)
    if isinstance(v, QuantizedKV) != quant:
        raise ValueError("k and v must both be quantized or both not")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if len(k.shape) != 4 or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"{name} must be 4-d with Dh={q.shape[3]}, got "
            f"{tuple(k.shape)}")
    data = [("k", k.data if quant else k), ("v", v.data if quant else v)]
    if quant:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("quantized K/V must hold int8 data")
        for s_name, s in (("k scale", k.scale), ("v scale", v.scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3]:
                raise ValueError(
                    f"{s_name} must be f32 {tuple(k.shape[:3])}, got "
                    f"{s.dtype} {tuple(s.shape)}")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    for n, t in data + [("q", q)]:
        if t.stride(3) != 1:
            raise ValueError(f"{n} needs a unit head_dim stride")


def _check_aligned(k, v):
    """K/V rows (as the kernel reads them) start on 16 bytes: the kernel
    stages them with 16-byte copies."""
    quant = isinstance(k, QuantizedKV)
    for n, t in (("k", k.data if quant else k), ("v", v.data if quant else v)):
        vec = 16 // t.element_size()  # 16-byte loads: lanes per thread
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(
                f"{n} rows must be 16-byte aligned (strides "
                f"{t.stride()}, element size {t.element_size()})")


def _pad_kv(t, width):
    """K or V (or their int8 pair) zero-padded to ``width`` columns."""
    if isinstance(t, QuantizedKV):
        return QuantizedKV(pad_head_dim(t.data, width), t.scale)
    return pad_head_dim(t, width)


def _same_device(*tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _check(q, k, v, positions, verify=False):
    """Dense variant checks (``k``/``v`` ``[B, W, H, Dh]``)."""
    _check_q(q, positions, verify)
    b, _, h, d = q.shape
    _check_kv(q, k, v)
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k must be [B, W, H, Dh] = [{b}, W, {h}, {d}], got "
            f"{tuple(k.shape)}")
    if k.shape[1] < 1:
        raise ValueError("empty KV window")
    parts = [q, positions] + ([k.data, k.scale, v.data, v.scale]
                              if isinstance(k, QuantizedKV) else [k, v])
    _same_device(*parts)


def _check_paged(q, k_pages, v_pages, page_table, positions, window,
                 verify=False):
    _check_q(q, positions, verify)
    b, _, h, d = q.shape
    _check_kv(q, k_pages, v_pages, name="pages")
    if k_pages.shape[1] != h:
        raise ValueError(
            f"pages must be [P, H, page_size, Dh] with H={h}, got "
            f"{tuple(k_pages.shape)}")
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.dtype != torch.int32
            or page_table.stride(1) != 1 or page_table.shape[1] < 1):
        raise ValueError(
            f"page_table must be int32 [{b}, n_win] with a unit last "
            f"stride, got {page_table.dtype} {tuple(page_table.shape)}")
    span = page_table.shape[1] * k_pages.shape[2]
    if window is not None and not 1 <= window <= span:
        raise ValueError(
            f"window {window} must be in [1, n_win * page_size = {span}]")
    parts = [q, positions, page_table] + (
        [k_pages.data, k_pages.scale, v_pages.data, v_pages.scale]
        if isinstance(k_pages, QuantizedKV) else [k_pages, v_pages])
    _same_device(*parts)


def _launch(q, k, v, positions, *, window, table=None, page_size=0,
            verify=False, starts=None):
    """Fill the argument block and launch the decode kernels (or, with
    ``verify``, the k-query verify kernels) with the split plan's
    workspace; returns the f32 output. A head_dim whose K/V rows are
    not whole 16-byte pieces goes in zero-padded to the kernels' tile
    (:func:`..ops.kernel_head_dim`), and the output is sliced back."""
    head_dim = q.shape[-1]
    quant = isinstance(k, QuantizedKV)
    width = kernel_head_dim(head_dim, 1 if quant else q.element_size())
    q, k, v = pad_head_dim(q, width), _pad_kv(k, width), _pad_kv(v, width)
    _check_aligned(k, v)
    b, k1, h, d = q.shape
    tile = head_dim_tile(d)
    kd, vd = (k.data, v.data) if quant else (k, v)
    out = torch.empty((b, k1, h, d), dtype=torch.float32, device=q.device)
    a = _Args(q=q.data_ptr(), k=kd.data_ptr(), v=vd.data_ptr(),
              positions=positions.data_ptr(), out=out.data_ptr(),
              B=b, H=h, W=window, D=d, dtype=_DTYPES[q.dtype],
              quant=int(quant), q_sb=q.stride(0), q_sh=q.stride(2),
              scale=head_dim ** -0.5)
    # storage row (base, col, head): dense [B, W, H, Dh] is (0, 1, 2);
    # pages [P, H, ps, Dh] are (0, 2, 1)
    dims = (0, 1, 2) if table is None else (0, 2, 1)
    for prefix, t in (("k", kd), ("v", vd)) + (
            (("ks", k.scale), ("vs", v.scale)) if quant else ()):
        for i, dim in enumerate(dims):
            setattr(a, f"{prefix}_s{i}", t.stride(dim))
    if quant:
        a.k_scale, a.v_scale = k.scale.data_ptr(), v.scale.data_ptr()
    if table is not None:
        a.table, a.page_size = table.data_ptr(), page_size
        a.table_stride = table.stride(0)
    if starts is not None:
        a.starts = starts.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if verify:
        plan = verify_split_plan(b, h, window, k1, tile)
        partials = torch.empty(plan.partials, dtype=torch.float32,
                               device=q.device)
        err = _kernel(True)(ctypes.byref(_VerifyArgs(
            d=a, k1=k1, q_sq=q.stride(1), partials=partials.data_ptr(),
            split=plan.split, n_splits=plan.n_splits)), stream)
    else:
        plan = decode_split_plan(b, h, window, tile)
        partials = (None if plan.partials is None else torch.empty(
            plan.partials, dtype=torch.float32, device=q.device))
        err = _kernel()(ctypes.byref(_DecodeArgs(
            d=a, partials=None if partials is None else partials.data_ptr(),
            split=plan.split, n_splits=plan.n_splits)), stream)
    if err != 0:
        raise RuntimeError(
            f"{'verify' if verify else 'decode'}_attention kernel launch "
            f"failed: cudaError {err} (B={b} K1={k1} H={h} W={window} "
            f"Dh={head_dim} {q.dtype} int8={quant} "
            f"paged={table is not None} starts={starts is not None})")
    return out if d == head_dim else out[..., :head_dim].contiguous()


def _check_starts(q, k, positions, starts):
    """``starts`` beside dense model-dtype K/V: int32 ``[B]``, contiguous,
    on the inputs' device."""
    if isinstance(k, QuantizedKV):
        raise ValueError("starts applies to model-dtype K/V, not int8")
    b = q.shape[0]
    if starts.shape != (b,) or starts.dtype != torch.int32:
        raise ValueError(
            f"starts must be int32 [{b}], got {starts.dtype} "
            f"{tuple(starts.shape)}")
    if not starts.is_contiguous():
        raise ValueError("starts must be contiguous")
    _same_device(positions, starts)


def decode_attention(q: torch.Tensor, k, v, positions: torch.Tensor, *,
                     starts: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Single-step cached attention over a dense KV window.

    Args:
      q: ``[B, 1, H, Dh]`` — one pending query token per slot.
      k, v: ``[B, W, H, Dh]`` KV window (any strides with a unit ``Dh``
        stride — the engine's ``cache[:, :W]`` view is read in place),
        or a :class:`.kv_quant.QuantizedKV` pair (int8 data plus the
        ``[B, W, H]`` f32 scales, dequantized in the stream).
      positions: ``[B]`` int32 — slot ``b`` attends columns
        ``[0, positions[b]]``; a position ``>= W`` attends the whole
        window.
      starts: optional ``[B]`` int32, model-dtype K/V only — slot ``b``
        attends ``[starts[b], positions[b]]``: a ragged batch's row
        left-padded by ``starts[b]`` columns (JAX's ``kv_valid``). On
        the card the columns before it are never read.
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see :mod:`..ops`).

    Returns ``[B, 1, H, Dh]`` f32 attention output.
    """
    if starts is not None:
        _check_starts(q, k, positions, starts)
    if resolve_impl(impl, q) == "torch":
        return torch_decode_attention(q, k, v, positions, starts)
    _check(q, k, v, positions)
    out = _launch(q, k, v, positions, window=k.shape[1], starts=starts)
    if isinstance(k, QuantizedKV):
        decode_attention.int8_launches += 1
    else:
        decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                           page_table: torch.Tensor,
                           positions: torch.Tensor, *,
                           window: Optional[int] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Single-step cached attention through a page table.

    Args:
      q: ``[B, 1, H, Dh]``.
      k_pages, v_pages: ``[P, H, page_size, Dh]`` page storage of ONE
        layer (heads before the column offset, so one page of one head
        is a contiguous ``[page_size, Dh]`` tile), or a
        :class:`.kv_quant.QuantizedKV` pair with ``[P, H, page_size]``
        f32 scales.
      page_table: ``[B, n_win]`` int32 — slot ``b``'s column block
        ``kb`` lives in page ``page_table[b, kb]``. The engine passes
        the first ``ceil(window / page_size)`` entries of its table (a
        view); unallocated entries point at the scratch page 0, which
        the position bound keeps out of the read.
      positions: ``[B]`` int32 — slot ``b`` attends columns
        ``[0, positions[b]]``, clamped to the window.
      window: logical column bound (None = ``n_win * page_size``).
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"``.

    Returns ``[B, 1, H, Dh]`` f32 attention output.
    """
    if resolve_impl(impl, q) == "torch":
        return torch_paged_decode_attention(q, k_pages, v_pages,
                                            page_table, positions, window)
    _check_paged(q, k_pages, v_pages, page_table, positions, window)
    ps = k_pages.shape[2]
    out = _launch(q, k_pages, v_pages, positions,
                  window=window or page_table.shape[1] * ps,
                  table=page_table, page_size=ps)
    if isinstance(k_pages, QuantizedKV):
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


def verify_decode_attention(q: torch.Tensor, k, v,
                            positions: torch.Tensor, *,
                            impl: str = "auto") -> torch.Tensor:
    """Speculative-verify attention over a dense KV window: ``K1``
    query rows per slot (the pending token, then the drafts).

    Args:
      q: ``[B, K1, H, Dh]`` (any strides with a unit ``Dh`` stride) —
        row ``i`` is the query at column ``positions[b] + i``.
      k, v: ``[B, W, H, Dh]`` window (the caller has already written the
        K1 in-flight columns, so row ``i`` sees its predecessors' keys),
        or a :class:`.kv_quant.QuantizedKV` pair.
      positions: ``[B]`` int32 — row ``i`` attends ``[0, positions[b] +
        i]``, clamped to the window.
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"``.

    Returns ``[B, K1, H, Dh]`` f32. On the card a ``K1`` outside ``[1,
    MAX_VERIFY_ROWS]`` raises :class:`VerifyRowsError`.
    """
    if resolve_impl(impl, q) == "torch":
        return torch_verify_decode_attention(q, k, v, positions)
    _check(q, k, v, positions, verify=True)
    out = _launch(q, k, v, positions, window=k.shape[1], verify=True)
    if isinstance(k, QuantizedKV):
        verify_decode_attention.int8_launches += 1
    else:
        verify_decode_attention.launches += 1
    return out


def paged_verify_decode_attention(q: torch.Tensor, k_pages, v_pages,
                                  page_table: torch.Tensor,
                                  positions: torch.Tensor, *,
                                  window: Optional[int] = None,
                                  impl: str = "auto") -> torch.Tensor:
    """Paged twin of :func:`verify_decode_attention`: q ``[B, K1, H,
    Dh]`` over pages ``[P, H, page_size, Dh]`` (or their int8 pair)
    through ``page_table`` ``[B, n_win]`` int32, as
    :func:`paged_decode_attention` reads them. Entries past a slot's
    last reachable column (``min(positions[b] + K1 - 1, window - 1)``)
    are never dereferenced. Returns ``[B, K1, H, Dh]`` f32."""
    if resolve_impl(impl, q) == "torch":
        return torch_paged_verify_decode_attention(
            q, k_pages, v_pages, page_table, positions, window)
    _check_paged(q, k_pages, v_pages, page_table, positions, window,
                 verify=True)
    ps = k_pages.shape[2]
    out = _launch(q, k_pages, v_pages, positions,
                  window=window or page_table.shape[1] * ps,
                  table=page_table, page_size=ps, verify=True)
    if isinstance(k_pages, QuantizedKV):
        paged_verify_decode_attention.int8_launches += 1
    else:
        paged_verify_decode_attention.launches += 1
    return out


# launches of the CUDA kernel's variants (incremented after a launch only)
for _fn in (decode_attention, paged_decode_attention,
            verify_decode_attention, paged_verify_decode_attention):
    _fn.launches = 0
    _fn.int8_launches = 0
del _fn
