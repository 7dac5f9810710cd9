"""The verify kernel's split plan, on the CPU (jax-free).

On the card the speculative verify pass runs as CTAs of ``split`` keys
over a slot's window, one set per tile of 16 query rows; a CTA whose
split starts past the tile's reach returns at once, and a second kernel
folds the live splits' partials in split order.
:func:`verify_split_plan` is how the wrapper cuts a call (grid and
workspace), and :func:`verify_split_ranges` writes out, in Python, the
rule by which the kernel decides from a slot's position which CTAs are
live and which keys each walks. These tests hold both to their contract
for windows 1, 40, 64, 300 and 1024, K1 = 1, 5, 16 and 17 and positions
at the edges and at random, and show that the wrapper launches the same
plan for a dense window and for the same columns in pages.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    quantize_kv)

# the module (the package's ``decode_attention`` name is the function)
da = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")

WINDOWS = (1, 40, 64, 300, 1024)
ROWS = (1, 5, 16, 17)
SPLITS = (64, 128, 256)  # chip_smoke's A/B; 128 is the default


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positions(window, k1, seed):
    """0, the slot whose last row lands on the window's last column, the
    window's last column, one beyond the window, rows around the first
    split boundaries, and random columns."""
    rng = np.random.default_rng(seed)
    fixed = [0, max(window - k1, 0), window - 1, window + 3, 62, 126, 128]
    return sorted(set(fixed + rng.integers(0, window + 8, 8).tolist()))


def _reach(position, tile, window, k1):
    """The last column any row of ``tile`` attends."""
    last_row = min((tile + 1) * da.VERIFY_TILE_ROWS, k1) - 1
    return min(position + last_row, window - 1)


@pytest.mark.parametrize("k1", ROWS)
@pytest.mark.parametrize("window", WINDOWS)
def test_every_reachable_column_in_exactly_one_split(window, k1):
    for split in SPLITS:
        plan = da.verify_split_plan(8, 12, window, k1, 64, split=split)
        for pos in _positions(window, k1, seed=window * k1):
            for tile, ranges in enumerate(
                    da.verify_split_ranges(plan, pos, window, k1)):
                walked = [c for start, end in ranges
                          for c in range(start, end)]
                assert walked == list(range(
                    _reach(pos, tile, window, k1) + 1))
                for start, end in ranges:  # a range stays in its split
                    assert start % split == 0 and start < end
                    assert end <= start + split


@pytest.mark.parametrize("k1", ROWS)
@pytest.mark.parametrize("window", WINDOWS)
def test_splits_past_the_reach_are_skipped(window, k1):
    for split in SPLITS:
        plan = da.verify_split_plan(8, 12, window, k1, 64, split=split)
        for pos in _positions(window, k1, seed=window + k1):
            for tile, ranges in enumerate(
                    da.verify_split_ranges(plan, pos, window, k1)):
                reach = _reach(pos, tile, window, k1)
                live = {start // split for start, _ in ranges}
                # the merge folds reach // split + 1 splits, the live ones
                assert live == set(range(reach // split + 1))
                skipped = set(range(plan.n_splits)) - live
                assert all(s * split > reach for s in skipped)
                if pos == 0 and k1 <= split:
                    assert live == {0}


@pytest.mark.parametrize("k1", ROWS)
@pytest.mark.parametrize("window", WINDOWS)
def test_workspace_shape_matches_the_grid(window, k1):
    for split in SPLITS:
        for batch, heads, d in ((8, 12, 64), (3, 2, 32), (1, 4, 128)):
            plan = da.verify_split_plan(batch, heads, window, k1, d,
                                        split=split)
            assert plan.split == split
            assert plan.grid == (batch * heads, plan.n_splits,
                                 plan.row_tiles)
            assert plan.partials == (batch * heads, plan.row_tiles,
                                     plan.n_splits, da.VERIFY_TILE_ROWS,
                                     d + 4)
            # the splits cover the window, the tiles the rows, no more
            assert (plan.n_splits - 1) * split < window <= \
                plan.n_splits * split
            assert (plan.row_tiles - 1) * da.VERIFY_TILE_ROWS < k1 <= \
                plan.row_tiles * da.VERIFY_TILE_ROWS
    assert da.verify_split_plan(8, 12, window, k1, 64).split == \
        da.VERIFY_SPLIT


def test_plan_limits():
    """The default split, the largest row count the wrappers take within
    the grid's 65535 tiles, and splits the ring cannot take."""
    assert da.VERIFY_SPLIT in SPLITS
    plan = da.verify_split_plan(1, 1, 1024, da.MAX_VERIFY_ROWS, 64)
    assert plan.row_tiles <= 65535 and plan.n_splits <= 65535
    for bad in (0, 32, 96, 100):
        with pytest.raises(ValueError, match="multiple of 64"):
            da.verify_split_plan(1, 1, 1024, 5, 64, split=bad)


def _record_launch(monkeypatch):
    """Route the verify C entry to a recorder (CPU tensors: no card is
    touched); returns the list of launched plans."""
    launched = []

    def entry(args, stream):
        a = args._obj
        launched.append((a.d.B, a.d.H, a.d.W, a.d.D, a.k1, a.split,
                         a.n_splits, bool(a.d.table)))
        return 0

    monkeypatch.setattr(da, "_kernel", lambda verify=False: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return launched


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 24, 32])
def test_plan_does_not_depend_on_the_layout(monkeypatch, quant, ps):
    """The wrapper launches one plan for a dense 1024-column window and
    for the same columns in pages of 8, 16, 24 or 32 (24: split
    boundaries inside a page), model dtype or int8."""
    launched = _record_launch(monkeypatch)
    b, h, d, k1, w = 3, 2, 64, 5, 1024
    rng = np.random.default_rng(ps)
    q = torch.from_numpy(rng.standard_normal((b, k1, h, d),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, w, h, d),
                                             dtype=np.float32))
    n_win = -(-w // ps)
    pages = torch.from_numpy(rng.standard_normal((1 + b * n_win, h, ps, d),
                                                 dtype=np.float32))
    if quant:
        k, pages = quantize_kv(k), quantize_kv(pages)
    table = torch.arange(1, 1 + b * n_win, dtype=torch.int32).view(b, n_win)
    pos = torch.tensor([0, 517, w - 2], dtype=torch.int32)
    da._launch(q, k, k, pos, window=w, verify=True)
    da._launch(q, pages, pages, pos, window=w, table=table, page_size=ps,
               verify=True)
    plan = da.verify_split_plan(b, h, w, k1, d)
    assert launched == [(b, h, w, d, k1, plan.split, plan.n_splits, False),
                        (b, h, w, d, k1, plan.split, plan.n_splits, True)]
