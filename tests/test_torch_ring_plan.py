"""The ring kernel's cut and schedule on the CPU (``ops/ring_allreduce.py``
``ring_plan``; the kernel ``ops/csrc/ring_allreduce.cu`` runs only on a
card, so this file mirrors what it does with each plan).

- The plan: every element of every chunk belongs to exactly one (block,
  step) in each hop, for n = 2, 4 and 8, 1 to 64 blocks and sizes from 1
  to ResNet-18's 4,903,242; the steps per hop are the same for every
  rank and block; the comm buffer's bytes do not depend on the payload.
- The fused schedule: a torch emulation of the kernel (each block's
  iterations, its K landing slots, ready and ack flags and step counts
  carried from call to call; a step is moved as soon as its flags are
  set and the iteration ``control`` before it is posted, as the kernel's
  control warps take turns, and posts land out of order), with the
  ranks stepped round-robin. It asserts that no push
  overwrites a slot not yet read, that every read finds the step it
  expects, and that no rank waits forever; its results are bit-equal
  (tolerance 0) to ``torch_ring_all_reduce`` over consecutive calls of
  several sizes, in place too, and to the JAX ring (in interpret mode,
  as ``tests/test_torch_ring_allreduce.py`` runs it) on that file's
  cases.

The plan part imports no jax; the JAX comparison imports it in the test.
"""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.ops import ring_allreduce
from pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce import (
    ring_comm_bytes, ring_layout, ring_plan, torch_ring_all_reduce)

SIZES = (1, 1320, 3007, 70_000, 1_000_003, 4_903_242)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stage_chunk(rank, n, k):
    """The chunk that stage k of rank ``rank`` moves (the kernel's
    ``move``): its own at push 0, else the one it receives."""
    if k == 0:
        return rank
    if k <= n - 1:
        return (rank - k) % n
    return (rank - (k - n)) % n


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("blocks", [1, 16, 32, 64])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plan_gives_every_element_one_block_and_step(n, blocks, size):
    plan = ring_plan(size, n, blocks=blocks)
    _, chunk, _ = ring_layout(size, n)
    assert plan.chunk == chunk and 1 <= plan.blocks <= blocks
    assert plan.step <= plan.slot and plan.per % 32 == plan.step % 32 == 0
    hops = 2 * (n - 1)
    for rank in range(n):
        pushed = {c: np.zeros(chunk, np.int32) for c in range(n)}
        got = {c: np.zeros(chunk, np.int32) for c in range(n)}
        for k in range(hops + 1):
            c = _stage_chunk(rank, n, k)
            for b in range(plan.blocks):
                for s in range(plan.steps):
                    lo, hi = plan.step_range(b, s)
                    if k < hops:
                        pushed[c][lo:hi] += 1
                    if k >= 1:
                        got[c][lo:hi] += 1
        # each hop's chunk whole and once: a chunk is pushed once a hop
        # it passes through, received likewise
        for c in range(n):
            per_hop_push = sum(_stage_chunk(rank, n, k) == c
                               for k in range(hops))
            per_hop_recv = sum(_stage_chunk(rank, n, k) == c
                               for k in range(1, hops + 1))
            assert (pushed[c] == per_hop_push).all()
            assert (got[c] == per_hop_recv).all()
    # every block owns a non-empty range, and the ranges tile the chunk
    ranges = [plan.block_range(b) for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == chunk
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_steps_per_hop_are_the_same_on_every_rank(n):
    """The plan is a function of (size, n) and the settings alone, and a
    block's steps cover its range with no step wholly past it."""
    for size in SIZES:
        for blocks in (1, 16, 32, 64):
            plan = ring_plan(size, n, blocks=blocks)
            assert plan == ring_plan(size, n, blocks=blocks)
            for b in range(plan.blocks):
                lo, hi = plan.block_range(b)
                assert plan.steps * plan.step >= hi - lo
                if b < plan.blocks - 1:  # full ranges: no idle step
                    assert (plan.steps - 1) * plan.step < hi - lo


def test_comm_bytes_do_not_depend_on_the_payload():
    for blocks, step, slots in ((32, 8192, 4), (16, 2048, 2), (64, 16384, 8)):
        want = ring_comm_bytes(blocks, slots, step)
        assert want == blocks * slots * step * 4 + (2 * slots + 1) * blocks * 8
        for n in (2, 4, 8):
            for size in SIZES + (16 * 2 ** 20,):
                plan = ring_plan(size, n, blocks=blocks, step=step,
                                 slots=slots)
                assert plan.comm_bytes == want


def test_main_shapes():
    """ResNet-18's N over four ranks at the defaults, 64 MiB and 4 KiB."""
    plan = ring_plan(4_903_242, 4)
    assert (plan.chunk, plan.blocks) == (1_226_752, ring_allreduce.RING_BLOCKS)
    assert plan.per * plan.blocks >= plan.chunk
    tiny = ring_plan(1024, 4)
    assert (tiny.blocks, tiny.steps, tiny.chunk) == (1, 1, 1024)
    big = ring_plan(16 * 2 ** 20, 4)
    assert big.chunk == 4 * 2 ** 20 and big.comm_bytes == plan.comm_bytes


def test_plan_limits():
    with pytest.raises(ValueError, match="size >= 1"):
        ring_plan(0, 4)
    with pytest.raises(ValueError, match="n >= 2"):
        ring_plan(10, 1)
    with pytest.raises(ValueError, match="slots >= 2"):
        ring_plan(10, 2, slots=1)
    with pytest.raises(ValueError, match="multiple of 32"):
        ring_plan(10, 2, step=100)
    with pytest.raises(ValueError, match="threads"):
        ring_plan(10, 2, threads=128)
    with pytest.raises(ValueError, match="control warps"):
        ring_plan(10, 2, control=8)


# -- the emulation of the kernel's schedule


def _decode(plan, it):
    """``(stage, step, push, receipt)`` of a block's iteration ``it``, as
    the kernel's ``decode`` orders them: windows of ``plan.window``
    steps, each through every stage, step by step; push and receipt are
    the call's step numbers (meaningful where the stage pushes, k < 2(n-1),
    or receives, k >= 1)."""
    hops, w_max = 2 * (plan.n - 1), plan.window
    per_window = w_max * (hops + 1)
    full = plan.steps // w_max
    if it < full * per_window:
        w, r, width = it // per_window, it % per_window, w_max
    else:
        w, r, width = full, it - full * per_window, plan.steps - full * w_max
    k, local = divmod(r, width)
    before = w * w_max * hops
    return (k, w * w_max + local, before + k * width + local,
            before + (k - 1) * width + local)


class _Comm:
    """One rank's comm buffer: landing slots and flags."""

    def __init__(self, blocks, slots):
        self.ready = [[0] * slots for _ in range(blocks)]
        self.ack = [[0] * slots for _ in range(blocks)]
        self.seq = [0] * blocks
        self.slot = {}  # (block, k) -> [step j, data, read]


class _Block:
    """Block b of rank r over a sequence of calls, as the kernel runs it:
    ``moved`` iterations moved in order, ``posted`` the set posted.
    Iteration it is control warp it % control's, which releases it once
    its flags are set and it has posted it - control; posts may land out
    of order."""

    def __init__(self, r, b, emu):
        self.r, self.b, self.emu = r, b, emu
        self.call = -1
        self._next_call()

    def _next_call(self):
        self.call += 1
        while (self.call < len(self.emu.plans)
               and self.b >= self.emu.plans[self.call].blocks):
            self.call += 1
        if self.done:
            return
        self.plan = self.emu.plans[self.call]
        self.base = self.emu.comm[self.r].seq[self.b]
        self.iters = (2 * (self.plan.n - 1) + 1) * self.plan.steps
        self.moved, self.posted = 0, set()

    @property
    def done(self):
        return self.call >= len(self.emu.plans)

    def _pushes(self, it):
        return _decode(self.plan, it)[0] < 2 * (self.plan.n - 1)

    def _receives(self, it):
        return _decode(self.plan, it)[0] >= 1

    def _flags_set(self, it):
        own, k = self.emu.comm[self.r], self.plan.slots
        _, _, push, recv = _decode(self.plan, it)
        if self._receives(it):
            j = self.base + recv
            if own.ready[self.b][j % k] < j + 1:
                return False
        if self._pushes(it):
            j = self.base + push
            if j >= k and own.ack[self.b][j % k] < j - k + 1:
                return False
        return True

    def step(self):
        """One action if one can run: move the next iteration (first),
        else post a moved one (the newest every other time, so posts
        land out of order). Returns whether it acted."""
        if self.done:
            return False
        it = self.moved
        control = self.plan.control
        if (it < self.iters and (it < control or it - control in self.posted)
                and self._flags_set(it)):
            self._move(it)
            self.moved += 1
            return True
        waiting = sorted(set(range(self.moved)) - self.posted)
        if waiting:
            it = waiting[-1 if len(self.posted) % 2 else 0]
            self._post(it)
            self.posted.add(it)
            if len(self.posted) == self.iters:
                self.emu.comm[self.r].seq[self.b] = (
                    self.base + self.iters - self.plan.steps)
                self._next_call()
            return True
        return False

    def _move(self, it):
        p, n, r, b = self.plan, self.plan.n, self.r, self.b
        hops, k_slots = 2 * (n - 1), p.slots
        k, s, push, recv = _decode(p, it)
        lo, hi = p.step_range(b, s)
        c = _stage_chunk(r, n, k)
        x, y = self.emu.xs[self.call][r], self.emu.ys[self.call][r]
        e0, size = c * p.chunk, p.size
        if k <= n - 1:
            own = torch.zeros(hi - lo, dtype=torch.float32)
            a, z = min(size, e0 + lo), min(size, e0 + hi)
            own[:z - a] = x[a:z]
        if k >= 1:
            j = self.base + recv
            landed = self.emu.comm[r].slot[(b, j % k_slots)]
            assert landed[0] == j, "a receipt found another step"
            incoming = landed[1]
            landed[2] = True
        v = own if k == 0 else own + incoming if k <= n - 1 else incoming
        if k < hops:
            j = self.base + push
            right = self.emu.comm[(r + 1) % n]
            prev = right.slot.get((b, j % k_slots))
            assert prev is None or prev[2], "a push overwrote an unread slot"
            right.slot[(b, j % k_slots)] = [j, v.clone(), False]
        if k >= n - 1:
            a, z = min(size, e0 + lo), min(size, e0 + hi)
            y[a:z] = v[:z - a]

    def _post(self, it):
        p, n = self.plan, self.plan.n
        _, _, push, recv = _decode(p, it)
        if self._pushes(it):
            j = self.base + push
            self.emu.comm[(self.r + 1) % n].ready[self.b][j % p.slots] = j + 1
        if self._receives(it):
            j = self.base + recv
            self.emu.comm[(self.r - 1) % n].ack[self.b][j % p.slots] = j + 1


class _Emulation:
    def __init__(self, calls, in_place, **settings):
        n = len(calls[0])
        self.plans = [ring_plan(xs[0].numel(), n, **settings)
                      for xs in calls]
        cap, slots = self.plans[0].cap_blocks, self.plans[0].slots
        self.comm = [_Comm(cap, slots) for _ in range(n)]
        self.xs = [[x.reshape(-1).float().clone() for x in xs]
                   for xs in calls]
        self.ys = (self.xs if in_place else
                   [[torch.full_like(x, float("nan")) for x in xs]
                    for xs in self.xs])

    def run(self):
        n = len(self.comm)
        blocks = [_Block(r, b, self) for b in range(self.plans[0].cap_blocks)
                  for r in range(n)]
        while not all(blk.done for blk in blocks):
            # ranks round-robin, one action each a turn
            acted = [blk.step() for blk in blocks]
            assert any(acted), "no block can act: the ring waits forever"
        return self.ys


def _emulate(calls, in_place=False, **settings):
    """Each call's results, in its inputs' shape and dtype."""
    ys = _Emulation(calls, in_place, **settings).run()
    return [[y.view(x.shape).to(x.dtype) for y, x in zip(ys_c, xs)]
            for ys_c, xs in zip(ys, calls)]


def _inputs(n, shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, *shape)) * 1e3).astype(np.float32)
    return list(torch.from_numpy(x).to(dtype))


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_schedule_matches_plain_bit_for_bit(n, in_place):
    """Consecutive calls of alternating large and small payloads on one
    comm buffer, with a small step so that a hop takes several steps."""
    shapes = ((70_000,), (1,), (40, 33), (3007,), (20_000,))
    calls = [_inputs(n, shape, seed=10 * n + i)
             for i, shape in enumerate(shapes)]
    got = _emulate(calls, in_place=in_place, blocks=3, step=256, slots=4)
    for xs, ys in zip(calls, got):
        for g, w in zip(ys, torch_ring_all_reduce(xs)):
            assert g.shape == w.shape
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("control", [1, 2, 4])
@pytest.mark.parametrize("slots", [2, 3, 8])
def test_fused_schedule_any_slot_and_control_count(slots, control):
    calls = [_inputs(4, (9000,), seed=slots), _inputs(4, (30,), seed=1),
             _inputs(4, (5000,), seed=control)]
    got = _emulate(calls, blocks=2, step=96, slots=slots, control=control)
    for xs, ys in zip(calls, got):
        for g, w in zip(ys, torch_ring_all_reduce(xs)):
            assert torch.equal(g, w)


def test_allreduce_bw_ring_configs_parse():
    from pytorch_multiprocessing_distributed_tpu_torch.allreduce_bw import (
        build_parser)

    args = build_parser().parse_args(
        ["--ring_configs", "32:256:8192:4", "64:512:16384:8:4"])
    assert args.ring_configs == [(32, 256, 8192, 4), (64, 512, 16384, 8, 4)]
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--ring_configs", "32:256"])
    from pytorch_multiprocessing_distributed_tpu_torch import allreduce_bw
    with pytest.raises(SystemExit, match="--ring_configs"):
        allreduce_bw.main(["--device", "cpu", "--ring", "--ring_configs",
                           "32:256:8192:4"])


@pytest.mark.parametrize("name", ["f32_40x33", "one", "ragged_3007",
                                  "bf16_40x33"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_schedule_matches_jax_ring(n, name):
    from test_torch_ring_allreduce import (_bits, _jax_ring,
                                           _torch_inputs)

    want = _jax_ring(name, n)
    xs = list(_torch_inputs(name, n))
    (got,) = _emulate([xs], blocks=4, step=64, slots=2)
    for r in range(n):
        assert got[r].dtype == xs[r].dtype
        np.testing.assert_array_equal(_bits(got[r]), _bits(want[r]))
