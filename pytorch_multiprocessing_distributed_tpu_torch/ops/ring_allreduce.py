"""Ring all-reduce over peer memory — the port of the JAX package's
``ops/pallas/ring_allreduce.py`` (the hand-built counterpart of NCCL's
ring; production gradients stay on NCCL through
:func:`..parallel.collectives.psum_`, as the JAX trainers stay on
``lax.psum``).

Algorithm (the classic two-phase ring, 2(n-1)/n of the payload over
each link): the payload is read as f32, flattened and padded as the JAX
kernel pads it (:func:`ring_layout`), and cut into n chunks;

1. reduce-scatter, n-1 hops: at hop t rank r sends chunk (r - t) to its
   right neighbour and adds the chunk (r - t - 1) arriving from its left
   as ``own + incoming``; rank r then holds the reduced chunk (r + 1);
2. all-gather, n-1 hops circulating the reduced chunks.

The padding fixes which chunk an element lies in, and so the order of
its sum: element e of chunk c is ``x[c+n-1] + (... + (x[c+1] + x[c]))``,
ranks mod n. The plain version, the gloo hops and the CUDA kernel all
keep that order, so they agree bit for bit with each other and with the
JAX ring.

Entries:

- :func:`ring_all_reduce` — the counterpart of JAX's
  ``ring_all_reduce(x, axis_name)``, over a process group: on a CUDA
  tensor the kernel of ``csrc/ring_allreduce.cu`` (one launch: it reads
  the caller's f32 payload as if padded and writes only the result's
  elements, so there is no pad and no copy); on a CPU tensor the same
  hops run as ``isend``/``irecv`` pairs with the neighbours (the plain
  version in a process group);
- :func:`ring_all_reduce_loopback` — n ranks' tensors on one card, one
  launch of the same kernel body (the single-card counterpart of the JAX
  test's virtual mesh); :func:`launch_loopback_` runs it in place on a
  ``[n, padded]`` buffer;
- :func:`torch_ring_all_reduce` — the plain version: n ranks' tensors in
  one process, hop by hop.

The kernel pipelines each hop in steps (:func:`ring_plan`): every block
of a rank owns one column range of every chunk, cut into steps of at
most ``RING_STEP`` elements; a step lands in one of ``RING_SLOTS``
slots of the right neighbour's comm buffer and is reduced and pushed on
as soon as it lands. The ring has no parameters. Its state is each
rank's comm buffer, fixed in size (``RING_BLOCKS x RING_SLOTS`` slots of
``RING_STEP`` f32, and u64 flags: ready and ack per slot, and a per-block
step count on the device from which the flags' sequence numbers rise,
so nothing is reset between calls), allocated once per (group, card).
Calls of one ring are ordered on one stream, and every rank of the group
makes the same calls in the same order, as for any collective.

``RING_BLOCKS``, ``RING_THREADS``, ``RING_STEP``, ``RING_SLOTS`` and
``RING_CONTROL`` are read at each call: a change takes a new comm buffer
(collectively, as every rank changes them at the same call), which is
how ``allreduce_bw --ring_configs`` A/Bs them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from . import resolve_impl
from ._build import load

__all__ = ["ring_layout", "ring_plan", "RingPlan", "ring_comm_bytes",
           "torch_ring_all_reduce", "ring_all_reduce",
           "ring_all_reduce_loopback", "launch_loopback_",
           "release_peer_buffers", "PeerAccessError"]

LANE = 128
# blocks per rank: each owns a column range of every chunk and runs its
# own ring with the same block of its neighbours
# (the winner of a cross-card A/B in turns on four H100s; PERF.md)
RING_BLOCKS = 64
RING_THREADS = 512  # data threads a block (8 or 16 warps)
RING_STEP = 16384   # elements a landing slot holds: a step's most (64 KB)
RING_SLOTS = 4      # K: landing slots per block
RING_CONTROL = 2    # control warps a block (1 to 7), taking turns
LOOPBACK_MAX_RANKS = 8  # kMaxLoopback of the kernel
_BLOCK_MIN = 1024   # elements of a chunk a block owns at least
_GRAIN = 32         # block ranges and steps in 128-byte lines


class PeerAccessError(RuntimeError):
    """A rank's card cannot reach a neighbour's memory (no NVLink or
    PCIe peer access): the ring has no host-staged path."""


def ring_layout(size: int, n: int) -> Tuple[int, int, int]:
    """``(rows, chunk, padded)`` of the JAX kernel for ``size`` elements
    over ``n`` ranks: rows of 128 lanes rounded up to a multiple of
    ``8 n``, ``chunk = rows * 128 / n`` elements, ``padded = rows *
    128``."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rows = -(-size // LANE)
    rows = -(-rows // (8 * n)) * (8 * n)
    return rows, rows * LANE // n, rows * LANE


def ring_comm_bytes(blocks: int, slots: int, slot: int) -> int:
    """Bytes of one rank's comm buffer (``pmdt_ring_comm_bytes``):
    landing slots ``[blocks][slots][slot]`` f32, then ``(2 slots + 1)
    blocks`` u64 flags."""
    return blocks * slots * slot * 4 + (2 * slots + 1) * blocks * 8


class RingPlan(NamedTuple):
    """How the kernel cuts one call (counts in f32 elements): what
    ``pmdt_ring_allreduce`` is launched with."""
    size: int        # elements of each rank's payload
    n: int           # ranks
    chunk: int       # elements of a chunk (the JAX padding's)
    blocks: int      # blocks launched per rank
    cap_blocks: int  # blocks the comm buffer holds
    per: int         # elements of every chunk each block owns
    step: int        # elements a step moves
    steps: int       # steps per hop, the same on every rank and block
    window: int      # steps taken through every hop together: K / 2
    slots: int       # K: landing slots per block
    slot: int        # elements a landing slot holds
    threads: int     # data threads a block
    control: int     # control warps a block
    comm_bytes: int  # one rank's comm buffer: fixed by cap_blocks, slots, slot

    def block_range(self, b: int) -> Tuple[int, int]:
        """``[lo, hi)`` of every chunk that block ``b`` owns."""
        return (min(self.chunk, b * self.per),
                min(self.chunk, (b + 1) * self.per))

    def step_range(self, b: int, s: int) -> Tuple[int, int]:
        """``[lo, hi)`` of every chunk that block ``b`` moves at step
        ``s`` of a hop (empty past the block's range)."""
        lo, hi = self.block_range(b)
        start = lo + s * self.step
        return min(hi, start), min(hi, start + self.step)


def ring_plan(size: int, n: int, *, blocks: Optional[int] = None,
              step: Optional[int] = None, slots: Optional[int] = None,
              threads: Optional[int] = None,
              control: Optional[int] = None) -> RingPlan:
    """The kernel's cut of ``size`` elements a rank over ``n`` ranks.

    ``blocks`` (default ``RING_BLOCKS``) is the comm buffer's block
    count; a call launches ``min(blocks, chunk / 1024)`` of them, fewer
    where the ranges, rounded to 32 elements, cover the chunk sooner.
    Each block's range is cut into ``steps`` equal steps of at most
    ``step`` (default ``RING_STEP``) elements. A block moves its steps
    in windows of ``window = slots // 2`` steps (``slots`` is
    ``RING_SLOTS`` by default): a window's steps through hop 0, then
    through hop 1, and so on, so a step's receipt comes ``window``
    iterations after its neighbour pushed it, and ``2 window`` slots
    hold every step in flight. ``threads`` (``RING_THREADS``) and
    ``control`` (``RING_CONTROL``) pass through. The plan depends on
    (size, n) and the settings only, so every rank computes the same
    one.
    """
    blocks = RING_BLOCKS if blocks is None else blocks
    slot = RING_STEP if step is None else step
    slots = RING_SLOTS if slots is None else slots
    threads = RING_THREADS if threads is None else threads
    control = RING_CONTROL if control is None else control
    if size < 1 or n < 2:
        raise ValueError(f"the ring needs size >= 1 and n >= 2, got size "
                         f"{size}, n {n}")
    if blocks < 1 or slots < 2 or slot < _GRAIN or slot % _GRAIN:
        raise ValueError(
            f"blocks >= 1, slots >= 2 and a step that is a positive "
            f"multiple of {_GRAIN} elements, got blocks {blocks}, slots "
            f"{slots}, step {slot}")
    if threads not in (256, 512):
        raise ValueError(f"threads must be 256 or 512, got {threads}")
    if not 1 <= control <= 7:
        raise ValueError(f"control warps must be 1 to 7, got {control}")
    _, chunk, _ = ring_layout(size, n)
    active = max(1, min(blocks, chunk // _BLOCK_MIN))
    per = _round_up(-(-chunk // active), _GRAIN)
    active = -(-chunk // per)
    steps = -(-per // slot)
    step = _round_up(-(-per // steps), _GRAIN)
    return RingPlan(size=size, n=n, chunk=chunk, blocks=active,
                    cap_blocks=blocks, per=per, step=step, steps=steps,
                    window=max(1, slots // 2), slots=slots, slot=slot,
                    threads=threads, control=control,
                    comm_bytes=ring_comm_bytes(blocks, slots, slot))


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _hop(rank: int, n: int, g: int) -> Tuple[int, int, bool]:
    """``(send chunk, receive chunk, reduce)`` of rank ``rank`` at hop
    ``g`` of ``2(n-1)``."""
    if g < n - 1:
        return (rank - g) % n, (rank - g - 1) % n, True
    t = g - (n - 1)
    return (rank + 1 - t) % n, (rank - t) % n, False


def _check_ranks(xs: Sequence[torch.Tensor]) -> None:
    if not xs:
        raise ValueError("need at least one rank's tensor")
    first = xs[0]
    for r, x in enumerate(xs):
        if (x.shape, x.dtype, x.device) != (first.shape, first.dtype,
                                            first.device):
            raise ValueError(
                f"rank {r}'s tensor is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}; rank 0's is {first.dtype} "
                f"{tuple(first.shape)} on {first.device}")


def _stack_padded(xs: Sequence[torch.Tensor], padded: int) -> torch.Tensor:
    """``[n, padded]`` f32: each rank's flattened payload, zero-padded."""
    size = xs[0].numel()
    work = torch.zeros(len(xs), padded, dtype=torch.float32,
                       device=xs[0].device)
    for r, x in enumerate(xs):
        work[r, :size].copy_(x.reshape(-1))
    return work


def _unpad(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flat[:like.numel()].view(like.shape).to(like.dtype)


def torch_ring_all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain version: the sum of ``xs`` (one tensor per rank, alike in
    shape, dtype and device) as the ring forms it, one result per rank,
    in the input's shape and dtype (f32 accumulation). One rank returns
    its input."""
    _check_ranks(xs)
    n = len(xs)
    if n == 1:
        return [xs[0]]
    size = xs[0].numel()
    _, chunk, padded = ring_layout(size, n)
    work = _stack_padded(xs, padded).view(n, n, chunk)
    ranks = torch.arange(n, device=work.device)
    left = (ranks - 1) % n
    for g in range(2 * (n - 1)):
        recv = torch.tensor([_hop(r, n, g)[1] for r in range(n)],
                            device=work.device)
        # rank r receives chunk recv[r] from its left neighbour, which
        # sends exactly that chunk at this hop
        incoming = work[left, recv]
        if _hop(0, n, g)[2]:
            work[ranks, recv] = work[ranks, recv] + incoming
        else:
            work[ranks, recv] = incoming
    flat = work.view(n, padded)
    return [_unpad(flat[r], xs[r]) for r in range(n)]


def _group_size_rank(group) -> Tuple[int, int]:
    if not tdist.is_available() or not tdist.is_initialized():
        return 1, 0
    return tdist.get_world_size(group), tdist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    if group is None or group is tdist.group.WORLD:
        return rank
    return tdist.get_global_rank(group, rank)


def _gloo_ring(x: torch.Tensor, group, n: int, rank: int) -> torch.Tensor:
    """The plain version's hops in a process group: ``isend`` of the
    send chunk to the right neighbour, ``irecv`` of the incoming one from
    the left, then ``own + incoming`` (or a store)."""
    _, chunk, padded = ring_layout(x.numel(), n)
    work = _stack_padded([x], padded).view(n, chunk)
    landing = torch.empty(chunk, dtype=torch.float32)
    right = _global_rank(group, (rank + 1) % n)
    left = _global_rank(group, (rank - 1) % n)
    for g in range(2 * (n - 1)):
        send, recv, reduce = _hop(rank, n, g)
        reqs = [tdist.isend(work[send], dst=right, group=group),
                tdist.irecv(landing, src=left, group=group)]
        for req in reqs:
            req.wait()
        if reduce:
            work[recv] = work[recv] + landing
        else:
            work[recv] = landing
    return _unpad(work.view(-1), x)


class _Plan(ctypes.Structure):
    """``PmdtRingPlan`` of the kernel."""
    _fields_ = [("size", ctypes.c_longlong), ("chunk", ctypes.c_longlong),
                ("per", ctypes.c_longlong), ("step", ctypes.c_longlong),
                ("slot", ctypes.c_longlong), ("n", ctypes.c_int),
                ("blocks", ctypes.c_int), ("cap_blocks", ctypes.c_int),
                ("slots", ctypes.c_int), ("steps", ctypes.c_int),
                ("window", ctypes.c_int), ("data_warps", ctypes.c_int),
                ("control", ctypes.c_int)]


def _c_plan(plan: RingPlan) -> _Plan:
    return _Plan(plan.size, plan.chunk, plan.per, plan.step, plan.slot,
                 plan.n, plan.blocks, plan.cap_blocks, plan.slots,
                 plan.steps, plan.window, plan.threads // 32, plan.control)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points with their ctypes signatures (built at first
    use)."""
    lib = load("ring_allreduce")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    plan = ctypes.POINTER(_Plan)
    sigs = {
        "pmdt_ring_comm_bytes": ([i, i, ll], ll),
        "pmdt_ring_resident": ([i, i, i, ctypes.POINTER(i)], i),
        "pmdt_ring_alloc": ([i, ll, ctypes.POINTER(vp)], i),
        "pmdt_ring_free": ([i, vp], i),
        "pmdt_ring_ipc_handle": ([i, vp, ctypes.c_char_p], i),
        "pmdt_ring_ipc_open": ([i, ctypes.c_char_p, ctypes.POINTER(vp)], i),
        "pmdt_ring_ipc_close": ([i, vp], i),
        "pmdt_ring_allreduce": ([i, i, vp, vp, vp, vp, vp, plan, vp], i),
        "pmdt_ring_allreduce_loopback": ([i, vp, vp, vp, ll, plan, vp], i),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring all-reduce: {what} failed: cudaError {err}")


def _config() -> Tuple[int, int, int, int, int]:
    """``(blocks, threads, step, slots, control)``: the module's settings
    now."""
    return RING_BLOCKS, RING_THREADS, RING_STEP, RING_SLOTS, RING_CONTROL


def _state_plan(state, size: int, n: int) -> RingPlan:
    """The plan of a call of ``size`` elements over ``n`` ranks on
    ``state``'s comm buffer (a :class:`PeerRing` or :class:`_Loopback`:
    its ``config`` and ``blocks``)."""
    _, threads, step, slots, control = state.config
    return ring_plan(size, n, blocks=state.blocks, step=step, slots=slots,
                     threads=threads, control=control)


def _launch_plan(state, size: int, n: int) -> _Plan:
    """:func:`_state_plan` as the kernel takes it, cached per size in
    ``state.plans``."""
    plan = state.plans.get(size)
    if plan is None:
        plan = state.plans[size] = _c_plan(_state_plan(state, size, n))
    return plan


def _payload(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: flat, f32, contiguous, 16-byte
    aligned; ``x`` itself where it already is, else one copy."""
    if (x.dtype == torch.float32 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x.reshape(-1)
    return torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).copy_(x).reshape(-1)


class PeerRing:
    """One rank's side of the ring over a process group: its comm buffer
    (``cudaMalloc``'d in the kernel library, one whole allocation, which
    an IPC handle covers) and the mappings of its neighbours', sized by
    the settings it was opened with and by nothing of a payload.
    :meth:`close` syncs the card and the group before it unmaps and
    frees, so no kernel in flight on any rank still writes."""

    def __init__(self, group, device: torch.device,
                 config: Tuple[int, int, int, int, int]):
        from ..parallel.collectives import all_gather_objects

        self.group = group
        self.n, self.rank = _group_size_rank(group)
        self.device = device
        self.config, self.blocks = config, config[0]
        self.plans: Dict[int, _Plan] = {}  # size -> the launch's plan
        lib, dev = _lib(), device.index
        _, _, slot, slots, _ = config
        self.nbytes = lib.pmdt_ring_comm_bytes(self.blocks, slots, slot)
        ptr = ctypes.c_void_p()
        _check(lib.pmdt_ring_alloc(dev, self.nbytes, ctypes.byref(ptr)),
               f"cudaMalloc of {self.nbytes} B on cuda:{dev}")
        self.own: Optional[int] = ptr.value
        self.peers: Dict[int, int] = {}  # group rank -> mapped pointer
        handle = ctypes.create_string_buffer(64)
        _check(lib.pmdt_ring_ipc_handle(dev, self.own, handle),
               "cudaIpcGetMemHandle")
        table = all_gather_objects((dev, handle.raw), self.group)
        for peer in sorted({(self.rank + 1) % self.n,
                            (self.rank - 1) % self.n}):
            peer_dev, peer_handle = table[peer]
            if peer_dev != dev and not torch.cuda.can_device_access_peer(
                    dev, peer_dev):
                raise PeerAccessError(
                    f"rank {self.rank} on cuda:{dev} cannot access the "
                    f"memory of rank {peer} on cuda:{peer_dev} "
                    "(torch.cuda.can_device_access_peer is False)")
            mapped = ctypes.c_void_p()
            _check(lib.pmdt_ring_ipc_open(dev, peer_handle,
                                          ctypes.byref(mapped)),
                   f"cudaIpcOpenMemHandle of rank {peer}'s buffer")
            self.peers[peer] = mapped.value

    def launch(self, src: torch.Tensor, out: torch.Tensor) -> None:
        """All-reduce ``src`` (this rank's flat f32 payload) into ``out``
        (as many f32) on the current stream."""
        size = src.numel()
        plan = _launch_plan(self, size, self.n)
        dev = self.device.index
        err = _lib().pmdt_ring_allreduce(
            dev, self.rank, src.data_ptr(), out.data_ptr(), self.own,
            self.peers[(self.rank + 1) % self.n],
            self.peers[(self.rank - 1) % self.n], ctypes.byref(plan),
            torch.cuda.current_stream(self.device).cuda_stream)
        _check(err, f"kernel launch (n={self.n}, size={size})")

    def close(self) -> None:
        """Unmap and free (collective: every rank of the group calls it)."""
        if self.own is None:
            return
        lib, dev = _lib(), self.device.index
        torch.cuda.synchronize(self.device)
        tdist.barrier(group=self.group)  # no rank's kernel is in flight
        for ptr in self.peers.values():
            _check(lib.pmdt_ring_ipc_close(dev, ptr), "cudaIpcCloseMemHandle")
        _check(lib.pmdt_ring_free(dev, self.own), "cudaFree")
        self.own, self.peers = None, {}


# one PeerRing per (group, card) of this process
_rings: Dict[Tuple[int, int], PeerRing] = {}


def _peer_ring(group, device: torch.device) -> PeerRing:
    """The (group, card)'s ring, opened at first use, and again only
    when the module's settings changed (collective, like the call)."""
    key = (id(group), device.index)
    ring = _rings.get(key)
    if ring is None or ring.config != _config():
        if ring is not None:
            ring.close()
        ring = _rings[key] = PeerRing(group, device, _config())
    return ring


def release_peer_buffers() -> None:
    """Close every peer ring of this process (collective over each
    ring's group)."""
    while _rings:
        _rings.popitem()[1].close()


def ring_all_reduce(x: torch.Tensor, group=None, *,
                    impl: str = "auto") -> torch.Tensor:
    """Sum-all-reduce ``x`` over ``group`` (default: the world) through
    the ring; semantically ``all_reduce(SUM)``, returned as a new tensor
    in ``x``'s shape and dtype (f32 accumulation). A world of one
    returns ``x`` itself.

    Args:
      x: any shape and dtype; every rank passes the same shape and dtype.
        On the card a contiguous, 16-byte aligned f32 ``x`` is read in
        place (one launch); any other is first copied into one.
      group: a ``torch.distributed`` process group, or None.
      impl: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see :mod:`..ops`): the
        kernel over peer memory for a CUDA tensor (one rank per card;
        every neighbour pair must have peer access, else
        :class:`PeerAccessError`), the plain hops over the group for a
        CPU tensor.
    """
    n, rank = _group_size_rank(group)
    path = resolve_impl(impl, x)
    if n == 1:
        return x
    if path == "torch":
        return _gloo_ring(x, group, n, rank)
    ring = _peer_ring(group, x.device)
    out = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
    ring.launch(_payload(x), out)
    ring_all_reduce.launches += 1
    return _unpad(out, x)


# launches of the CUDA kernel, one rank per card (incremented where it
# launches only)
ring_all_reduce.launches = 0


class _Loopback:
    """The comm buffers of n ranks on one card (torch memory: no IPC),
    fixed in size, with their flags and step counts; ``blocks`` is the
    most the cooperative launch keeps resident for n ranks."""

    def __init__(self, device: torch.device, n: int,
                 config: Tuple[int, int, int, int, int]):
        blocks, threads, slot, slots, control = config
        resident = ctypes.c_int()
        _check(_lib().pmdt_ring_resident(device.index, threads // 32,
                                         control, ctypes.byref(resident)),
               "occupancy query")
        self.config, self.blocks = config, min(blocks, resident.value // n)
        if self.blocks < 1:
            raise RuntimeError(
                f"ring loopback: {n} ranks of even one block exceed the "
                f"{resident.value} resident blocks of cuda:{device.index}")
        self.stride = _round_up(ring_comm_bytes(self.blocks, slots, slot),
                                256)
        self.comm = torch.zeros(n * self.stride, dtype=torch.uint8,
                                device=device)
        self.plans: Dict[int, _Plan] = {}  # size -> the launch's plan


_loopbacks: Dict[Tuple[int, int, Tuple[int, ...]], _Loopback] = {}


def _loopback_state(device: torch.device, n: int) -> _Loopback:
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, n, _config())
    state = _loopbacks.get(key)
    if state is None:
        state = _loopbacks[key] = _Loopback(device, n, _config())
    return state


def loopback_plan(size: int, n: int, device: torch.device) -> RingPlan:
    """The plan a loopback call of n ranks of ``size`` elements on
    ``device`` launches with (its blocks capped by residency)."""
    return _state_plan(_loopback_state(device, n), size, n)


def ring_all_reduce_loopback(xs: Sequence[torch.Tensor], *,
                             impl: str = "auto") -> List[torch.Tensor]:
    """The ring over ``n = len(xs)`` ranks whose tensors lie on one
    device: one result per rank, as :func:`ring_all_reduce` on n ranks
    would give them. On a CUDA device one cooperative launch of the
    kernel runs every rank (``n <= 8``); on the CPU the plain version.
    One rank returns its input."""
    _check_ranks(xs)
    path = resolve_impl(impl, xs[0])
    n = len(xs)
    if n == 1:
        return [xs[0]]
    if path == "torch":
        return torch_ring_all_reduce(xs)
    if n > LOOPBACK_MAX_RANKS:
        raise ValueError(
            f"the loopback kernel runs at most {LOOPBACK_MAX_RANKS} ranks "
            f"in one launch, got {n}")
    srcs = [_payload(x) for x in xs]
    outs = [torch.empty(x.numel(), dtype=torch.float32, device=x.device)
            for x in xs]
    _launch_loopback(srcs, outs)
    return [_unpad(o, x) for o, x in zip(outs, xs)]


def launch_loopback_(work: torch.Tensor) -> None:
    """The loopback kernel alone: reduce ``work`` (``[n, padded]`` f32 on
    a card, each row a rank's payload in :func:`ring_layout`'s padding)
    in place on the current stream."""
    n, padded = work.shape
    if not (work.is_cuda and work.dtype == torch.float32
            and work.is_contiguous() and 2 <= n <= LOOPBACK_MAX_RANKS
            and padded % (1024 * n) == 0 and work.data_ptr() % 16 == 0):
        raise ValueError(
            f"work must be a contiguous [n, padded] f32 CUDA tensor with "
            f"2 <= n <= {LOOPBACK_MAX_RANKS} and padded a multiple of "
            f"1024 n, got {work.dtype} {tuple(work.shape)} on {work.device}")
    rows = list(work)
    _launch_loopback(rows, rows)


def _launch_loopback(srcs: Sequence[torch.Tensor],
                     outs: Sequence[torch.Tensor]) -> None:
    """One cooperative launch: rank r all-reduces ``srcs[r]`` (flat,
    f32, aligned) into ``outs[r]`` (may be ``srcs[r]``)."""
    n, device = len(srcs), srcs[0].device
    state = _loopback_state(device, n)
    size = srcs[0].numel()
    plan = _launch_plan(state, size, n)
    ptrs = ctypes.c_void_p * LOOPBACK_MAX_RANKS
    xs = ptrs(*[s.data_ptr() for s in srcs])
    ys = ptrs(*[o.data_ptr() for o in outs])
    err = _lib().pmdt_ring_allreduce_loopback(
        device.index, xs, ys, state.comm.data_ptr(), state.stride,
        ctypes.byref(plan), torch.cuda.current_stream(device).cuda_stream)
    _check(err, f"loopback launch (n={n}, size={size})")
    ring_all_reduce_loopback.launches += 1


# launches of the loopback kernel (incremented where it launches only)
ring_all_reduce_loopback.launches = 0
