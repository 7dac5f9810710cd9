"""Ring all-reduce over peer memory — the port of the JAX package's
``ops/pallas/ring_allreduce.py`` (the hand-built counterpart of NCCL's
ring; production gradients stay on NCCL through
:func:`..parallel.collectives.psum_`, as the JAX trainers stay on
``lax.psum``).

Algorithm (the classic two-phase ring, 2(n-1)/n of the payload over
each link): the payload is cast to f32, flattened and padded as the JAX
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
  tensor the kernel of ``csrc/ring_allreduce.cu`` pushes chunks into the
  neighbours' landing slots through CUDA IPC mappings, with flags in
  peer memory; on a CPU tensor the same hops run as ``isend``/``irecv``
  pairs with the neighbours (the plain version in a process group);
- :func:`ring_all_reduce_loopback` — n ranks' tensors on one card, one
  launch of the same kernel body (the single-card counterpart of the JAX
  test's virtual mesh);
- :func:`torch_ring_all_reduce` — the plain version: n ranks' tensors in
  one process, hop by hop.

The ring has no parameters. Its state is each rank's comm buffer (two
landing slots of one chunk, and u64 flags: ready and ack per slot and
block, and a per-block call count on the device from which the flags'
sequence numbers rise, so nothing is reset between calls). Calls of one
ring are ordered on one stream, and every rank of the group makes the
same calls in the same order, as for any collective.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from . import resolve_impl
from ._build import load

__all__ = ["ring_layout", "torch_ring_all_reduce", "ring_all_reduce",
           "ring_all_reduce_loopback", "launch_loopback_",
           "release_peer_buffers", "PeerAccessError"]

LANE = 128
# blocks per rank: each owns a column range of every chunk and runs its
# own ring with the same block of its neighbours
RING_BLOCKS = 32
LOOPBACK_MAX_RANKS = 8  # kMaxLoopback of the kernel
_ALIGN = 1024  # slot capacity granule, elements (a chunk's granule)


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


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points with their ctypes signatures (built at first
    use)."""
    lib = load("ring_allreduce")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "pmdt_ring_comm_bytes": ([ll, i], ll),
        "pmdt_ring_alloc": ([i, ll, ctypes.POINTER(vp)], i),
        "pmdt_ring_free": ([i, vp], i),
        "pmdt_ring_ipc_handle": ([i, vp, ctypes.c_char_p], i),
        "pmdt_ring_ipc_open": ([i, ctypes.c_char_p, ctypes.POINTER(vp)], i),
        "pmdt_ring_ipc_close": ([i, vp], i),
        "pmdt_ring_allreduce": ([i, i, i, vp, vp, vp, vp, ll, ll, i, vp], i),
        "pmdt_ring_allreduce_loopback": ([i, i, vp, ll, vp, ll, ll, ll, i,
                                          vp], i),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring all-reduce: {what} failed: cudaError {err}")


def _capacity(chunk: int, cap: int) -> int:
    """The slot capacity (elements) for a chunk: at least double the old
    one, in 1024-element granules. A function of the call sequence only,
    so every rank grows at the same call."""
    want = max(chunk, 2 * cap)
    return -(-want // _ALIGN) * _ALIGN


class PeerRing:
    """One rank's side of the ring over a process group: its comm buffer
    (``cudaMalloc``'d in the kernel library, one whole allocation, which
    an IPC handle covers) and the mappings of its neighbours'. The
    buffers grow, collectively, when a payload's chunk outgrows the
    slots. :meth:`close` syncs the card and the group before it unmaps
    and frees, so no kernel in flight on any rank still writes."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.n, self.rank = _group_size_rank(group)
        self.device = device
        self.cap = 0
        self.own: Optional[int] = None
        self.peers: Dict[int, int] = {}  # group rank -> mapped pointer

    def reserve(self, chunk: int) -> None:
        if chunk > self.cap:
            self._grow(_capacity(chunk, self.cap))

    def _grow(self, cap: int) -> None:
        from ..parallel.collectives import all_gather_objects

        self.close()
        lib, dev = _lib(), self.device.index
        nbytes = lib.pmdt_ring_comm_bytes(cap, RING_BLOCKS)
        ptr = ctypes.c_void_p()
        _check(lib.pmdt_ring_alloc(dev, nbytes, ctypes.byref(ptr)),
               f"cudaMalloc of {nbytes} B on cuda:{dev}")
        self.own = ptr.value
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
        self.cap = cap

    def launch(self, work: torch.Tensor, chunk: int) -> None:
        """Reduce ``work`` (this rank's ``[n * chunk]`` f32 payload) in
        place on the current stream."""
        self.reserve(chunk)
        dev = self.device.index
        err = _lib().pmdt_ring_allreduce(
            dev, self.rank, self.n, work.data_ptr(), self.own,
            self.peers[(self.rank + 1) % self.n],
            self.peers[(self.rank - 1) % self.n], chunk, self.cap,
            RING_BLOCKS, torch.cuda.current_stream(self.device).cuda_stream)
        _check(err, f"kernel launch (n={self.n}, chunk={chunk})")

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
        self.own, self.peers, self.cap = None, {}, 0


# one PeerRing per (group, card) of this process
_rings: Dict[Tuple[int, int], PeerRing] = {}


def _peer_ring(group, device: torch.device) -> PeerRing:
    key = (id(group), device.index)
    ring = _rings.get(key)
    if ring is None:
        ring = _rings[key] = PeerRing(group, device)
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
    _, chunk, padded = ring_layout(x.numel(), n)
    if path == "torch":
        return _gloo_ring(x, group, n, rank)
    ring = _peer_ring(group, x.device)
    work = _stack_padded([x], padded)[0]
    ring.launch(work, chunk)
    ring_all_reduce.launches += 1
    return _unpad(work, x)


# launches of the CUDA kernel, one rank per card (incremented where it
# launches only)
ring_all_reduce.launches = 0


class _Loopback:
    """The comm buffers of n ranks on one card (torch memory: no IPC),
    with their flags and call counts; replaced by a larger one, zeroed,
    when a chunk outgrows the slots."""

    def __init__(self, device: torch.device, n: int, cap: int):
        self.cap = cap
        nbytes = _lib().pmdt_ring_comm_bytes(cap, RING_BLOCKS)
        self.stride = -(-nbytes // 256) * 256
        self.comm = torch.zeros(n * self.stride, dtype=torch.uint8,
                                device=device)


_loopbacks: Dict[Tuple[int, int], _Loopback] = {}


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
    _, _, padded = ring_layout(xs[0].numel(), n)
    work = _stack_padded(xs, padded)
    launch_loopback_(work)
    return [_unpad(work[r], xs[r]) for r in range(n)]


def launch_loopback_(work: torch.Tensor) -> None:
    """The loopback kernel alone: reduce ``work`` (``[n, padded]`` f32 on
    a card, each row a rank's payload in :func:`ring_layout`'s padding)
    in place on the current stream."""
    n, padded = work.shape
    if not (work.is_cuda and work.dtype == torch.float32
            and work.is_contiguous() and 2 <= n <= LOOPBACK_MAX_RANKS
            and padded % (1024 * n) == 0):
        raise ValueError(
            f"work must be a contiguous [n, padded] f32 CUDA tensor with "
            f"2 <= n <= {LOOPBACK_MAX_RANKS} and padded a multiple of "
            f"1024 n, got {work.dtype} {tuple(work.shape)} on {work.device}")
    chunk, device = padded // n, work.device
    key = (device.index, n)
    state = _loopbacks.get(key)
    if state is None or chunk > state.cap:
        state = _loopbacks[key] = _Loopback(
            device, n, _capacity(chunk, state.cap if state else 0))
    err = _lib().pmdt_ring_allreduce_loopback(
        device.index, n, work.data_ptr(), padded, state.comm.data_ptr(),
        state.stride, chunk, state.cap, RING_BLOCKS,
        torch.cuda.current_stream(device).cuda_stream)
    _check(err, f"loopback launch (n={n}, chunk={chunk})")
    ring_all_reduce_loopback.launches += 1


# launches of the loopback kernel (incremented where it launches only)
ring_all_reduce_loopback.launches = 0
