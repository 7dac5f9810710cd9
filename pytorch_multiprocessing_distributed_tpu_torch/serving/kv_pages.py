"""Paged KV cache: fixed-size pages, per-slot page tables, and the
shared-prefix cache — the port of the JAX package's
``serving/kv_pages.py``.

:class:`~.kv_slots.SlotPool` pays the worst case per request: a dense
``[layers, max_slots, s_max, heads, head_dim]`` block reserves
``s_max`` columns for a 16-token request. Here K/V live in ``[layers,
num_pages, heads, page_size, head_dim]`` tensors and each slot maps its
logical columns onto pages through a ``[max_slots, pages_per_slot]``
int32 table. A request holding ``L + g`` tokens pins ``ceil((L + g) /
page_size)`` pages, so ``num_pages`` (the real memory commitment) can
follow the expected lengths while ``max_slots`` grows past the dense
worst case. Pages keep heads before the column offset, so one page of
one head is a contiguous ``[page_size, head_dim]`` tile
(:mod:`...ops.decode_attention`).

Allocation is host-mirrored: the free list, the refcounts and the table
live in host numpy; allocation never touches the device. The device
copy of the table is uploaded only when the mirror changed, as a fresh
tensor on the current stream: the caches are written in place and a
horizon may still be in flight when a slot is bound or released, so an
upload must land in stream order after the kernels that read the old
table, and the host memory it copies from must not change while the
copy is queued (a pinned copy of the mirror made for that upload).

Page 0 is the scratch page, never allocated: a released slot's table
row is reset to 0, so a frozen (inactive) row's idempotent re-write of
its pinned column lands in scratch, never in a page that has since gone
to another tenant. Scratch is never read: decode attention reads
columns up to each slot's position only, and no live table entry holds
0.

Shared prefixes (:class:`PrefixCache`): pages are refcounted, so
requests with a common page-aligned prompt prefix map their leading
table entries onto ONE set of pages, prefilled once. A joiner's first
divergent write (its column ``L``) lands in a fresh page or in a
copy-on-write fork of the prefix's partial last page; shared pages are
written only by the request that first filled them.

Tensor-parallel serving (``mesh``, a ``(1, M)`` grid): a rank's pages
hold its ``H / M`` heads, ``[layers, num_pages, H / M, page_size,
head_dim]``, JAX's head-sharded placement; the page table, the free
list, the refcounts and the :class:`PrefixCache` are host state, the
same on every rank.

Armed, the pool registers ``serving.kv_pages`` and ``serving.slot_state``
on the device-memory ledger with the ``pages_in_use`` gauges
(:mod:`..runtime.hbm`), and records page and slot grants on the
ownership ledger (:mod:`..runtime.life`), as JAX's does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kv_quant import KV_DTYPES
from ..runtime import hbm, life
from .kv_slots import check_pool_mesh, empty_kv, kv_group_bytes, pool_heads


class PagePoolExhausted(RuntimeError):
    """An allocation asked for more free pages than the pool holds. The
    engine never lets this escape admission for a request that could
    eventually fit: it holds the FIFO head queued (running requests free
    pages as they finish, and the prefix cache sheds LRU entries first)
    and fails a request named with this error only when nothing in
    flight could ever free enough pages for it."""


class PagePool:
    """Paged KV storage plus per-slot decode state for the engine.

    The engine surface of :class:`~.kv_slots.SlotPool`
    (``positions``/``last_tokens``/``active``/``budgets``/``eos_ids``,
    ``acquire``/``release``, the host position mirror) with the dense
    caches replaced by ``k_pages``/``v_pages`` and the page table.

    Args:
      model: the bound ``GPT`` the pages are shaped for.
      max_slots: concurrent requests decoded per step.
      s_max: per-slot LOGICAL column capacity (the admission bound).
      page_size: columns per page.
      num_pages: total pages INCLUDING the scratch page 0. Default
        ``max_slots * pages_per_slot + 1``, the dense worst case.
      kv_dtype: ``"model"`` or ``"int8"`` (pages become a
        :class:`...ops.kv_quant.QuantizedKV` with ``[L, P, H, ps]`` f32
        scales).
      mesh: a ``(1, M)`` grid, checked against ``model``: a rank's
        shard (``model.tp``) holds ``H / M`` heads.
    """

    def __init__(self, model, max_slots: int, s_max: Optional[int] = None,
                 *, page_size: int, num_pages: Optional[int] = None,
                 kv_dtype: str = "model", mesh=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        s_max = int(s_max or model.max_seq_len)
        if not 2 <= s_max <= model.max_seq_len:
            raise ValueError(
                f"s_max must be in [2, max_seq_len={model.max_seq_len}], "
                f"got {s_max}")
        page_size = int(page_size)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.model = model
        self.max_slots = int(max_slots)
        self.s_max = s_max
        self.kv_dtype = kv_dtype
        self.page_size = page_size
        self.pages_per_slot = -(-s_max // page_size)
        worst = self.max_slots * self.pages_per_slot + 1
        self.num_pages = int(num_pages) if num_pages is not None else worst
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (scratch + 1), got "
                f"{self.num_pages}")
        check_pool_mesh(model, mesh)
        self.heads = pool_heads(model)
        dev = model.device
        shape = (model.num_layers, self.num_pages, self.heads,
                 page_size, model.head_dim)
        self.k_pages = empty_kv(shape, model.dtype, kv_dtype, dev)
        self.v_pages = empty_kv(shape, model.dtype, kv_dtype, dev)
        n = self.max_slots
        self.positions = torch.zeros(n, dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros(n, dtype=torch.int32, device=dev)
        self.active = torch.zeros(n, dtype=torch.bool, device=dev)
        self.budgets = torch.zeros(n, dtype=torch.int32, device=dev)
        self.eos_ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
        # host mirror: table, free list, refcounts (scratch page 0 is
        # never allocated and permanently referenced)
        self._table = np.zeros((n, self.pages_per_slot), np.int32)
        self._free: List[int] = list(range(1, self.num_pages))
        self._refs = np.zeros((self.num_pages,), np.int64)
        self._refs[0] = 1
        self._table_dev: Optional[torch.Tensor] = None
        self._table_dirty = True
        self._free_slots: List[int] = list(range(n))
        self._positions_host: List[int] = [0] * n
        self._active_host: List[bool] = [False] * n
        # the ledger: the pool's real commitment (num_pages x
        # page_bytes) and live pages-in-use gauges
        if hbm.active_ledger() is not None:
            hbm.register("serving.kv_pages",
                         hbm.nbytes_of(self.k_pages)
                         + hbm.nbytes_of(self.v_pages),
                         category="kv_pages", slots=self.max_slots,
                         s_max=s_max, page_size=page_size,
                         num_pages=self.num_pages,
                         hbm_page_bytes=self.page_bytes)
            hbm.set_gauge("page_bytes", self.page_bytes)
            hbm.register("serving.slot_state",
                         sum(hbm.nbytes_of(a) for a in (
                             self.positions, self.last_tokens,
                             self.active, self.budgets, self.eos_ids))
                         + self._table.nbytes,
                         category="kv")
            self._note_pages_ledger()

    def _note_pages_ledger(self) -> None:
        """Refresh the utilization gauges on the armed ledger (gauges
        only: the capacity entry already counts these bytes)."""
        if hbm.active_ledger() is None:
            return
        used = self.pages_in_use
        hbm.set_gauge("pages_in_use", used)
        hbm.set_gauge("kv_pages_in_use_bytes", used * self.page_bytes)

    # ---- capacity accounting -------------------------------------------
    @staticmethod
    def page_kv_bytes(model, page_size: int,
                      kv_dtype: str = "model") -> int:
        """K+V bytes of ONE page: ``2 x layers x heads x page_size x
        group bytes`` (int8: ``head_dim`` bytes plus the f32 scale); a
        tensor-parallel shard's ``H / M`` heads."""
        return (2 * model.num_layers * pool_heads(model) * int(page_size)
                * kv_group_bytes(model, kv_dtype))

    @staticmethod
    def pages_for(total_tokens: int, page_size: int) -> int:
        """Pages a request holding ``total_tokens`` columns pins."""
        return -(-int(total_tokens) // int(page_size))

    @property
    def page_bytes(self) -> int:
        return self.page_kv_bytes(self.model, self.page_size,
                                  self.kv_dtype)

    @property
    def per_slot_bytes(self) -> int:
        """Worst-case bytes one slot can pin (``pages_per_slot`` pages
        and its decode state); what it holds is ``pages_in_use x
        page_bytes``."""
        from .kv_slots import SlotPool

        return (self.pages_per_slot * self.page_bytes
                + SlotPool.per_slot_state_bytes())

    @property
    def kv_bytes(self) -> int:
        """Device bytes of the page storage, scratch included."""
        return self.num_pages * self.page_bytes

    # ---- page allocation (host only) -----------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc_pages(self, n: int) -> List[int]:
        """Claim ``n`` free pages (refcount 1 each, lowest-numbered
        first). Raises :class:`PagePoolExhausted` when fewer are free."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"asked for {n} page(s), only {len(self._free)} free "
                f"of {self.num_pages - 1} (admission should hold the "
                "request until running work frees pages)")
        ids = self._free[:n]
        del self._free[:n]
        for p in ids:
            self._refs[p] = 1
        if hbm.active_ledger() is not None:
            self._note_pages_ledger()
        led = life.active_ledger()
        if led is not None:
            for p in ids:
                led.acquire("page", (id(self), p))
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        for p in ids:
            if p == 0:
                continue
            if self._refs[p] <= 0:
                raise ValueError(f"incref of free page {p}")
            self._refs[p] += 1

    def decref(self, ids: Sequence[int]) -> None:
        """Drop one reference per page; a page at zero returns to the
        (sorted) free list."""
        freed = False
        led = life.active_ledger()
        for p in ids:
            if p == 0:
                continue
            if self._refs[p] <= 0:
                raise ValueError(f"decref of free page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed = True
                if led is not None:
                    led.release("page", (id(self), p))
        if freed:
            self._free.sort()
            if hbm.active_ledger() is not None:
                self._note_pages_ledger()

    def page_refcount(self, page: int) -> int:
        return int(self._refs[page])

    # ---- page table (host mirror + lazy device copy) -------------------
    def bind_slot(self, slot: int, page_ids: Sequence[int]) -> None:
        """Point ``slot``'s table row at ``page_ids`` (padded with
        scratch 0). The row takes over the caller's one reference per
        page; :meth:`release` drops them."""
        if len(page_ids) > self.pages_per_slot:
            raise ValueError(
                f"{len(page_ids)} pages exceed pages_per_slot="
                f"{self.pages_per_slot}")
        row = np.zeros((self.pages_per_slot,), np.int32)
        row[:len(page_ids)] = page_ids
        self._table[slot] = row
        self._table_dirty = True

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's real (non-scratch) table entries, in column
        order."""
        return [int(p) for p in self._table[slot] if p != 0]

    def device_table(self) -> torch.Tensor:
        """The table as a device tensor, uploaded again only when the
        host mirror changed: a FRESH tensor each time, copied on the
        current stream from a private (pinned, on a card) snapshot of
        the mirror, so kernels still queued keep reading the old one."""
        if self._table_dirty or self._table_dev is None:
            snap = torch.from_numpy(self._table.copy())
            dev = self.positions.device
            if dev.type == "cuda":
                snap = snap.pin_memory()
            self._table_dev = snap.to(dev, non_blocking=True)
            self._table_dirty = False
        return self._table_dev

    # ---- slot accounting (SlotPool surface) ----------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def occupancy(self) -> int:
        return self.max_slots - len(self._free_slots)

    def acquire(self) -> int:
        if not self._free_slots:
            raise RuntimeError("no free slots (acquire() without "
                               "checking free_slots)")
        slot = self._free_slots.pop(0)
        led = life.active_ledger()
        if led is not None:
            led.acquire("slot", (id(self), slot))
        return slot

    def release(self, slot: int) -> None:
        """Return ``slot`` and drop its page references (shared prefix
        pages live on while the cache or other slots hold them); the
        row resets to scratch."""
        if slot in self._free_slots or not 0 <= slot < self.max_slots:
            raise ValueError(f"bad release of slot {slot}")
        self.decref(self.slot_pages(slot))
        self._table[slot] = 0
        self._table_dirty = True
        self._free_slots.append(slot)
        self._free_slots.sort()
        self._active_host[slot] = False
        led = life.active_ledger()
        if led is not None:
            led.release("slot", (id(self), slot))

    # ---- host position mirror (decode-window tracking) -----------------
    def note_insert(self, slot: int, position: int) -> None:
        self._positions_host[slot] = int(position)
        self._active_host[slot] = True

    def note_advance_slots(self, realized) -> None:
        for slot, steps in realized.items():
            self._positions_host[slot] += int(steps)

    @property
    def max_active_pos(self) -> int:
        return max(
            (p for p, live in zip(self._positions_host,
                                  self._active_host) if live),
            default=-1)


class PrefixEntry:
    """One cached shared prefix: ``n_full`` full pages covering
    ``tokens[: n_full * page_size]``, plus (when the registered prompt
    was not page-aligned) a cache-owned copy of the partial last page,
    so an identical prompt is a FULL hit with no prefill at all.
    ``tok0`` is the greedy first token the creator sampled."""

    __slots__ = ("tokens", "n_full", "shared_ids", "partial_id", "tok0",
                 "hits")

    def __init__(self, tokens: Tuple[int, ...], n_full: int,
                 shared_ids: List[int], partial_id: Optional[int],
                 tok0: Optional[int]):
        self.tokens = tokens
        self.n_full = n_full
        self.shared_ids = shared_ids
        self.partial_id = partial_id
        self.tok0 = tok0
        self.hits = 0


class PrefixCache:
    """Host-side index of prefilled prompt prefixes over a
    :class:`PagePool`, keyed on a hash of the prompt tokens.

    An entry is registered after a miss finishes its prefill: the
    slot's leading full pages are increfed (read-only from then on) and
    the partial last page, if any, is copied into a cache-owned page.
    Lookups walk page-aligned prefixes longest first and compare tokens
    (hashes only route). LRU-bounded (``max_entries``); eviction
    (explicit, LRU under page pressure, or :meth:`clear`) drops the
    cache's page references.
    """

    def __init__(self, pool: PagePool, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}")
        self.pool = pool
        self.max_entries = int(max_entries)
        self._lru: "OrderedDict[int, PrefixEntry]" = OrderedDict()
        self._by_prefix: Dict[Tuple[int, int], PrefixEntry] = {}
        self._full: Dict[int, PrefixEntry] = {}
        # longest registered prefix (in pages): bounds lookup's walk
        self._max_full = 0

    def __len__(self) -> int:
        return len(self._lru)

    def page_ids(self) -> set:
        """Every page an entry references."""
        return {p for e in self._lru.values()
                for p in e.shared_ids + ([e.partial_id]
                                         if e.partial_id is not None
                                         else [])}

    @staticmethod
    def _key(tokens: Sequence[int]) -> int:
        return hash(tuple(tokens))

    def lookup(self, prompt: Sequence[int]
               ) -> Tuple[Optional[PrefixEntry], int]:
        """Longest usable cached prefix of ``prompt``: ``(entry, k)``
        with ``k`` full shared pages, or ``(None, 0)``. A FULL hit is
        ``entry.tokens == tuple(prompt)`` with a ``tok0``."""
        ps = self.pool.page_size
        n = len(prompt)
        if not self._lru:
            return None, 0
        entry = self._full.get(self._key(prompt))
        if (entry is not None and entry.tokens == tuple(prompt)
                and entry.tok0 is not None):
            self._touch(entry)
            return entry, entry.n_full
        for k in range(min(n // ps, self._max_full), 0, -1):
            entry = self._by_prefix.get((k, self._key(prompt[:k * ps])))
            if (entry is not None
                    and entry.tokens[:k * ps] == tuple(prompt[:k * ps])):
                self._touch(entry)
                return entry, k
        return None, 0

    def _touch(self, entry: PrefixEntry) -> None:
        entry.hits += 1
        self._lru.move_to_end(id(entry))

    def has_prefix(self, prompt: Sequence[int]) -> bool:
        """Would :meth:`register` be a no-op for this prompt?"""
        entry, k = self.lookup(prompt)
        if entry is None:
            return False
        if entry.tokens == tuple(prompt):
            return True
        return k >= len(prompt) // self.pool.page_size

    def register(self, prompt: Sequence[int], page_ids: Sequence[int],
                 tok0: Optional[int], copy_page) -> Optional[PrefixEntry]:
        """Cache ``prompt``'s prefix off a freshly spliced slot whose
        table maps ``page_ids`` (column order). Increfs the leading
        ``len(prompt) // page_size`` full pages; a prompt that is not
        page-aligned gets a cache-owned copy of its partial page through
        ``copy_page(src, dst)`` when a page is free (else the entry
        covers the aligned prefix only and drops ``tok0``). No-op when
        nothing would be cached or the prefix is covered. Evicts LRU
        past ``max_entries``."""
        ps = self.pool.page_size
        n = len(prompt)
        n_full = n // ps
        if n_full < 1 or self.has_prefix(prompt):
            return None
        shared = [int(p) for p in page_ids[:n_full]]
        if len(shared) < n_full:
            raise ValueError(
                f"slot maps {len(page_ids)} page(s); prompt needs "
                f"{n_full} full page(s)")
        partial_id = None
        tokens = tuple(int(t) for t in prompt)
        if n % ps:
            if self.pool.free_pages >= 1:
                (partial_id,) = self.pool.alloc_pages(1)
                try:
                    copy_page(int(page_ids[n_full]), partial_id)
                except BaseException:
                    self.pool.decref([partial_id])  # no orphaned page
                    raise
            else:
                tokens = tokens[:n_full * ps]
                tok0 = None
        self.pool.incref(shared)
        entry = PrefixEntry(tokens, n_full, shared, partial_id, tok0)
        self._lru[id(entry)] = entry
        self._max_full = max(self._max_full, n_full)
        for k in range(1, n_full + 1):
            self._by_prefix.setdefault(
                (k, self._key(tokens[:k * ps])), entry)
        if entry.tok0 is not None:
            self._full.setdefault(self._key(tokens), entry)
        while len(self._lru) > self.max_entries:
            self.evict_lru()
        return entry

    def _drop(self, entry: PrefixEntry) -> None:
        self._lru.pop(id(entry), None)
        # rebuild the indexes from the survivors: a key the dropped entry
        # owned may be coverable by a later entry with the same prefix
        self._by_prefix.clear()
        self._full.clear()
        ps = self.pool.page_size
        self._max_full = 0
        for live in self._lru.values():
            for k in range(1, live.n_full + 1):
                self._by_prefix.setdefault(
                    (k, self._key(live.tokens[:k * ps])), live)
            if live.tok0 is not None:
                self._full.setdefault(self._key(live.tokens), live)
            self._max_full = max(self._max_full, live.n_full)
        self.pool.decref(entry.shared_ids)
        if entry.partial_id is not None:
            self.pool.decref([entry.partial_id])

    def evict_lru(self) -> bool:
        """Drop the least recently hit entry (False when empty): cache
        pages yield to admission before any request is held."""
        if not self._lru:
            return False
        _, entry = next(iter(self._lru.items()))
        self._drop(entry)
        return True

    def clear(self) -> None:
        """Drop every entry and its page references."""
        entries = list(self._lru.values())
        self._lru.clear()
        self._by_prefix.clear()
        self._full.clear()
        self._max_full = 0
        for entry in entries:
            self.pool.decref(entry.shared_ids)
            if entry.partial_id is not None:
                self.pool.decref([entry.partial_id])
