"""Pre-allocated KV-cache slot pool for continuous-batching decode.

The port of the JAX package's dense ``SlotPool``: fixed
``[layers, max_slots, s_max, heads, head_dim]`` K/V tensors on the
device (model dtype, or with ``kv_dtype="int8"`` a
:class:`...ops.kv_quant.QuantizedKV` of int8 data and ``[layers,
max_slots, s_max, heads]`` f32 scales) plus per-slot state (next write
column, pending token, active flag, remaining decode budget, stop id).
The decode step runs over ALL slots every step with an active mask, so
occupancy changes values, never shapes.

Unlike the JAX pool, whose arrays are replaced functionally by each
jitted program, the caches here are written IN PLACE (the engine's
insert and decode steps index-assign into them): one resident copy, no
per-step reallocation.

Slot invariants (the equivalence-with-``generate`` contract):

- an ACTIVE slot with prompt length ``L`` that has emitted ``g`` tokens
  has valid cache columns ``[0, L + g - 1)`` and ``position == L + g -
  1`` (the column its pending token's K/V goes to next);
- decode attention masks columns ``> position``, so stale columns of a
  previous tenant are never read before they are overwritten;
- inactive rows keep a frozen position (their masked step re-writes the
  same column), so no index grows past ``s_max``.

The host mirrors each ACTIVE slot's position (``note_insert`` /
``note_advance_slots`` / ``max_active_pos``) so the engine picks its
attention window without reading the device.

Tensor-parallel serving (``mesh``, a ``(1, M)`` grid): a rank's caches
hold its ``H / M`` heads, ``[layers, max_slots, s_max, H / M,
head_dim]`` (int8 scales ``[..., H / M]``), JAX's head-sharded
placement; the slot state and the host mirror are the same on every
rank.

Armed, the pool registers its residency on the device-memory ledger
(:mod:`..runtime.hbm`: ``serving.kv_pool`` and ``serving.slot_state``,
JAX's names, categories and bytes; a speculative pool's spare columns
are in its bytes) and records every slot grant and return on the
ownership ledger (:mod:`..runtime.life`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.kv_quant import KV_DTYPES, QuantizedKV
from ..runtime import hbm, life


def kv_group_bytes(model, kv_dtype: str) -> int:
    """Bytes of one (token, head) group of K or V: ``head_dim``
    elements, plus the f32 scale in int8."""
    if kv_dtype == "int8":
        return model.head_dim + 4
    return model.head_dim * torch.empty((), dtype=model.dtype).element_size()


def pool_heads(model) -> int:
    """Heads a rank's pool holds: ``H / M`` for a tensor-parallel shard
    (``model.tp``, :func:`...inference.tp.shard_params_for_tp_decode`),
    all of them otherwise."""
    tp = getattr(model, "tp", None)
    return model.num_heads // (tp.size if tp is not None else 1)


def check_pool_mesh(model, mesh) -> None:
    """A pool on ``mesh`` takes that grid's shard of the model."""
    tp = getattr(model, "tp", None)
    m = tp.size if tp is not None else 1
    if mesh is not None and mesh.model != m:
        raise ValueError(
            f"a pool on a model axis of {mesh.model} needs the model's "
            f"shard for it (shard_params_for_tp_decode), got a model axis "
            f"of {m}")


def empty_kv(shape, dtype, kv_dtype: str, device):
    """A zeroed cache: model dtype, or int8 zeros with unit scales."""
    if kv_dtype == "int8":
        return QuantizedKV(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


class SlotPool:
    """Fixed-capacity KV-cache slots + per-slot decode state.

    Args:
      model: the bound ``GPT`` the caches are shaped for (layers, heads,
        dtype, device).
      max_slots: concurrent requests held on the device.
      s_max: per-slot sequence capacity (default ``model.max_seq_len``).
      kv_dtype: ``"model"`` or ``"int8"`` (int8 lanes plus one f32 scale
        per (token, head); untouched columns hold data 0 and scale 1,
        which dequantize to the zeros a model-dtype cache holds).
      spare_cols: columns past ``s_max`` that take writes but are never
        read (speculative decode's ``draft_k``: a verify pass writes up
        to ``draft_k`` columns past the last one a request can hold;
        the JAX package drops those writes, torch cannot, so they land
        here).
      mesh: a ``(1, M)`` grid, checked against ``model``: a rank's
        shard (``model.tp``) holds ``H / M`` heads.
    """

    def __init__(self, model, max_slots: int, s_max: Optional[int] = None,
                 kv_dtype: str = "model", spare_cols: int = 0, mesh=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        s_max = int(s_max or model.max_seq_len)
        if not 2 <= s_max <= model.max_seq_len:
            raise ValueError(
                f"s_max must be in [2, max_seq_len={model.max_seq_len}], "
                f"got {s_max}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.model = model
        self.kv_dtype = kv_dtype
        self.max_slots = int(max_slots)
        self.s_max = s_max
        self.spare_cols = int(spare_cols)
        check_pool_mesh(model, mesh)
        self.heads = pool_heads(model)
        dev = model.device
        shape = (model.num_layers, self.max_slots, s_max + self.spare_cols,
                 self.heads, model.head_dim)
        self.k_caches = empty_kv(shape, model.dtype, kv_dtype, dev)
        self.v_caches = empty_kv(shape, model.dtype, kv_dtype, dev)
        n = self.max_slots
        self.positions = torch.zeros(n, dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros(n, dtype=torch.int32, device=dev)
        self.active = torch.zeros(n, dtype=torch.bool, device=dev)
        self.budgets = torch.zeros(n, dtype=torch.int32, device=dev)
        self.eos_ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self._free: List[int] = list(range(n))
        self._positions_host: List[int] = [0] * n
        self._active_host: List[bool] = [False] * n
        if hbm.active_ledger() is not None:
            hbm.register("serving.kv_pool",
                         hbm.nbytes_of(self.k_caches)
                         + hbm.nbytes_of(self.v_caches),
                         category="kv", slots=self.max_slots,
                         s_max=s_max, per_slot=self.per_slot_bytes)
            hbm.register("serving.slot_state",
                         sum(hbm.nbytes_of(a) for a in (
                             self.positions, self.last_tokens,
                             self.active, self.budgets, self.eos_ids)),
                         category="kv")

    @staticmethod
    def per_slot_state_bytes() -> int:
        """Per-slot decode state: four int32 rows (position, pending
        token, budget, stop id) and one bool (active)."""
        return 4 * 4 + 1

    @property
    def per_slot_bytes(self) -> int:
        """Worst-case resident bytes a slot pins (K/V over ``s_max`` and
        its decode state): the ledger's ``hbm_per_slot_bytes``."""
        return (self.per_slot_kv_bytes(self.model, self.s_max,
                                       self.kv_dtype)
                + self.per_slot_state_bytes())

    @staticmethod
    def per_slot_kv_bytes(model, s_max: int,
                          kv_dtype: str = "model") -> int:
        """Worst-case K+V bytes ONE slot reserves for ``s_max`` tokens:
        ``2 x layers x s_max x heads x group bytes``, a group being
        ``head_dim`` elements (int8: one byte each plus the 4-byte f32
        scale); a tensor-parallel shard's ``H / M`` heads."""
        return (2 * model.num_layers * int(s_max) * pool_heads(model)
                * kv_group_bytes(model, kv_dtype))

    @property
    def kv_bytes(self) -> int:
        """Device bytes of the K/V caches (this rank's), spare columns
        included."""
        return self.max_slots * self.per_slot_kv_bytes(
            self.model, self.s_max + self.spare_cols, self.kv_dtype)

    # ---- host-side slot accounting -------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return self.max_slots - len(self._free)

    def acquire(self) -> int:
        """Claim the lowest-numbered free slot."""
        if not self._free:
            raise RuntimeError("no free slots (acquire() without "
                               "checking free_slots)")
        slot = self._free.pop(0)
        led = life.active_ledger()
        if led is not None:
            led.acquire("slot", (id(self), slot))
        return slot

    def release(self, slot: int) -> None:
        """Return ``slot`` to the free list (its device-side active flag
        was already cleared by the decode step's finish gate)."""
        if slot in self._free or not 0 <= slot < self.max_slots:
            raise ValueError(f"bad release of slot {slot}")
        self._free.append(slot)
        self._free.sort()
        self._active_host[slot] = False
        led = life.active_ledger()
        if led is not None:
            led.release("slot", (id(self), slot))

    # ---- host position mirror (decode-window tracking) -----------------
    def note_insert(self, slot: int, position: int) -> None:
        self._positions_host[slot] = int(position)
        self._active_host[slot] = True

    def note_advance_slots(self, realized) -> None:
        """Slot ``s`` advanced by ``realized[s]`` device steps."""
        for slot, steps in realized.items():
            self._positions_host[slot] += int(steps)

    @property
    def max_active_pos(self) -> int:
        """Highest position any ACTIVE slot writes next; -1 when idle."""
        return max(
            (p for p, live in zip(self._positions_host,
                                  self._active_host) if live),
            default=-1)
