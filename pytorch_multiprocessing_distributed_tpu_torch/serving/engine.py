"""Continuous-batching serving engine over the shared KV-cache decode.

The port of the JAX package's ``serving/engine.py``, single-engine
subset:

- the KV cache is a :class:`~.kv_slots.SlotPool` of fixed
  ``[layers, max_slots, s_max, heads, head_dim]`` tensors, or with
  ``kv_layout="paged"`` a :class:`~.kv_pages.PagePool` of fixed-size
  pages behind a per-slot page table (a request pins ``ceil((L +
  max_new) / page_size)`` pages instead of ``s_max`` columns), written in
  place; ``kv_dtype="int8"`` stores either as int8 lanes plus one f32
  scale per (token, head), quantized once at the insert and per token
  in the decode step (prefill and chunk caches stay in the model dtype);
- **prefill-on-join**, whole-prompt or chunked. Whole-prompt: a joining
  prompt is right-padded to its power-of-two bucket, run through the
  shared :func:`...inference.generate._prefill`, its first token sampled
  from the prefill logits (``generate``'s ``tok0``), and its cache
  columns spliced into a free slot. Chunked (``prefill_chunk=N``): the
  prompt runs ``[1, N]`` at a time through
  :func:`...inference.generate._block_chunk_prefill`, ONE chunk per
  engine step between decode horizons, so no running request waits
  longer than one chunk for its next token;
- **shared-prefix cache** (``prefix_cache=N``, paged and greedy only):
  a prompt whose leading pages were prefilled before maps them
  read-only; an identical prompt is a FULL hit (the cached first token
  is replayed, the partial last page forked copy-on-write, no prefill),
  a prompt that shares whole pages is a PARTIAL hit (the shared pages
  are gathered and only the suffix is chunk-prefilled). Under page
  pressure the FIFO head is held (counted in ``page_holds``), the cache
  sheds LRU entries first, and a head that nothing in flight could ever
  make room for fails named :class:`~.kv_pages.PagePoolExhausted`;
- **length-bucketed decode**: each decode step attends over the cache
  prefix ``[0, W)``, ``W`` the smallest ladder bucket covering the
  longest ACTIVE sequence (tracked on the host, no device read);
- **decode horizon**: when no admission is pending, up to
  ``decode_horizon`` steps run back to back
  (:func:`...inference.generate._decode_horizon`, the body ``generate``
  decodes on) with the eos/budget freeze gates on the device and ONE
  token-block readback; in steady state horizon ``h+1`` is launched
  before horizon ``h`` is read back, so the host does not sit between
  the card and its next work;
- **speculative decode** (``draft_k > 0``, greedy only): each decode
  pass proposes up to ``draft_k`` tokens per slot, from per-slot n-gram
  tables over the request's own tokens (:class:`~.spec.NgramDrafter`)
  or from a small draft GPT (``draft_model``/``draft_params``, its own
  dense caches prefilled at every admission), and verifies them with
  one ``draft_k + 1``-query target pass; a pass emits 1 to ``draft_k +
  1`` tokens per active slot. The realised k per dispatch is
  :func:`~.scheduler.pick_draft_k`'s on the ``{0, draft_k}`` ladder
  (collapsed under sustained low acceptance, re-probed every 16
  dispatches); k=0 dispatches run the plain decode body;
- decode attention is the hand-written CUDA flash-decode kernel on the
  card (``decode_attn="auto"``; dense or paged, model dtype or int8),
  and the verify pass its k-query twin, the plain PyTorch versions on
  the CPU.

Greedy decode through the engine is token-for-token identical to
per-request :func:`...inference.generate` (same helpers, same
dtype/eps conventions), dense or paged, whole or chunked, speculative
or not: the paged plain path gathers the same columns the dense one
slices, and every token a verify pass emits is the target's own greedy
output.

Tensor-parallel serving (``mesh``, a ``(1, M)`` grid of
:func:`...parallel.mesh.make_grid`, ``M`` dividing the heads): every
rank runs this same engine on its shard of the model
(:func:`...inference.tp.shard_params_for_tp_decode`) and its head shard
of the KV pool, ``[.., H / M, ..]`` dense or paged, int8 scales too.
The scheduler, the page tables, the prefix cache and the drafters are
host state replicated on every rank, as JAX's ``P()`` placements
replicate them; the engine decides from the token stream alone (the
clock only stamps metrics), so ranks that see the same submissions in
the same order stay in step, and every rank draws the same sampled
token from the same logits and generator seed. A draft model is
replicated and unsharded, as in JAX. Every path runs on the shard:
whole and chunked prefill, prefix hits, horizons, dense and paged,
int8, both speculative modes.

**Fault domains.** Every host-side hazard point registers a named
injection site under the JAX engine's name (:mod:`..runtime.faults`:
``serving.decode_dispatch``, ``serving.horizon_readback``,
``serving.prefill``, ``serving.prefill_chunk``, ``serving.prefill_tok0``,
``serving.slot_insert``) and runs under the bounded retry
(``dispatch_retries``, JAX's default 3): a retry re-runs the same call
on the same device and is counted, never a switch to another
implementation. A per-request operation (prefill, chunk, first token,
insert) that stays broken quarantines just that request (FAILED with
its error, its slot's device gates scrubbed and the slot recycled); an
engine-wide one (dispatch, readback) fails fast with a named
``GraftFaultError``. A recovered fault opens a cooldown of
``fault_cooldown`` dispatches at horizon 1 (``horizon_collapses``), and
speculation collapses with it. ``readback_timeout_s`` bounds each
token-block readback with a watchdog thread (``FaultTimeout``,
``watchdog_trips``); ``submit(deadline_s=...)`` evicts a request past
its deadline, queued, mid-chunked-prefill or running
(``DeadlineExceeded``, reason ``"deadline"``).

**Where the port classifies a failure differently from JAX on the CPU.**
JAX calls a failure inside a program that *donates* the pool engine-fatal
(``PoolPoisonedError``), and only on backends that donate, so its CPU
engine quarantines the request instead. The port donates nothing, but
it writes the KV pool and the slots' decode state IN PLACE on every
device: the decode horizon (its kernels write each slot's K/V column),
the insert splice, the prefix-hit fork and arm, and the quarantine
scrub. A real failure inside one of them (not an injected fault, which
fires before the call) may leave the pool partly written, so it is
``PoolPoisonedError`` on the CPU and on the card alike; so is a real
error at the readback (not ``OSError``-shaped), where CUDA reports a
launched kernel's failure. Prefill, chunk and first-token work writes
only the request's own standalone caches and keeps JAX's per-request
quarantine.

**Elastic lifecycle.** The engine carries a
:class:`~..runtime.heal.HealthState` (``STARTING`` while constructing,
``READY`` serving, ``DRAINING`` after :meth:`begin_drain`, which SIGTERM
flips through :func:`~..runtime.heal.install_drain_handler`, and
``DEAD`` after :meth:`drain` or a fatal :meth:`step`). Outside READY,
admission raises ``QueueFull`` naming the state; :meth:`drain` finishes
in-flight work up to its deadline and fails the overdue requests named
(reason ``"drain"``). With a ``journal``
(:class:`~..runtime.heal.RequestJournal`, greedy engines only) every
admission and each step's tokens are journaled at the drain boundary,
and a restarted engine re-submits the unfinished requests token-exact
through :meth:`redeliver`. A real device fault (a hung kernel, an
illegal address) leaves the CUDA context unusable, so an in-process
restart fails again until the supervisor's budget is spent
(``RestartBudgetExhausted``): recovery from it is a process restart
over the journal.

**Observability.** The engine emits the JAX engine's events on the
scope bus (:mod:`..runtime.scope`), at the same boundaries and with the
same attributes: the ``request.*`` lifecycle (submit, admit, held, shed,
first_token, done, failed, redelivered), the ``serving.prefill``,
``serving.prefill_chunk``, ``serving.prefill_tok0``,
``serving.prefix_hit`` and ``serving.slot_insert`` spans, the
``spec.draft``/``spec.draft_prefill`` spans and the ``spec.verify``
span of a speculative step, ``decode.dispatch`` and the
``decode.drain`` span, ``engine.draining`` and the ``engine.drain``
span, ``fault.horizon_collapse``, ``fault.watchdog_trip``, and
``engine.fatal`` with a flight-recorder dump. Every span wraps work
whose end the host already waits for (a readback, an admission's
first-token read, a host-side drafter refresh), or host-side work
between launches; none adds a sync. Armed, the engine's parameters go
on the device-memory ledger (``serving.params``, :mod:`..runtime.hbm`)
and each slot's grant is tagged with its request on the ownership
ledger (:mod:`..runtime.life`).

**Decisions that read the clock.** Three decisions change the engine's
state and depend on time: which requests a deadline expires at the
start of a step, whether a bounded :meth:`drain` is past its deadline
(and so which requests it fails as overdue), and, one level up, which
journaled requests a restarted engine redelivers (the caller hands them
to :meth:`redeliver`). The first two go through :attr:`decisions`:
None (the default) decides from this process's clock; a callable
``decisions(kind, decide)`` returns the decision instead, so that the
ranks of a ``mesh`` take rank 0's (``serve_lm``'s store lockstep: rank
0 calls ``decide()`` and sends the value, the other ranks receive it).
The engine applies exactly the uids it is given and raises when one is
not in flight here. Only the rank that owns the ``journal`` passes
one. ``readback_timeout_s`` arms each rank's own watchdog, and a firing
is fatal on that rank (its peers then wait in a gather until the
liveness gate ends them). The bounded retry needs no decision: every
rank reads the same ``PMDT_FAULT_PLAN`` and counts the same hits in the
same order, so the ranks retry the same calls and stay in step.

**Fleet seams.** :meth:`prefill_detached` (and its ``_wire`` and
``_resident`` exports) runs one request's prefill without touching the
pool and returns its standalone ``[L, 1, W, H, Dh]`` block;
:meth:`admit_prefilled` splices such a block at this engine's own slot
or pages; :meth:`withdraw`, :meth:`withdraw_queued` and
:meth:`hard_reclaim` give requests and residency back. Only the fleet's
router (:mod:`.router`) calls them.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from contextlib import nullcontext
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.generate import (_block_chunk_prefill, _decode_horizon,
                                  _embed_at, _logits, _prefill, _sample)
from ..inference.tp import check_mesh, shard_params_for_tp_decode
from ..ops import resolve_impl
from ..ops.kv_quant import KV_DTYPES, QuantizedKV, dequantize_kv, \
    quantize_kv, quantize_kv_np
from ..parallel import dist
from ..runtime import hbm, heal, life
from ..runtime import scope as graftscope
from ..runtime.faults import (DeadlineExceeded, FaultInjected,
                              FaultTimeout, GraftFaultError,
                              PoolPoisonedError, maybe_fault,
                              register_site, retry_with_backoff,
                              run_with_timeout)
from ..utils.metrics import ServingMetrics
from .kv_pages import PagePool, PagePoolExhausted, PrefixCache
from .kv_slots import SlotPool
from .scheduler import DONE, RUNNING, FIFOScheduler, \
    PrefillPlan, QueueFull, Request, RequestWithdrawn, bucket_length, \
    pick_draft_k, pick_horizon
from .spec import NgramDrafter

__all__ = ["ServingEngine", "Request"]

# the engine's hazard points, under the JAX engine's names
_SITE_DISPATCH = register_site(
    "serving.decode_dispatch",
    "decode-horizon launch over every slot (the engine's hot path)")
_SITE_READBACK = register_site(
    "serving.horizon_readback",
    "token-block readback sync at horizon drain (the step's ONE host "
    "sync; watchdog-bounded when readback_timeout_s is set)")
_SITE_PREFILL = register_site(
    "serving.prefill",
    "whole-prompt prefill-on-join + first-token readback")
_SITE_CHUNK = register_site(
    "serving.prefill_chunk",
    "one [1, chunk] incremental-prefill step of a joining prompt")
_SITE_TOK0 = register_site(
    "serving.prefill_tok0",
    "first-token sample + readback after the LAST prefill chunk (the "
    "chunked path's TTFT boundary; the whole-prompt path's is inside "
    "serving.prefill)")
_SITE_INSERT = register_site(
    "serving.slot_insert",
    "slot splice of a prefilled request (cache columns + finish gates)")

# re-probe a collapsed draft length every this many dispatches
_SPEC_PROBE_EVERY = 16

Event = Tuple[Request, int, bool]


def _put(cache, index, value) -> None:
    """``cache[index] = value`` on caches that may be quantized pairs
    (``index`` selects leading axes only)."""
    if isinstance(cache, QuantizedKV):
        cache.data[index] = value.data
        cache.scale[index] = value.scale
    else:
        cache[index] = value


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A block as host numpy; bf16 (which numpy lacks) as its raw
    ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A transferred block (a tensor, or :func:`_to_host`'s numpy) on
    ``device``; raw ``uint16`` bits become ``dtype`` bf16 again."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint16 and dtype == torch.bfloat16:
            x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class _TokenBlock:
    """One launched decode horizon awaiting readback: the device
    ``[rows, slots]`` token block plus which request held each slot at
    launch. ``rows == h`` for plain decode; a speculative horizon (``k
    > 0``) has ``h * (k + 1)`` rows — pass ``j``'s ``k + 1`` emission
    rows in order, ``-1`` where the device rejected or froze."""

    __slots__ = ("tokens", "h", "window", "slots", "k", "rows")

    def __init__(self, tokens, h, window, slots, k=0):
        self.tokens = tokens
        self.h = h
        self.window = window
        self.slots = slots
        self.k = k
        self.rows = h * (k + 1)


class _PendingPrefill:
    """The one request mid-chunked-prefill: its chunk plan, the
    standalone model-dtype caches the chunks fill (spliced into a slot
    after the last chunk), and its page reservation (paged only)."""

    __slots__ = ("request", "plan", "k_pref", "v_pref", "prep")

    def __init__(self, request, plan, k_pref, v_pref, prep=None):
        self.request = request
        self.plan = plan
        self.k_pref = k_pref
        self.v_pref = v_pref
        self.prep = prep


class _PagedPrep:
    """One paged admission's page reservation, made before the FIFO
    head is popped (host only). Holds one reference per page until the
    splice hands them to the slot's table row (``bind_slot``) or the
    admission aborts."""

    __slots__ = ("mode", "entry", "k", "shared_ids", "fresh_ids",
                 "fork_src", "n_total")

    def __init__(self, mode, entry, k, shared_ids, fresh_ids, fork_src,
                 n_total):
        self.mode = mode            # "miss" | "partial" | "full"
        self.entry = entry          # PrefixEntry (hits only)
        self.k = k                  # shared full pages reused
        self.shared_ids = shared_ids
        self.fresh_ids = fresh_ids  # freshly allocated, column order
        self.fork_src = fork_src    # copy-on-write source page
        self.n_total = n_total      # pages the request pins in total

    @property
    def page_ids(self):
        """The slot's column-ordered table row."""
        return list(self.shared_ids) + list(self.fresh_ids)


class ServingEngine:
    """Slot-based continuous-batching engine.

    Args:
      model: the bound ``GPT`` (params loaded); the engine runs on its
        device.
      mesh: a ``(1, M)`` grid with a ``model`` axis, on every rank of
        it: tensor-parallel serving on this rank's shard of ``model``
        (a whole model is sharded here; a shard for this place is taken
        as it is) and its ``H / M`` heads of the KV pool.
      max_slots: concurrent requests decoded per step (the pool size).
      s_max: per-slot token capacity (default ``model.max_seq_len``).
      max_queue: bound on QUEUED requests (None = unbounded).
      temperature/top_k/top_p: sampling config (0/0/0 = greedy, the
        mode pinned equivalent to ``generate``).
      generator: ``torch.Generator`` on the model's device, required
        when ``temperature > 0``.
      eos_id: default stop token (per-request ``eos_id`` overrides).
      min_bucket: smallest prefill bucket and first decode-window rung.
      decode_buckets: attention-window ladder (None = powers of two from
        ``min_bucket`` to ``s_max``; an empty sequence = always the
        full ``s_max`` window).
      prefill_chunk: admit prompts ``N`` tokens per engine step (None =
        whole-prompt prefill).
      decode_horizon: max decode steps per launched block (realised on
        the ``{1, H}`` ladder by :func:`~.scheduler.pick_horizon`).
      decode_attn: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see
        :mod:`...ops`).
      kv_layout: ``"dense"`` (slots) or ``"paged"`` (pages + table).
      kv_dtype: ``"model"`` or ``"int8"``.
      page_size: paged: columns per page (default ``min_bucket``).
      num_pages: paged: pages including the scratch page (default the
        dense worst case, ``max_slots * ceil(s_max / page_size) + 1``).
      prefix_cache: paged and greedy: LRU entries of the shared-prefix
        cache (0 = off).
      draft_k: > 0 arms speculative decode (greedy only): up to
        ``draft_k`` drafts per slot verified per pass. Dense caches then
        carry ``draft_k`` spare columns past ``s_max`` for the verify
        writes past the end of a sequence (never read).
      draft_model / draft_params: a registry GPT and its params (bound
        to it here, on the target's device) proposing the drafts instead
        of self-drafting; same vocab as the target, ``max_seq_len >=
        s_max``. Its dense ``[L_d, max_slots, s_max + draft_k, H_d,
        Dh_d]`` caches are prefilled whole-prompt at every admission.
      draft_buckets: n-gram table buckets per slot (self-drafting).
      dispatch_retries: bounded attempts of each host-side operation
        on transient (``OSError``-shaped, injected included) failures:
        dispatch, readback, prefill, chunk, first token, insert (1 = no
        retries).
      retry_backoff_s: the first retry's delay (doubling per retry).
      readback_timeout_s: a watchdog bound on each token-block readback
        attempt (None = no watchdog thread); a trip fails fast with
        ``FaultTimeout`` and counts in ``watchdog_trips``.
      fault_cooldown: dispatches held at horizon 1 after a recovered
        transient fault (each forced collapse counts in
        ``horizon_collapses``).
      journal: a :class:`~..runtime.heal.RequestJournal` (greedy only):
        admissions and each step's tokens are journaled, and
        :meth:`redeliver` replays its unfinished requests after a
        restart.
    """

    def __init__(self, model, *, max_slots: int, mesh=None,
                 s_max: Optional[int] = None,
                 max_queue: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, min_bucket: int = 16,
                 decode_buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: Optional[int] = None,
                 decode_horizon: int = 1, decode_attn: str = "auto",
                 kv_layout: str = "dense", kv_dtype: str = "model",
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, prefix_cache: int = 0,
                 draft_k: int = 0, draft_model=None, draft_params=None,
                 draft_buckets: int = 64, dispatch_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 readback_timeout_s: Optional[float] = None,
                 fault_cooldown: int = 8, journal=None):
        # health first: an engine that dies constructing reports
        # STARTING, never a stale READY
        self.health = heal.HealthState()
        if journal is not None and temperature > 0.0:
            raise ValueError(
                "journal redelivery requires deterministic (greedy) "
                "decode — a sampled stream cannot be replayed "
                "token-exact (temperature > 0 with a journal)")
        if model.device.type == "meta":
            raise ValueError(
                "model has no params: bind them first with "
                "model.load_state_dict(params, assign=True)")
        if mesh is not None:
            check_mesh(mesh, model.num_heads, "TP serving")
        if temperature > 0.0 and generator is None:
            raise ValueError(
                "sampling (temperature > 0) requires a generator")
        if top_k < 0 or top_k > model.vocab_size:
            raise ValueError(
                f"top_k must be in [0, vocab_size={model.vocab_size}], "
                f"got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        if dispatch_retries < 1:
            raise ValueError(
                f"dispatch_retries must be >= 1, got {dispatch_retries}")
        if readback_timeout_s is not None and readback_timeout_s <= 0:
            raise ValueError(
                f"readback_timeout_s must be > 0, got "
                f"{readback_timeout_s}")
        if fault_cooldown < 0:
            raise ValueError(
                f"fault_cooldown must be >= 0, got {fault_cooldown}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got "
                f"{kv_layout!r}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if kv_layout == "dense" and (page_size is not None
                                     or num_pages is not None
                                     or prefix_cache):
            raise ValueError(
                "page_size/num_pages/prefix_cache apply only with "
                "kv_layout='paged'")
        if prefix_cache < 0:
            raise ValueError(
                f"prefix_cache must be >= 0, got {prefix_cache}")
        if prefix_cache and temperature > 0.0:
            raise ValueError(
                "prefix_cache requires deterministic (greedy) decode — "
                "a cached first token cannot be replayed into a sampled "
                "stream (temperature > 0)")
        if draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {draft_k}")
        if draft_k and temperature > 0.0:
            raise ValueError(
                "speculative decode (draft_k > 0) is greedy-only: "
                "temperature > 0 cannot be verified by argmax "
                "matching — disarm spec or serve greedy")
        if draft_model is not None or draft_params is not None:
            if not draft_k:
                raise ValueError(
                    "draft_model/draft_params need draft_k > 0")
            if draft_model is None or draft_params is None:
                raise ValueError(
                    "draft-model speculation needs BOTH draft_model "
                    "and draft_params")
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft model vocab {draft_model.vocab_size} != "
                    f"target vocab {model.vocab_size} — drafts could "
                    "never verify")
        if draft_buckets < 1:
            raise ValueError(
                f"draft_buckets must be >= 1, got {draft_buckets}")
        resolve_impl(decode_attn, model.embed)  # device check
        self.mesh = mesh
        self.model = model = (model if mesh is None
                              else shard_params_for_tp_decode(model, mesh))
        self.eos_id = eos_id
        self.min_bucket = int(min_bucket)
        self._paged = kv_layout == "paged"
        self._kv_quant = kv_dtype == "int8"
        if self._paged:
            self.pool = PagePool(
                model, max_slots, s_max,
                page_size=int(page_size if page_size is not None
                              else min_bucket),
                num_pages=num_pages, kv_dtype=kv_dtype, mesh=mesh)
        else:
            self.pool = SlotPool(model, max_slots, s_max, kv_dtype=kv_dtype,
                                 spare_cols=draft_k, mesh=mesh)
        self._prefix_cache = (PrefixCache(self.pool, prefix_cache)
                              if prefix_cache else None)
        self._held_uid = None  # FIFO head currently held for pages
        self._attn_impl = decode_attn
        self.scheduler = FIFOScheduler(self.pool.s_max, max_queue)
        self.metrics = ServingMetrics()
        self._sampling = (float(temperature), int(top_k), float(top_p))
        self._generator = generator
        self._running: Dict[int, Request] = {}
        self._pending: Optional[_PendingPrefill] = None
        self._prefill_chunk = (None if prefill_chunk is None
                               else int(prefill_chunk))
        self._horizon_max = int(decode_horizon)
        # launched-but-unread token blocks (<= 2: double-buffered)
        self._blocks: Deque[_TokenBlock] = deque()
        self._buckets = self._build_buckets(decode_buckets)
        self._programs: set = set()  # (window, horizon) launched
        self._spec_programs: set = set()  # (window, horizon, k), k > 0
        # decode passes launched, by realised draft length (0 = plain)
        self.passes_by_k: Dict[int, int] = {}
        # all-gathers the decode horizons launched (tensor parallel)
        self.decode_gathers = 0
        self._init_spec(max_slots, int(draft_k), draft_model, draft_params,
                        int(draft_buckets))
        self._dispatch_retries = int(dispatch_retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._readback_timeout_s = (None if readback_timeout_s is None
                                    else float(readback_timeout_s))
        self._cooldown_steps = int(fault_cooldown)
        self._cooldown = 0  # dispatches left in the post-fault window
        # set at the first deadline-bearing submission: deadline-free
        # serving never scans the queue and slots for overdue requests
        self._deadlines_seen = False
        # the last drained speculative block's (drafted, accepted,
        # passes, k): the step's spec.verify span
        self._last_spec = None
        # resident params on the armed ledger (the pool registered its
        # own residency): tensor metadata, no device read
        if hbm.active_ledger() is not None:
            hbm.register("serving.params",
                         hbm.tree_nbytes(list(model.parameters())),
                         category="params")
        self.journal = journal
        # where the clock-driven decisions come from (None = this
        # process's clock; see the module docstring)
        self.decisions = None
        self.health.to_ready()

    def _init_spec(self, max_slots, draft_k, draft_model, draft_params,
                   draft_buckets) -> None:
        """Speculative state (all host side; disarmed == draft_k 0): the
        drafter or the bound draft model with its dense caches, and the
        acceptance EMA that collapses the draft length."""
        self._draft_k = draft_k
        self._draft_model = None
        self._drafter = None
        self._draft_k_caches = self._draft_v_caches = None
        dev = self.model.device
        if draft_k and draft_model is not None:
            if draft_model.max_seq_len < self.pool.s_max:
                raise ValueError(
                    f"draft model max_seq_len {draft_model.max_seq_len} "
                    f"< s_max={self.pool.s_max} — the draft cache could "
                    "not cover the slots")
            draft_model.load_state_dict(
                {name: t.to(dev) for name, t in draft_params.items()},
                assign=True)
            self._draft_model = draft_model
            shape = (draft_model.num_layers, int(max_slots),
                     self.pool.s_max + draft_k, draft_model.num_heads,
                     draft_model.head_dim)
            self._draft_k_caches = torch.zeros(
                shape, dtype=draft_model.dtype, device=dev)
            self._draft_v_caches = torch.zeros(
                shape, dtype=draft_model.dtype, device=dev)
        elif draft_k:
            self._drafter = NgramDrafter(int(max_slots), draft_k,
                                         draft_buckets, device=dev)
        # decayed mean of accepted/k per verify pass (None until the
        # first speculative drain): pick_draft_k's collapse signal
        self._accept_ema: Optional[float] = None
        self._spec_dispatches = 0

    def _build_buckets(self, decode_buckets) -> Tuple[int, ...]:
        """Ascending window ladder, capped by and ending at ``s_max``."""
        s_max = self.pool.s_max
        if decode_buckets is None:
            ladder = []
            b = self.min_bucket
            while b < s_max:
                ladder.append(b)
                b *= 2
            ladder.append(s_max)
            return tuple(ladder)
        ladder = sorted({int(b) for b in decode_buckets})
        if ladder and ladder[0] < 1:
            raise ValueError(
                f"decode_buckets must be >= 1, got {ladder[0]}")
        ladder = [b for b in ladder if b <= s_max]
        if not ladder or ladder[-1] != s_max:
            ladder.append(s_max)
        return tuple(ladder)

    # ---- introspection -------------------------------------------------
    @property
    def decode_horizon(self) -> int:
        return self._horizon_max

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def decode_programs(self) -> Tuple[Tuple[int, int], ...]:
        """Distinct ``(window, horizon)`` decode shapes launched."""
        return tuple(sorted(self._programs))

    @property
    def decode_windows(self) -> Tuple[int, ...]:
        return tuple(sorted({w for w, _ in self._programs}))

    @property
    def spec_programs(self) -> Tuple[Tuple[int, int, int], ...]:
        """Distinct ``(window, horizon, draft_k)`` speculative decode
        shapes launched (the k=0 ones are :attr:`decode_programs`)."""
        return tuple(sorted(self._spec_programs))

    @property
    def draft_k(self) -> int:
        """The configured maximum draft length (0 = spec disarmed)."""
        return self._draft_k

    @property
    def spec_accept_ema(self) -> Optional[float]:
        """Decayed mean of accepted drafts over k per verify pass (None
        before the first speculative drain)."""
        return self._accept_ema

    # ---- request lifecycle ---------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: Optional[int] = None, uid=None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue a request (FIFO). Raises ValueError when it can never
        fit a slot (or the page pool), ``QueueFull`` at the queue bound
        or outside READY. ``deadline_s`` bounds the request's wall time
        from submission; past it the request is evicted as FAILED
        (``DeadlineExceeded``)."""
        return self.enqueue(Request(
            prompt, max_new_tokens,
            self.eos_id if eos_id is None else eos_id, uid,
            deadline_s=deadline_s))

    def submit_retrying(self, prompt: Sequence[int],
                        max_new_tokens: int, *, attempts: int = 8,
                        backoff_s: float = 0.0,
                        eos_id: Optional[int] = None, uid=None,
                        deadline_s: Optional[float] = None,
                        events_out: Optional[list] = None) -> Request:
        """:meth:`submit` under a bounded retry on ``QueueFull`` that
        steps the engine between attempts, so the bounded queue drains.
        The request keeps its first attempt's ``submit_time``; the last
        ``QueueFull`` propagates. The steps' token events are appended
        to ``events_out`` when given."""
        request = Request(prompt, max_new_tokens,
                          self.eos_id if eos_id is None else eos_id,
                          uid, deadline_s=deadline_s)

        def drain_a_step(attempt: int, exc: BaseException) -> None:
            events = self.step()
            if events_out is not None:
                events_out.extend(events)

        return retry_with_backoff(
            lambda: self.enqueue(request), attempts=attempts,
            base_delay_s=backoff_s, retry_on=(QueueFull,),
            on_retry=drain_a_step)

    def enqueue(self, request: Request) -> Request:
        """Queue a pre-built :class:`Request`; ``submit_time`` is
        stamped on the first attempt and survives ``QueueFull``
        retries, so TTFT includes backpressure wait. Outside READY the
        admission is closed: ``QueueFull`` naming the state. A journal
        records the admission before any work is done on it."""
        if request.submit_time is None:
            request.submit_time = time.perf_counter()
        if not self.health.ready:
            self.metrics.record_shed()
            graftscope.emit("request.shed", cat="request",
                            req=request.uid, reason=self.health.state)
            raise QueueFull(
                f"admission closed: engine {self.health.state.upper()}"
                f" ({self.health.reason}); submit to another replica")
        if request.deadline_s is not None:
            self._deadlines_seen = True
        if request.prompt and (
                min(request.prompt) < 0
                or max(request.prompt) >= self.model.vocab_size):
            raise ValueError(
                f"prompt token ids must be in [0, vocab_size="
                f"{self.model.vocab_size})")
        if self._paged and request.prompt:
            # never-fits for the page pool is a submission error, like
            # the scheduler's s_max check (transient pressure is the
            # admission gate's hold, not this)
            need = PagePool.pages_for(
                len(request.prompt) + request.max_new_tokens,
                self.pool.page_size)
            if need > self.pool.num_pages - 1:
                raise ValueError(
                    f"request needs {need} page(s); the pool holds "
                    f"{self.pool.num_pages - 1} allocatable "
                    f"(num_pages={self.pool.num_pages} incl. scratch)")
        try:
            submitted = self.scheduler.submit(request)
        except QueueFull:
            self.metrics.record_shed()
            graftscope.emit("request.shed", cat="request",
                            req=request.uid)
            raise
        if self.journal is not None:
            # idempotent by uid: a redelivered request appends nothing
            self.journal.record_admit(submitted)
        graftscope.emit("request.submit", cat="request", req=request.uid,
                        prompt_len=len(request.prompt),
                        max_new_tokens=request.max_new_tokens)
        return submitted

    def _finished(self, request: Request, token: int) -> Optional[str]:
        if request.eos_id is not None and token == request.eos_id:
            return "eos"
        if len(request.tokens) >= request.max_new_tokens:
            return "length"
        return None

    def _complete(self, request: Request, reason: str) -> None:
        request.finish_time = time.perf_counter()
        self.scheduler.complete(request, reason)
        self.metrics.record_completion(len(request.tokens))
        graftscope.emit("request.done", cat="request", req=request.uid,
                        reason=reason, tokens=len(request.tokens))

    # ---- fault domains -------------------------------------------------
    def _pool_write(self, fn):
        """Run ``fn``, a call that writes the pool or the slots' decode
        state in place. A real failure inside it (a ``GraftFaultError``
        passes through; injected faults fire before it) may leave the
        pool partly written, so it is the engine-fatal
        ``PoolPoisonedError``, never a quarantine or a retry (see the
        module docstring for where this differs from JAX)."""
        try:
            return fn()
        except GraftFaultError:
            raise
        except Exception as e:
            # the flight ring first: it holds the dispatch and drain
            # events leading into the failed call
            graftscope.emit("engine.fatal", cat="fault",
                            error="PoolPoisonedError",
                            cause=type(e).__name__)
            graftscope.flight_dump(
                f"PoolPoisonedError: {type(e).__name__}: {e}")
            raise PoolPoisonedError(
                "a call writing the KV pool in place failed midway "
                f"({type(e).__name__}: {e}); the pool may be partly "
                "written — discard this engine (and the requests it "
                "held), it cannot keep serving") from e

    def _attempted(self, fn):
        """``fn`` under the engine's bounded retry (transient
        ``OSError``-shaped failures, injected ones included); each
        absorbed retry is counted and opens the horizon cooldown."""
        return retry_with_backoff(
            fn, attempts=self._dispatch_retries,
            base_delay_s=self._retry_backoff_s,
            on_retry=self._note_retry)

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        self.metrics.record_retry()
        self._cooldown = self._cooldown_steps

    def _attempted_engine(self, fn, what: str):
        """An engine-wide operation (dispatch, readback): retries spent
        fail fast with a named error."""
        try:
            return self._attempted(fn)
        except GraftFaultError:
            raise
        except OSError as e:
            raise GraftFaultError(
                f"{what} still failing after {self._dispatch_retries} "
                f"attempt(s): {type(e).__name__}: {e}") from e

    def _quarantine(self, request: Request, error: BaseException,
                    reason: str = "error",
                    slot: Optional[int] = None) -> None:
        """Evict one request as FAILED with its error. A slot it holds
        has its device gates scrubbed and is recycled; tokens launched
        blocks still hold for it are dropped at the drain (the
        ``_running`` identity check). A journal records it terminal."""
        if slot is None:
            slot = request.slot
        if slot is not None:
            self._scrub_slot(slot)
            if self._running.get(slot) is request:
                del self._running[slot]
            self.pool.release(slot)
        self.scheduler.fail(request, error, reason)
        request.finish_time = time.perf_counter()
        self.metrics.record_failure()
        if self.journal is not None:
            self.journal.record_failed(request)
        graftscope.emit("request.failed", cat="request", req=request.uid,
                        reason=reason, error=type(error).__name__,
                        tokens=len(request.tokens))

    def _poisoned(self, request: Request, error: BaseException,
                  slot: Optional[int] = None) -> None:
        """A per-request failure: transient classes (retries spent) and
        ordinary errors quarantine the request; a fatal named fault
        (``PoolPoisonedError`` included) propagates."""
        if (isinstance(error, GraftFaultError)
                and not isinstance(error, (FaultInjected,
                                           DeadlineExceeded))):
            raise error
        self._quarantine(request, error, slot=slot)

    def _scrub_slot(self, slot: int) -> None:
        """Freeze the slot's row on the device as an EOS would: masked
        every step, its stale columns invisible until the next tenant
        overwrites them."""
        pool = self.pool

        def scrub():
            pool.active[slot] = False
            pool.budgets[slot] = 0

        self._pool_write(scrub)

    def _decide(self, kind: str, decide):
        """``decide()``, or the value :attr:`decisions` gives for it."""
        if self.decisions is None:
            return decide()
        return self.decisions(kind, decide)

    def _overdue_uids(self) -> List:
        """The uids past their deadline now: queued (in queue order),
        mid-chunked-prefill, running (in slot order)."""
        now = time.perf_counter()
        uids = [r.uid for r in self.scheduler._queue if r.overdue(now)]
        pend = self._pending
        if pend is not None and pend.request.overdue(now):
            uids.append(pend.request.uid)
        uids.extend(r.uid for r in self._running.values() if r.overdue(now))
        return uids

    def _expire_deadlines(self) -> None:
        """Fail every request past its deadline: queued,
        mid-chunked-prefill or running (slot scrubbed). Nothing to scan
        until a deadline-bearing request was submitted. The uids are
        this clock's, or those :attr:`decisions` gives; one that is not
        in flight here raises."""
        if not self._deadlines_seen:
            return
        uids = self._decide("expire", self._overdue_uids)
        if not uids:
            return
        want = set(uids)
        expired = 0
        for request in self.scheduler.take(want):
            expired += 1
            self._quarantine(
                request,
                DeadlineExceeded(
                    f"request {request.uid} exceeded its "
                    f"{request.deadline_s:.3g}s deadline in the queue"),
                reason="deadline")
        pend = self._pending
        if pend is not None and pend.request.uid in want:
            expired += 1
            self._drop_pending()
            self._quarantine(
                pend.request,
                DeadlineExceeded(
                    f"request {pend.request.uid} exceeded its "
                    f"{pend.request.deadline_s:.3g}s deadline "
                    f"mid-chunked-prefill"),
                reason="deadline")
        for slot, request in list(self._running.items()):
            if request.uid in want:
                expired += 1
                self._quarantine(
                    request,
                    DeadlineExceeded(
                        f"request {request.uid} exceeded its "
                        f"{request.deadline_s:.3g}s deadline after "
                        f"{len(request.tokens)} token(s)"),
                    reason="deadline", slot=slot)
        if expired != len(want):
            raise RuntimeError(
                f"deadline expiry of {sorted(map(str, want))}: only "
                f"{expired} of them are in flight on this engine (its "
                "state left the deciding rank's)")

    def _pop_admission(self) -> Optional[Request]:
        request = self.scheduler.next_to_admit()
        if request is not None:
            request.admit_time = time.perf_counter()
            self.metrics.record_admission(
                request.admit_time - request.submit_time)
            graftscope.emit(
                "request.admit", cat="request", req=request.uid,
                queue_wait_s=request.admit_time - request.submit_time)
        return request

    def _first_token(self, request: Request, token: int,
                     events: List[Event]) -> Optional[int]:
        """Stamp TTFT, record the prefill token, and retire an
        already-finished request or acquire its slot (None = retired)."""
        request.first_token_time = time.perf_counter()
        self.metrics.record_first_token(
            request.first_token_time - request.submit_time)
        graftscope.emit(
            "request.first_token", cat="request", req=request.uid,
            ttft_s=request.first_token_time - request.submit_time)
        request.tokens.append(token)
        reason = self._finished(request, token)
        if reason is not None:
            self._complete(request, reason)
            events.append((request, token, True))
            return None
        slot = self.pool.acquire()
        led = life.active_ledger()
        if led is not None:
            led.tag("slot", (id(self.pool), slot), request.uid)
        request.slot = slot
        self._running[slot] = request
        events.append((request, token, False))
        return slot

    def _bucket_tokens(self, prompt: Sequence[int], length: int):
        """``[1, bucket]`` device tokens: the prompt right-padded to its
        length bucket (causality keeps the pad columns out of the real
        prefix)."""
        bucket = bucket_length(length, self.min_bucket, self.pool.s_max)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :length] = prompt[:length]
        return torch.from_numpy(padded).to(self.model.device)

    def _prefill(self, prompt: List[int], length: int):
        """Whole-prompt prefill of one request right-padded to its
        bucket; returns ``(tok0 device scalar, k_pref, v_pref)``."""
        tokens = self._bucket_tokens(prompt, length)
        x, k_pref, v_pref = _prefill(self.model, tokens, tokens.shape[1])
        logits = _logits(self.model, x[:, length - 1:length],
                         self.model.ln_eps)[:, 0]
        tok0 = _sample(logits, *self._sampling, self._generator)
        return tok0[0].to(torch.int32), k_pref, v_pref

    def _arm_slot(self, request: Request, slot: int, length: int,
                  tok0) -> None:
        """The slot's decode state: the position starts at the prompt
        length, the pending token is the first sample, and the finish
        gates arm (``max_new_tokens - 1`` decode tokens owed; the stop
        id or ``-1``)."""
        pool = self.pool
        pool.positions[slot] = length
        pool.last_tokens[slot] = tok0
        pool.active[slot] = True
        pool.budgets[slot] = request.max_new_tokens - 1
        pool.eos_ids[slot] = -1 if request.eos_id is None \
            else request.eos_id

    def _insert(self, request: Request, slot: int, k_pref, v_pref,
                length: int, tok0, prep: Optional[_PagedPrep] = None
                ) -> None:
        """Splice a prefilled request into ``slot`` (in place) and arm
        its decode state. The standalone ``[L, 1, W, H, Dh]`` prefill
        cache is quantized here, once, for an int8 pool. Dense: columns
        ``[0, W)`` overwrite the previous tenant's (a chunk plan's pad
        overshoot past ``s_max`` is dropped). Paged: the cache is cut
        into page tiles and written at the reservation's fresh pages;
        columns a shared prefix already holds, and pure pad, go to the
        scratch page; the slot's table row then takes the pages."""
        pool = self.pool
        if self._kv_quant and not isinstance(k_pref, QuantizedKV):
            k_pref, v_pref = quantize_kv(k_pref), quantize_kv(v_pref)
        width = k_pref.shape[2]
        if prep is None:
            width = min(width, pool.s_max)
            cols = (slice(None), slot, slice(0, width))
            writes = ((pool.k_caches, cols, k_pref[:, 0, :width]),
                      (pool.v_caches, cols, v_pref[:, 0, :width]))
        else:
            ps = pool.page_size
            n_w = -(-width // ps)
            write_ids = np.zeros((n_w,), np.int64)
            for j, page in enumerate(prep.fresh_ids):
                if prep.k + j < n_w:
                    write_ids[prep.k + j] = page
            ids = torch.from_numpy(write_ids).to(self.model.device)
            writes = ((pool.k_pages, (slice(None), ids),
                       self._to_pages(k_pref, n_w)),
                      (pool.v_pages, (slice(None), ids),
                       self._to_pages(v_pref, n_w)))

        def splice():
            for cache, index, value in writes:
                _put(cache, index, value)
            self._arm_slot(request, slot, length, tok0)

        def insert_once():
            # the site fires before the in-place writes, so a retried
            # injection never re-runs against a half-written pool
            maybe_fault(_SITE_INSERT)
            self._pool_write(splice)

        with graftscope.span("serving.slot_insert", cat="serving",
                             req=request.uid, slot=slot):
            self._attempted(insert_once)
            if prep is not None:
                page_ids = prep.page_ids
                pool.bind_slot(slot, page_ids)
                # ownership now lives in the table row
                prep.shared_ids, prep.fresh_ids = [], []
                self._register_prefix(request, page_ids)
        pool.note_insert(slot, length)
        if self._draft_k:
            self._spec_admit(request, slot, length)

    def _to_pages(self, c, n: int):
        """``[L, 1, W, H, Dh]`` (or its int8 pair) -> ``n`` page tiles
        ``[L, n, H, ps, Dh]``, zero-padded past ``W``."""
        ps = self.pool.page_size
        if isinstance(c, QuantizedKV):
            return QuantizedKV(self._to_pages(c.data, n),
                               self._to_pages(c.scale, n))
        l, _, w = c.shape[:3]
        full = c.new_zeros((l, n * ps) + tuple(c.shape[3:]))
        full[:, :w] = c[:, 0]
        # [L, n, ps, H(, Dh)] -> [L, n, H, ps(, Dh)]
        return full.reshape((l, n, ps) + tuple(c.shape[3:])).transpose(2, 3)

    # ---- paged admission -----------------------------------------------
    def _paged_prep_head(self):
        """Reserve pages for the FIFO head BEFORE popping it. Returns a
        :class:`_PagedPrep`, ``None`` (queue empty), ``"hold"`` (not
        enough free pages: the head STAYS QUEUED, prefix-cache entries
        were already shed LRU first, running work frees pages as it
        finishes) or ``"retry"`` (the head could never be satisfied:
        failed named ``PagePoolExhausted``; admission may look at the
        next head). Host only."""
        pool = self.pool
        head = self.scheduler.peek()
        if head is None:
            return None
        n_total = PagePool.pages_for(
            len(head.prompt) + head.max_new_tokens, pool.page_size)
        while True:
            entry, k = ((None, 0) if self._prefix_cache is None
                        else self._prefix_cache.lookup(head.prompt))
            full = (entry is not None
                    and entry.tokens == tuple(head.prompt)
                    and entry.tok0 is not None)
            if not full:
                # a partial hit must leave >= 1 suffix token to prefill
                # (it provides tok0)
                k = min(k, (len(head.prompt) - 1) // pool.page_size)
            needed = n_total - k
            if pool.free_pages >= needed:
                break
            # shed cache before holding traffic, then look again: the
            # shed may have taken the entry this hit planned to reuse
            if not (self._prefix_cache is not None
                    and self._prefix_cache.evict_lru()):
                break
        if pool.free_pages < needed:
            if (not self._running and self._pending is None
                    and not self._blocks
                    and not (self._prefix_cache
                             and len(self._prefix_cache))):
                # nothing in flight will ever free a page: fail the head
                # named, keep serving the queue behind it
                request = self._pop_admission()
                self._quarantine(request, PagePoolExhausted(
                    f"request {request.uid} needs {needed} page(s); "
                    f"only {pool.free_pages} exist free with nothing in "
                    f"flight to free more (num_pages={pool.num_pages})"),
                    reason="pages")
                return "retry"
            if self._held_uid != head.uid:
                # one deferred admission is one hold, however long
                self._held_uid = head.uid
                self.metrics.record_page_hold()
                graftscope.emit("request.held", cat="request",
                                req=head.uid, pages_needed=needed,
                                pages_free=pool.free_pages)
            return "hold"
        self._held_uid = None
        shared = list(entry.shared_ids[:k]) if entry is not None else []
        pool.incref(shared)
        fork_src = None
        if full and len(head.prompt) % pool.page_size:
            fork_src = entry.partial_id
            pool.incref([fork_src])
        fresh = pool.alloc_pages(needed)
        mode = "full" if full else ("partial" if k else "miss")
        return _PagedPrep(mode, entry, k, shared, fresh, fork_src,
                          n_total)

    def _abort_prep(self, prep: Optional[_PagedPrep]) -> None:
        """Return a reservation's pages (finished at its first token)."""
        if prep is None:
            return
        pool = self.pool
        pool.decref(prep.shared_ids)
        pool.decref(prep.fresh_ids)
        if prep.fork_src is not None:
            pool.decref([prep.fork_src])
        prep.shared_ids, prep.fresh_ids, prep.fork_src = [], [], None

    def _drop_pending(self) -> Optional[_PendingPrefill]:
        """Detach the in-flight chunked prefill, returning its pages
        (every quarantine and drain path that clears ``_pending``)."""
        pend = self._pending
        self._pending = None
        if pend is not None and pend.prep is not None:
            self._abort_prep(pend.prep)
        return pend

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork of one page, every layer (both parts of
        an int8 pair: the fork keeps the exact quantized values)."""
        pool = self.pool

        def copy():
            for pages in (pool.k_pages, pool.v_pages):
                _put(pages, (slice(None), dst), pages[:, src])

        self._pool_write(copy)

    def _note_outcome(self, request: Request, prep: _PagedPrep) -> None:
        request.prefix_hit = None if prep.mode == "miss" else prep.mode
        if self._prefix_cache is not None:
            # a miss only counts against an armed cache
            self.metrics.record_prefix_outcome(request.prefix_hit)

    def _admit_full_hit(self, request: Request, prep: _PagedPrep,
                        events: List[Event]) -> None:
        """FULL prefix hit: no prefill. The cached first token is
        replayed (greedy, enforced at construction), the prompt's pages
        are mapped read-only, the partial last page (if any) is forked
        copy-on-write, and only the slot's decode state is written."""
        with graftscope.span("serving.prefix_hit", cat="serving",
                             req=request.uid, pages_shared=prep.k,
                             mode="full"):
            pool = self.pool
            entry = prep.entry
            slot = self._first_token(request, int(entry.tok0), events)
            if slot is None:  # finished at its first token
                self._abort_prep(prep)
                return
            length = len(request.prompt)

            def splice_once():
                maybe_fault(_SITE_INSERT)
                if prep.fork_src is not None:
                    # the fork must hold the prefix's partial page before
                    # any decode write lands in it
                    self._copy_page(prep.fork_src, prep.fresh_ids[0])
                    pool.decref([prep.fork_src])
                    prep.fork_src = None
                self._pool_write(lambda: self._arm_slot(
                    request, slot, length, int(entry.tok0)))

            try:
                self._attempted(splice_once)
            except Exception as e:
                self._abort_prep(prep)
                self._poisoned(request, e, slot=slot)
                return
            pool.bind_slot(slot, prep.page_ids)
            prep.shared_ids, prep.fresh_ids = [], []
            pool.note_insert(slot, length)
            if self._draft_k:
                try:
                    self._spec_admit(request, slot, length)
                except Exception as e:
                    self._poisoned(request, e, slot=slot)

    def _spec_admit(self, request: Request, slot: int, length: int) -> None:
        """Per-admission speculative hook, after the target's splice on
        every admission path (whole, chunked, prefix hits):
        self-drafting rebuilds the slot's n-gram index from the
        request's tokens; draft-model mode prefills the draft on the
        bucket-padded prompt and splices its caches into the slot
        (columns past the prompt stay masked until the draft's own
        decode writes them)."""
        if self._drafter is not None:
            self._drafter.note_history(
                slot, list(request.prompt) + list(request.tokens))
            return
        tokens = self._bucket_tokens(request.prompt, length)
        bucket = tokens.shape[1]
        with graftscope.span("spec.draft_prefill", cat="serving",
                             req=request.uid, bucket=bucket):
            _, k_pref, v_pref = _prefill(self._draft_model, tokens, bucket)
        self._draft_k_caches[:, slot, :bucket] = k_pref[:, 0]
        self._draft_v_caches[:, slot, :bucket] = v_pref[:, 0]

    def _new_pending(self, request: Request, chunk: int,
                     prep: Optional[_PagedPrep]) -> _PendingPrefill:
        """Chunked-prefill state for ``request``: the plan (starting
        after the shared pages of a partial hit) and zeroed model-dtype
        caches wide enough for every chunk, with a partial hit's shared
        pages gathered into their leading columns (int8 pages
        dequantized there; the shared pages are not written again)."""
        pool, model = self.pool, self.model
        start_at = prep.k * pool.page_size if prep is not None else 0
        plan = PrefillPlan(request, chunk, self.min_bucket, pool.s_max,
                           start_at=start_at)
        width = max(plan.width, plan.starts[-1] + plan.chunk)
        shape = (model.num_layers, 1, width, pool.heads, model.head_dim)
        caches = []
        hit = (graftscope.span("serving.prefix_hit", cat="serving",
                               req=request.uid, pages_shared=prep.k,
                               mode="partial")
               if start_at else nullcontext())
        with hit:
            for pages in ((pool.k_pages, pool.v_pages) if start_at
                          else (None, None)):
                cache = torch.zeros(shape, dtype=model.dtype,
                                    device=model.device)
                if pages is not None:
                    ids = torch.tensor(prep.shared_ids, dtype=torch.long,
                                       device=model.device)
                    g = pages[:, ids]  # [L, k, H, ps, Dh]
                    if isinstance(g, QuantizedKV):
                        g = dequantize_kv(g, model.dtype)
                    g = g.transpose(2, 3).reshape(
                        model.num_layers, 1, start_at, pool.heads,
                        model.head_dim)
                    cache[:, :, :start_at] = g
                caches.append(cache)
        return _PendingPrefill(request, plan, caches[0], caches[1], prep)

    def _drive_pending(self, pend: _PendingPrefill,
                       events: List[Event]) -> bool:
        """Advance a pending chunked prefill by ONE chunk; on the last
        chunk, sample tok0 and splice. Returns True while chunks
        remain."""
        model = self.model
        start, valid, is_last = pend.plan.next_chunk()
        chunk = pend.plan.chunk
        padded = np.zeros((1, chunk), np.int64)
        padded[0, :valid] = pend.request.prompt[start:start + valid]

        def chunk_once():
            # writes only this request's standalone caches, the same
            # columns on a retry
            maybe_fault(_SITE_CHUNK)
            tokens = torch.from_numpy(padded).to(model.device)
            x = _embed_at(model, tokens, start, model.dtype)
            for i in range(model.num_layers):
                x = _block_chunk_prefill(
                    model.block(i), x, pend.k_pref[i], pend.v_pref[i],
                    start, self.pool.heads, model.dtype, model.ln_eps,
                    model.tp)
            return x

        try:
            with graftscope.span("serving.prefill_chunk", cat="serving",
                                 req=pend.request.uid, start=start,
                                 chunk=chunk):
                x = self._attempted(chunk_once)
        except Exception as e:
            if self._pending is pend:
                self._drop_pending()
            else:
                self._abort_prep(pend.prep)
            self._poisoned(pend.request, e)
            return False
        if not is_last:
            return True
        if self._pending is pend:
            self._pending = None  # the reservation moves to the splice
        idx = pend.plan.length - 1 - start

        def tok0_once():
            maybe_fault(_SITE_TOK0)
            logits = _logits(model, x[:, idx:idx + 1], model.ln_eps)[:, 0]
            t = _sample(logits, *self._sampling,
                        self._generator)[0].to(torch.int32)
            return t, int(self._fetch(t))

        try:
            # the chunked path's TTFT boundary: the host reads tok0
            with graftscope.span("serving.prefill_tok0", cat="serving",
                                 req=pend.request.uid):
                tok0, tok0_host = self._attempted(tok0_once)
        except Exception as e:
            self._abort_prep(pend.prep)
            self._poisoned(pend.request, e)
            return False
        slot = self._first_token(pend.request, tok0_host, events)
        if slot is None:
            self._abort_prep(pend.prep)
            return False
        try:
            self._insert(pend.request, slot, pend.k_pref, pend.v_pref,
                         pend.plan.length, tok0, prep=pend.prep)
        except Exception as e:
            self._abort_prep(pend.prep)
            self._poisoned(pend.request, e, slot=slot)
        return False

    def _register_prefix(self, request: Request, page_ids) -> None:
        """Offer a freshly spliced prompt's prefix to the cache (miss
        and partial-hit admissions). Best effort: the splice already
        succeeded, so a failed registration is reported, never
        raised."""
        if self._prefix_cache is None or self._sampling[0] > 0.0:
            return
        try:
            self._prefix_cache.register(
                request.prompt, page_ids, int(request.tokens[0]),
                self._copy_page)
        except GraftFaultError:
            raise  # a poisoned pool is engine-fatal, never swallowed
        except Exception as e:  # noqa: BLE001
            graftscope.emit("prefix_cache.register_failed",
                            cat="serving", req=request.uid,
                            error=type(e).__name__)
            print(f"prefix registration failed for request "
                  f"{request.uid}: {type(e).__name__}: {e}",
                  file=sys.stderr)

    # ---- admission -----------------------------------------------------
    def _admit(self) -> List[Event]:
        """Move FIFO-head requests toward slots: whole-prompt mode fills
        every free slot with one prefill each; chunked mode advances the
        one pending prefill by EXACTLY one chunk."""
        if self._prefill_chunk is None:
            return self._admit_whole()
        return self._admit_chunked()

    def _admit_whole(self) -> List[Event]:
        events: List[Event] = []
        pool = self.pool
        while pool.free_slots > 0:
            prep = None
            if self._paged:
                prep = self._paged_prep_head()
                if prep is None or prep == "hold":
                    break
                if prep == "retry":
                    continue
            request = self._pop_admission()
            if request is None:
                break
            if prep is not None:
                self._note_outcome(request, prep)
                if prep.mode == "full":
                    self._admit_full_hit(request, prep, events)
                    continue
                if prep.mode == "partial":
                    # the suffix through the chunk path, driven to the
                    # end within this admission
                    try:
                        pend = self._new_pending(request, pool.page_size,
                                                 prep)
                    except Exception as e:
                        self._abort_prep(prep)
                        self._poisoned(request, e)
                        continue
                    while self._drive_pending(pend, events):
                        pass
                    continue
            length = len(request.prompt)

            def prefill_once():
                maybe_fault(_SITE_PREFILL)
                tok0, k_pref, v_pref = self._prefill(request.prompt,
                                                     length)
                # the TTFT boundary: the host reads the first token here
                return tok0, k_pref, v_pref, int(self._fetch(tok0))

            try:
                with graftscope.span(
                        "serving.prefill", cat="serving", req=request.uid,
                        bucket=bucket_length(length, self.min_bucket,
                                             pool.s_max),
                        prompt_len=length):
                    tok0, k_pref, v_pref, tok0_host = self._attempted(
                        prefill_once)
            except Exception as e:
                self._abort_prep(prep)
                self._poisoned(request, e)
                continue
            slot = self._first_token(request, tok0_host, events)
            if slot is None:
                self._abort_prep(prep)
                continue
            try:
                self._insert(request, slot, k_pref, v_pref, length, tok0,
                             prep=prep)
            except Exception as e:
                self._abort_prep(prep)
                self._poisoned(request, e, slot=slot)
        return events

    def _admit_chunked(self) -> List[Event]:
        events: List[Event] = []
        if self._pending is None and self.pool.free_slots > 0:
            prep = None
            admit = True
            if self._paged:
                prep = self._paged_prep_head()
                admit = prep is not None and prep not in ("hold", "retry")
            request = self._pop_admission() if admit else None
            if request is not None:
                if prep is not None:
                    self._note_outcome(request, prep)
                    if prep.mode == "full":
                        self._admit_full_hit(request, prep, events)
                        return events
                try:
                    self._pending = self._new_pending(
                        request, self._prefill_chunk, prep)
                except Exception as e:
                    self._abort_prep(prep)
                    self._poisoned(request, e)
                    return events
        if self._pending is not None:
            self._drive_pending(self._pending, events)
        return events

    # ---- horizon scheduling / launch / drain ----------------------------
    def _inflight_steps(self) -> int:
        """Most columns any slot may have advanced in launched but
        unread blocks (a speculative block counts its ``h * (k + 1)``
        rows)."""
        return sum(block.rows for block in self._blocks)

    def _min_remaining_eff(self) -> int:
        """Shortest remaining budget over running requests, discounted
        by rows already launched against each slot."""
        rem = []
        for slot, request in self._running.items():
            assumed = sum(block.rows for block in self._blocks
                          if block.slots.get(slot) is request)
            rem.append(request.max_new_tokens - len(request.tokens)
                       - assumed)
        return min(rem) if rem else 0

    def _pick_k(self) -> int:
        """Draft length of the next dispatch on the ``{0, draft_k}``
        ladder, collapsed in the post-fault cooldown and under low
        acceptance. The probe counter advances on every pick, collapsed
        ones included, or a collapsed engine would never probe again."""
        if not self._draft_k:
            return 0
        probe = self._spec_dispatches % _SPEC_PROBE_EVERY == 0
        self._spec_dispatches += 1
        return pick_draft_k(self._draft_k, self._accept_ema,
                            self._cooldown > 0, probe=probe)

    def _pick_schedule(self) -> Tuple[int, int, int]:
        """``(window, horizon, k)``: the smallest bucket covering the
        highest possible next write (a speculative pass writes and reads
        ``k + 1`` columns past each position), the adaptive horizon,
        and the draft length."""
        k = self._pick_k()
        max_eff = self.pool.max_active_pos + self._inflight_steps()
        need = max_eff + 1 + k
        window = self._buckets[-1]
        for b in self._buckets:
            if b >= need:
                window = b
                break
        admission_pending = (self.scheduler.queue_depth > 0
                             or self._pending is not None)
        h = pick_horizon(self._horizon_max, window, max_eff,
                         self._min_remaining_eff(), admission_pending,
                         per_step=k + 1)
        if self._cooldown > 0:
            # post-fault: one token's work lost on a repeat, not a
            # horizon's, while the fault domain is suspect
            self._cooldown -= 1
            if h > 1:
                h = 1
                self.metrics.record_horizon_collapse()
                graftscope.emit("fault.horizon_collapse", cat="fault",
                                cooldown_left=self._cooldown)
        return window, h, k

    def _dispatch(self, overlapped: bool = False) -> None:
        """Launch one decode horizon over every slot; the token block
        stays on the device until :meth:`_drain_one` reads it. Transient
        failures are retried (the site fires before the launch, which
        writes the pool in place); spent retries fail fast, named: the
        dispatch covers every slot, so there is no one request to
        quarantine."""
        pool = self.pool
        window, h, k = self._pick_schedule()
        temperature, top_k, top_p = self._sampling
        if self._paged:
            # uploaded again only after a bind or release
            caches = (pool.k_pages, pool.v_pages)
            paged = dict(page_table=pool.device_table(),
                         page_size=pool.page_size)
        else:
            caches = (pool.k_caches, pool.v_caches)
            paged = {}
        spec = {}
        if k and self._drafter is not None:
            # the host-side table refresh (uploaded only when it changed)
            with graftscope.span("spec.draft", cat="serving", draft_k=k):
                table = self._drafter.device_table()
            spec = dict(draft_k=k, draft_table=table)
        elif k:
            spec = dict(draft_k=k, draft_model=self._draft_model,
                        draft_k_caches=self._draft_k_caches,
                        draft_v_caches=self._draft_v_caches)
        tp = self.model.tp
        gathers = tp.gathers if tp is not None else 0

        def launch():
            maybe_fault(_SITE_DISPATCH)
            return self._pool_write(lambda: _decode_horizon(
                self.model, *caches, pool.positions, pool.last_tokens,
                pool.active, pool.budgets, pool.eos_ids, h, window=window,
                attn_impl=self._attn_impl, temperature=temperature,
                top_k=top_k, top_p=top_p, generator=self._generator,
                **paged, **spec))

        tokens, (pool.positions, pool.last_tokens, pool.active,
                 pool.budgets) = self._attempted_engine(
            launch, "decode dispatch")
        if tp is not None:
            self.decode_gathers += tp.gathers - gathers
        if k:
            self._spec_programs.add((window, h, k))
        else:
            self._programs.add((window, h))
        self.passes_by_k[k] = self.passes_by_k.get(k, 0) + h
        self._blocks.append(_TokenBlock(tokens, h, window,
                                        dict(self._running), k=k))
        self.metrics.record_dispatch(h, overlapped)
        graftscope.emit("decode.dispatch", cat="serving", window=window,
                        horizon=h, draft_k=k, overlapped=overlapped,
                        occupancy=pool.occupancy)

    def _overlap_ok(self) -> bool:
        """Launch horizon h+1 before reading horizon h back? Only in
        steady state: horizons on, one block in flight, no admission
        work, and some running request with budget beyond what is
        launched."""
        return (self._horizon_max > 1
                and len(self._blocks) == 1
                and bool(self._running)
                and self.scheduler.queue_depth == 0
                and self._pending is None
                and self._min_remaining_eff() >= 1)

    def _fetch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host. Under a mesh the liveness gate first covers
        the wait for the collectives queued before it
        (:func:`...parallel.dist.gate_collectives`), so a peer lost
        inside NCCL raises instead of hanging the fetch."""
        if self.mesh is not None:
            dist.gate_collectives(t.device)
        return t.cpu()

    def _drain_one(self, events: List[Event]) -> Tuple[int, int]:
        """Read the OLDEST block back (the horizon's one host sync) and
        attribute its tokens: append per request, replay the finish
        rules the device applied (``-1`` marks rows it froze), release
        finished slots (and their pages), advance the position mirror by
        the realised per-slot steps. Returns ``(window,
        tokens_emitted)``. With ``readback_timeout_s`` a watchdog bounds
        each readback attempt (retry backoff is not charged to it): a
        hang fails fast as ``FaultTimeout``, a flake retries."""
        pool = self.pool
        block = self._blocks.popleft()

        def readback():
            maybe_fault(_SITE_READBACK)
            try:
                return self._fetch(block.tokens).numpy()
            except (GraftFaultError, OSError):
                raise
            except Exception as e:
                # CUDA reports a launched kernel's failure at the sync:
                # the horizon that wrote the pool failed
                raise PoolPoisonedError(
                    f"the token-block readback failed ({type(e).__name__}"
                    f": {e}); the decode horizon that wrote the pool in "
                    "place did not complete — discard this engine") from e

        def attempt():
            if self._readback_timeout_s is None:
                return readback()
            try:
                return run_with_timeout(
                    readback, self._readback_timeout_s,
                    "horizon token-block readback",
                    hint="the device never delivered the block (a hung "
                         "kernel or an injected hang); the engine fails "
                         "fast rather than serving stale state.")
            except FaultTimeout:
                self.metrics.record_watchdog_trip()
                graftscope.emit("fault.watchdog_trip", cat="fault",
                                what="horizon_readback")
                raise

        # the span wraps the readback the host waits on anyway
        with graftscope.span("decode.drain", cat="serving", h=block.h,
                             window=block.window) as drain_span:
            tokens = self._attempted_engine(
                attempt, "horizon token-block readback")
            realized: Dict[int, int] = {}
            for row in range(block.rows):
                for slot, request in block.slots.items():
                    if self._running.get(slot) is not request:
                        continue  # finished earlier (this or a prior block)
                    token = int(tokens[row, slot])
                    if token < 0:
                        continue  # the device froze the row before
                    request.tokens.append(token)
                    realized[slot] = realized.get(slot, 0) + 1
                    reason = self._finished(request, token)
                    if reason is not None:
                        self._complete(request, reason)
                        pool.release(slot)
                        del self._running[slot]
                    events.append((request, token, reason is not None))
            pool.note_advance_slots(realized)
            emitted = sum(realized.values())
            if block.k:
                self._note_spec_drain(block, tokens, realized)
            drain_span.note(tokens=emitted)
        return block.window, emitted

    def _note_spec_drain(self, block: _TokenBlock, tokens,
                         realized: Dict[int, int]) -> None:
        """Acceptance of one drained speculative block: per (pass, slot)
        the emitted-row count ``e`` means ``e - 1`` accepted drafts (an
        active pass emits its verified pending token first). Feeds the
        ``accept_len`` percentiles and counters, the draft-length EMA
        (``0.75 * ema + 0.25 * rate``), and the drafter's refresh of
        every slot that advanced."""
        mat = (tokens >= 0).reshape(block.h, block.k + 1, -1)
        e = mat.sum(axis=1)                      # [passes, slots]
        act = e >= 1
        passes = int(act.sum())
        accept_lens = (e[act] - 1).tolist()
        drafted = block.k * passes
        accepted = int(sum(accept_lens))
        if passes:
            self.metrics.record_spec(drafted, accept_lens)
            rate = accepted / drafted
            ema = self._accept_ema
            self._accept_ema = (rate if ema is None
                                else 0.75 * ema + 0.25 * rate)
        self._last_spec = (drafted, accepted, passes, block.k)
        if self._drafter is not None:
            for slot in realized:
                request = block.slots.get(slot)
                if request is not None:
                    self._drafter.note_history(
                        slot, list(request.prompt) + list(request.tokens))

    def step(self) -> List[Event]:
        """One engine iteration: expire overdue requests, admit (a whole
        prompt per free slot, or one chunk), launch a decode horizon at
        the active-length window (plus, in steady state, the next one),
        then read back exactly one token block, and journal the step's
        events. Returns ``(request, token, finished)`` events, admission
        first tokens included (a quarantined request emits none: read
        its ``state``/``error``). Whatever escapes takes the engine
        down: its health goes DEAD and the error propagates."""
        try:
            return self._step_inner()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            # engine-fatal: the flight ring goes to disk first (a
            # poisoned pool dumped it already)
            if not isinstance(e, PoolPoisonedError):
                graftscope.emit("engine.fatal", cat="fault",
                                error=type(e).__name__)
                graftscope.flight_dump(
                    f"engine step: {type(e).__name__}: {e}")
            self.health.to_dead(type(e).__name__)
            raise

    def _step_inner(self) -> List[Event]:
        self._expire_deadlines()
        events = self._admit()
        if self._running or self._blocks:
            t0 = time.perf_counter()
            if self._running and not self._blocks:
                self._dispatch()
            if self._overlap_ok():
                self._dispatch(overlapped=True)
            occupancy = self.pool.occupancy
            self._last_spec = None
            window, emitted = self._drain_one(events)
            dt = time.perf_counter() - t0
            self.metrics.record_decode_step(
                dt, emitted, occupancy, self.scheduler.queue_depth, window)
            if self._last_spec is not None:
                # waste_s: the step's wall apportioned to the rejected
                # verify rows (the goodput ledger's spec_waste)
                drafted, accepted, passes, k = self._last_spec
                rows = passes * (k + 1)
                waste = dt * (drafted - accepted) / rows if rows else 0.0
                graftscope.emit_span(
                    "spec.verify", dt, cat="serving", drafted=drafted,
                    accepted=accepted, passes=passes, waste_s=waste)
        if self.journal is not None and events:
            # one fsync'd batch a step, at the drain boundary the host
            # already synced; a journal failure is engine-fatal
            self.journal.note_events(events)
        return events

    @property
    def in_flight(self) -> int:
        """Work somewhere in the engine: queued, mid-chunked-prefill,
        decoding, or a launched but unread block (drive loops step
        until 0)."""
        return (self.scheduler.queue_depth + len(self._running)
                + (1 if self._pending is not None else 0)
                + (1 if self._blocks else 0))

    def run(self) -> Iterable[Event]:
        """Step until queue, pending prefill and pool drain, streaming
        token events."""
        while self.in_flight:
            yield from self.step()

    # ---- drain and redelivery --------------------------------------------
    def begin_drain(self, reason: str = "drain") -> None:
        """Flip the health machine to DRAINING (idempotent; host state
        only, so a signal handler may call it): admission closes and
        the drive loop finishes in-flight work through :meth:`drain`."""
        if self.health.state in (heal.DRAINING, heal.DEAD):
            return
        self.health.to_draining(reason)
        graftscope.emit("engine.draining", cat="serving", reason=reason,
                        in_flight=self.in_flight)

    def drain(self, deadline_s: Optional[float] = None) -> List[Event]:
        """Finish every in-flight request with admission closed, bounded
        by ``deadline_s``: past it, every unfinished request (queued,
        mid-chunked-prefill or running) is failed named
        (``DeadlineExceeded``, reason ``"drain"``), never dropped. The
        engine lands DEAD and its journal is compacted and closed (empty
        after a clean drain). Returns the steps' token events."""
        self.begin_drain("drain")
        t0 = time.perf_counter()
        events: List[Event] = []
        with graftscope.span("engine.drain", cat="serving",
                             deadline_s=deadline_s) as drain_span:
            overdue = 0
            while self.in_flight:
                if deadline_s is not None:
                    uids = self._decide("drain", lambda: (
                        self._unfinished_uids()
                        if time.perf_counter() - t0 > deadline_s
                        else None))
                    if uids is not None:
                        overdue = self._fail_unfinished(deadline_s, uids)
                        break
                events.extend(self.step())
            drain_span.note(drained=len(events), overdue=overdue)
        self.health.to_dead("drained")
        if self.journal is not None:
            self.journal.close()
        return events

    def _unfinished_uids(self) -> List:
        """Every uid in flight: queued, mid-chunked-prefill, running."""
        uids = [r.uid for r in self.scheduler._queue]
        if self._pending is not None:
            uids.append(self._pending.request.uid)
        uids.extend(r.uid for r in self._running.values())
        return uids

    def _fail_unfinished(self, deadline_s: float, uids) -> int:
        """The drain deadline: fail everything still in flight, named;
        ``uids`` (the deciding clock's) must be exactly that set, or the
        state left the deciding rank's and this raises. Launched blocks
        are dropped unread (their requests are failed and the pool dies
        with the engine); running slots are scrubbed as in any
        quarantine. Returns how many failed."""
        here = self._unfinished_uids()
        if sorted(map(str, here)) != sorted(map(str, uids)):
            raise RuntimeError(
                f"the drain deadline fails {sorted(map(str, uids))}, but "
                f"this engine holds {sorted(map(str, here))} in flight "
                "(its state left the deciding rank's)")
        self._blocks.clear()
        failed = 0

        def overdue_error(request, where):
            return DeadlineExceeded(
                f"request {request.uid} still {where} at the drain "
                f"deadline ({deadline_s:.3g}s): failed named, not "
                "silently dropped — resubmit to another replica (the "
                "journal records it terminal, so a restart will not "
                "double-serve it)")

        while True:
            request = self.scheduler.next_to_admit()
            if request is None:
                break
            self._quarantine(request, overdue_error(request, "queued"),
                             reason="drain")
            failed += 1
        pend = self._drop_pending()
        if pend is not None:
            self._quarantine(
                pend.request,
                overdue_error(pend.request, "mid-chunked-prefill"),
                reason="drain")
            failed += 1
        for slot, request in list(self._running.items()):
            self._quarantine(request, overdue_error(request, "running"),
                             reason="drain", slot=slot)
            failed += 1
        return failed

    def redeliver(self, entries,
                  events_out: Optional[list] = None) -> List[Request]:
        """Re-submit journaled unfinished requests (recovery after a
        restart): each :class:`~..runtime.heal.JournalEntry` re-enters
        admission under its original uid, so the journal appends
        nothing for it and verifies its already-emitted tokens as the
        greedy decode regenerates them. ``QueueFull`` from a bounded
        queue is absorbed by stepping the engine (the steps' events go
        to ``events_out`` when given); a closed admission raises.
        Returns the requests in journal order."""
        out: List[Request] = []
        for entry in entries:
            request = Request(entry.prompt, entry.max_new_tokens,
                              entry.eos_id, uid=entry.uid)
            while True:
                try:
                    self.enqueue(request)
                    break
                except QueueFull:
                    if not self.health.ready:
                        raise  # draining or dead: closed for good
                    events = self.step()
                    if events_out is not None:
                        events_out.extend(events)
            self.metrics.record_redelivery()
            graftscope.emit("request.redelivered", cat="request",
                            req=entry.uid,
                            replayed_tokens=len(entry.tokens))
            out.append(request)
        return out

    # ---- fleet seams -----------------------------------------------------
    def _check_fits(self, request: Request) -> int:
        length = len(request.prompt)
        if length < 1:
            raise ValueError("empty prompt")
        if length + request.max_new_tokens > self.pool.s_max:
            raise ValueError(
                f"prompt {length} + max_new_tokens "
                f"{request.max_new_tokens} exceeds the slot capacity "
                f"s_max={self.pool.s_max}")
        return length

    def prefill_detached(self, request: Request,
                         chunk: Optional[int] = None):
        """Run ONE request's prefill without touching this engine's pool
        (the prefill half of the fleet's prefill/decode split). Returns
        ``(tok0, k_pref, v_pref)``: the first token (a host int) and the
        standalone ``[L, 1, W, H, Dh]`` model-dtype block, freshly
        allocated for this call, from the same code admission runs: the
        whole-prompt prefill at the prompt's bucket, or with ``chunk``
        the ``[1, chunk]`` incremental prefill, its chunks back to back
        (a prefill replica has no decode to interleave with). The
        receiver splices the block at its own slot or pages
        (:meth:`admit_prefilled`), so a handed-off continuation is
        token-exact with a local admission. Faults take the admission
        sites and the bounded retry; what is left raises to the caller
        (there is no pool state to scrub)."""
        length = self._check_fits(request)
        model = self.model
        if chunk is None:
            def prefill_once():
                maybe_fault(_SITE_PREFILL)
                tok0, k_pref, v_pref = self._prefill(request.prompt, length)
                return int(self._fetch(tok0)), k_pref, v_pref

            with graftscope.span(
                    "serving.prefill", cat="serving", req=request.uid,
                    bucket=bucket_length(length, self.min_bucket,
                                         self.pool.s_max),
                    prompt_len=length, detached=True):
                return self._attempted(prefill_once)
        plan = PrefillPlan(request, int(chunk), self.min_bucket,
                           self.pool.s_max)
        shape = (model.num_layers, 1, plan.width, self.pool.heads,
                 model.head_dim)
        k_pref = torch.zeros(shape, dtype=model.dtype, device=model.device)
        v_pref = torch.zeros(shape, dtype=model.dtype, device=model.device)
        x, start = None, 0
        while not plan.done:
            start, valid, _ = plan.next_chunk()
            padded = np.zeros((1, plan.chunk), np.int64)
            padded[0, :valid] = request.prompt[start:start + valid]

            def chunk_once(p=padded, s=start):
                maybe_fault(_SITE_CHUNK)
                tokens = torch.from_numpy(p).to(model.device)
                x = _embed_at(model, tokens, s, model.dtype)
                for i in range(model.num_layers):
                    x = _block_chunk_prefill(
                        model.block(i), x, k_pref[i], v_pref[i], s,
                        self.pool.heads, model.dtype, model.ln_eps,
                        model.tp)
                return x

            with graftscope.span("serving.prefill_chunk", cat="serving",
                                 req=request.uid, start=start,
                                 chunk=plan.chunk, detached=True):
                x = self._attempted(chunk_once)
        idx = length - 1 - start

        def tok0_once():
            maybe_fault(_SITE_TOK0)
            logits = _logits(model, x[:, idx:idx + 1], model.ln_eps)[:, 0]
            t = _sample(logits, *self._sampling, self._generator)[0]
            return int(self._fetch(t))

        with graftscope.span("serving.prefill_tok0", cat="serving",
                             req=request.uid, detached=True):
            tok0 = self._attempted(tok0_once)
        return tok0, k_pref, v_pref

    def prefill_detached_wire(self, request: Request,
                              chunk: Optional[int] = None):
        """:meth:`prefill_detached` for the host transfer: ``(tok0,
        k_block, v_block, k_scale, v_scale)`` as numpy. An int8 engine's
        blocks leave already quantized (:func:`...ops.kv_quant.
        quantize_kv_np`, bit-equal to the device formula) with their f32
        scales; a model-dtype engine's scales are None. numpy has no
        bfloat16: a bf16 block travels as its raw bits, ``uint16``."""
        tok0, k_pref, v_pref = self.prefill_detached(request, chunk=chunk)
        if self._kv_quant:
            k_block, k_scale = quantize_kv_np(k_pref.float().cpu().numpy())
            v_block, v_scale = quantize_kv_np(v_pref.float().cpu().numpy())
            return tok0, k_block, v_block, k_scale, v_scale
        return tok0, _to_host(k_pref), _to_host(v_pref), None, None

    def prefill_detached_resident(self, request: Request,
                                  chunk: Optional[int] = None):
        """The :meth:`prefill_detached_wire` tuple with the blocks left
        on this engine's device (no host bounce): the same-process
        transfer. An int8 engine quantizes on the device with the
        formula its own splice runs (:func:`...ops.kv_quant.quantize_kv`),
        so the exported data and scales equal the host twin's bit for
        bit. The tensors are this call's own: nothing else writes them
        until the receiver has spliced them."""
        tok0, k_pref, v_pref = self.prefill_detached(request, chunk=chunk)
        if not self._kv_quant:
            return tok0, k_pref, v_pref, None, None
        qk, qv = self._attempted(
            lambda: (quantize_kv(k_pref), quantize_kv(v_pref)))
        return tok0, qk.data, qv.data, qk.scale, qv.scale

    def admit_prefilled(self, request: Request, tok0: int, k_pref,
                        v_pref, k_scale=None,
                        v_scale=None) -> List[Event]:
        """Splice a transferred prefill block into this engine (the
        decode half of the fleet's split). The blocks may be tensors on
        any device or host numpy (:meth:`prefill_detached_wire`'s); this
        engine picks a free slot, and on a paged pool fresh pages, and
        splices through the insert admission runs (:meth:`_insert`), so
        the continuation is token-exact with a local admission.

        Scales given: the block is already int8 and an int8 engine
        splices it as it is (bit-equal to the sender's); without scales
        an int8 engine quantizes at the splice; scales on a model-dtype
        engine are a ``ValueError``. Raises ``QueueFull`` when admission
        is closed, no slot is free or the page pool cannot cover the
        request after shedding prefix-cache entries (the router holds
        the transfer and retries), ``ValueError`` when it can never fit.
        The first token's events are returned and journaled like any
        admission."""
        if (k_scale is None) != (v_scale is None):
            raise ValueError("k_scale/v_scale must be given together")
        if k_scale is not None and not self._kv_quant:
            raise ValueError(
                "quantized transfer block offered to a model-dtype "
                "engine (kv_dtype='model'): dequantizing into a "
                "full-precision pool is forbidden — re-route to an "
                "int8 replica or resend unquantized")
        if not self.health.ready:
            self.metrics.record_shed()
            graftscope.emit("request.shed", cat="request", req=request.uid,
                            reason=self.health.state)
            raise QueueFull(
                f"admission closed: engine {self.health.state.upper()}"
                f" ({self.health.reason}); transfer to another replica")
        pool = self.pool
        length = self._check_fits(request)
        if pool.free_slots < 1:
            raise QueueFull(
                "no free slot for the transferred prefill; step this "
                "engine and retry (graftroute holds the transfer)")
        prep = None
        if self._paged:
            n_total = PagePool.pages_for(length + request.max_new_tokens,
                                         pool.page_size)
            if n_total > pool.num_pages - 1:
                raise ValueError(
                    f"transfer needs {n_total} page(s); the pool holds "
                    f"{pool.num_pages - 1} allocatable")
            while (pool.free_pages < n_total
                   and self._prefix_cache is not None
                   and self._prefix_cache.evict_lru()):
                pass  # shed cache before holding a transfer
            if pool.free_pages < n_total:
                self.metrics.record_page_hold()
                graftscope.emit("request.held", cat="request",
                                req=request.uid, pages_needed=n_total,
                                pages_free=pool.free_pages)
                raise QueueFull(
                    f"page pressure: transfer needs {n_total} page(s),"
                    f" {pool.free_pages} free — retry after running "
                    "work completes")
            prep = _PagedPrep("miss", None, 0, [],
                              pool.alloc_pages(n_total), None, n_total)
        if request.submit_time is None:
            request.submit_time = time.perf_counter()
        if self.journal is not None:
            self.journal.record_admit(request)
        request.state = RUNNING
        request.admit_time = time.perf_counter()
        self.metrics.record_admission(request.admit_time
                                      - request.submit_time)
        graftscope.emit("request.admit", cat="request", req=request.uid,
                        transfer=True,
                        queue_wait_s=request.admit_time
                        - request.submit_time)
        events: List[Event] = []
        try:
            slot = self._first_token(request, int(tok0), events)
        except BaseException:
            self._abort_prep(prep)  # its fresh pages have no owner yet
            raise
        if slot is None:  # finished at its (transferred) first token
            self._abort_prep(prep)
        else:
            try:
                device = self.model.device
                k_dev = _to_device(k_pref, self.model.dtype, device)
                v_dev = _to_device(v_pref, self.model.dtype, device)
                if k_scale is not None:
                    k_dev = QuantizedKV(k_dev, _to_device(
                        k_scale, torch.float32, device))
                    v_dev = QuantizedKV(v_dev, _to_device(
                        v_scale, torch.float32, device))
                self._insert(request, slot, k_dev, v_dev, length,
                             int(tok0), prep=prep)
            except Exception as e:
                self._abort_prep(prep)
                self._poisoned(request, e, slot=slot)
        if self.journal is not None and events:
            self.journal.note_events(events)
        return events

    def withdraw(self, uid) -> bool:
        """Abandon one request now, wherever it is (queued,
        mid-chunked-prefill or running): it leaves FAILED with reason
        ``"withdraw"`` and a :class:`~.scheduler.RequestWithdrawn`
        error, through the quarantine (a running slot scrubbed, its
        pages returned, the journal's entry terminal); every other
        slot's stream is untouched. Returns True when ``uid`` was
        found."""
        err = RequestWithdrawn(f"request {uid} withdrawn by its client")
        for slot, request in list(self._running.items()):
            if request.uid == uid:
                self._quarantine(request, err, reason="withdraw",
                                 slot=slot)
                return True
        pend = self._pending
        if pend is not None and pend.request.uid == uid:
            self._drop_pending()
            self._quarantine(pend.request, err, reason="withdraw")
            return True
        request = self.scheduler.withdraw_uid(uid)
        if request is not None:
            self._quarantine(request, err, reason="withdraw")
            return True
        return False

    def withdraw_queued(self, max_n: int = 1) -> List[Request]:
        """Hand up to ``max_n`` QUEUED requests, from the queue tail,
        back to the router for a peer (work stealing). The router
        journals the handoff only once the peer accepts."""
        out: List[Request] = []
        for _ in range(max_n):
            request = self.scheduler.withdraw_tail()
            if request is None:
                break
            graftscope.emit("request.stolen", cat="request",
                            req=request.uid)
            out.append(request)
        return out

    def hard_reclaim(self) -> None:
        """Release every slot, page, pending prefill buffer and launched
        token block this engine holds, without touching request state:
        the in-process twin of a killed process's memory going back.
        The router calls it at a replica's reap, whose requests are
        then redelivered from the journal or its records. Idempotent."""
        self._blocks.clear()
        if self._pending is not None:
            self._drop_pending()
        for slot in list(self._running):
            self._scrub_slot(slot)
            del self._running[slot]
            self.pool.release(slot)

    def serve(self, requests: Iterable[Tuple[Sequence[int], int]]
              ) -> List[Request]:
        """Submit ``(prompt, max_new_tokens)`` pairs, run to drain, and
        return the ``Request`` records in submission order."""
        submitted = [self.submit(p, n) for p, n in requests]
        for _ in self.run():
            pass
        if any(r.state != DONE for r in submitted):
            raise RuntimeError("serve() drained with unfinished requests")
        return submitted
