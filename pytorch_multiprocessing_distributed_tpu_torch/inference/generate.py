"""KV-cached autoregressive generation for the GPT family.

The port of the JAX package's ``inference/generate.py``, dense
single-shard subset: prefill is one causal pass over the prompt, decode
is :func:`_decode_horizon` — the shared decode body that both
:func:`generate` and the serving engine run, so the two cannot drift.
``lax.scan`` becomes a Python loop: PyTorch launches eagerly and the
card runs ahead of the host, with no host read inside the loop (the
eos/budget freeze gates are tensor ops on the device).

KV caches (``[L, N, S, H, Dh]``) are written IN PLACE where the JAX
code returned updated arrays: each decode step index-assigns its new
K/V column into the caller's cache tensor.

The decode body also serves the engine's paged caches (a page table
maps each slot's columns onto ``[L, P, H, page_size, Dh]`` pages) and
int8 caches (:class:`...ops.kv_quant.QuantizedKV`: the fresh K/V of each
step are quantized before the write), and :func:`_block_chunk_prefill`
is the engine's chunked prefill. :func:`teacher_forced_logits` runs a
fixed transcript through either cache dtype.

Speculative decode (``_decode_horizon(..., draft_k=k)``, the JAX
package's graftspec): each pass proposes ``k`` tokens per row (from a
per-slot n-gram table, or a small draft GPT run ``k + 1`` cached
steps), verifies them with ONE ``k + 1``-query target pass
(:func:`_block_verify_slots`, on the verify attention kernels), and
accepts the leading matches with tensor ops on the device.

An MoE model decodes droplessly (JAX ``_moe_ffn``): the blocks' shared
feed-forward, :func:`..models.gpt._ffn`, runs every expert on every
token and keeps each token's top-k, in the prefill, the decode steps,
the verify passes and the chunked prefill alike.

Tensor-parallel decode (``generate(..., mesh=grid)``, the engine's
``mesh``): each rank of a ``(1, M)`` grid runs these same helpers on its
shard (:mod:`.tp`, ``model.tp``): its ``H / M`` heads against its head
shard of the caches, its columns of every Dense output gathered where
the next op needs every channel (:func:`..models.gpt._cols`).

Ragged batches (``generate(..., prompt_lengths=)``, JAX's): each row is
left-padded to the common length; the prefill masks the pad columns
(:func:`..models.gpt._block_prefill`'s ``kv_valid``), positions restart
at each row's first real token, and every decode step passes the rows'
pad widths to the decode kernel as its first valid columns
(``decode_attention(..., starts=)``), which never reads the pad.

:func:`beam_search` is JAX's log-probability beam search over the same
prefill and decode body: the caches tiled per beam, each step one
decode pass over every beam, then the caches reordered by the surviving
parents.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gpt import (_block_prefill, _cols, _dense, _embed, _ffn,
                          _ln, _logits, _split_heads)
from ..ops.decode_attention import (decode_attention,
                                    paged_decode_attention,
                                    paged_verify_decode_attention,
                                    verify_decode_attention)
from ..ops.kv_quant import QuantizedKV, kv_slice_in_dim, quantize_kv
from .tp import check_mesh, local_heads, shard_params_for_tp_decode

__all__ = ["generate", "beam_search", "teacher_forced_logits",
           "draft_bucket",
           "DRAFT_HASH_PRIME", "generate_kv_bytes", "register_generate_hbm"]

# Knuth multiplicative constant of the draft-table hash: one formula for
# the host tables (``serving.spec.ngram_bucket``, numpy uint32)
# and the device lookup (:func:`draft_bucket`), as in the JAX package
DRAFT_HASH_PRIME = 2654435761


def _write_kv(cache, index, new):
    """``cache[index] = new`` on a cache that may be quantized (the
    fresh K/V are quantized over Dh and both parts written)."""
    if isinstance(cache, QuantizedKV):
        qn = quantize_kv(new)
        cache.data[index] = qn.data
        cache.scale[index] = qn.scale
    else:
        cache[index] = new


def _block_decode_slots(p, x_t, k_cache, v_cache, positions, h, dtype,
                        eps, window=None, attn_impl="auto",
                        page_table=None, page_size=None, tp=None,
                        starts=None):
    """One cached step for every slot: ``x_t`` ``[N, 1, D]``; caches
    ``[N, S, H, Dh]`` (one layer). Row ``j`` writes its K/V at its own
    column ``positions[j]`` of the FULL cache (in place; a frozen row's
    position may lie beyond the window and re-writes its own column),
    then attends over the window view ``[0, window)`` through
    :func:`..ops.decode_attention.decode_attention`.

    Paged mode (``page_table`` ``[N, pages_per_slot]`` int32 and
    ``page_size``): the caches are one layer's pages ``[P, H, ps, Dh]``
    and column ``c`` of row ``j`` lives at ``(page_table[j, c // ps],
    c % ps)``. The write goes through the table (a released slot's row
    is all scratch page 0, so its frozen re-write lands there), and the
    attention reads the first ``ceil(window / ps)`` table entries
    through :func:`..ops.decode_attention.paged_decode_attention`.
    Either cache may be a :class:`...ops.kv_quant.QuantizedKV`.

    ``tp``: a rank's shard (:mod:`.tp`): ``h`` and the caches hold its
    heads, and attention's and ``wo``'s outputs are gathered.

    ``starts`` (``[N]`` int32, dense model-dtype caches): row ``j``
    attends ``[starts[j], positions[j]]``, a ragged batch's row without
    its left padding."""
    n, _, d = x_t.shape
    hn = _ln(x_t, p.ln1, eps).to(dtype)
    q, k, v = _dense(hn, p.attn.wqkv, dtype).chunk(3, dim=-1)
    q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    rows = torch.arange(n, device=x_t.device)
    cols = positions.long()
    if page_table is not None:
        if starts is not None:
            raise ValueError("starts (ragged rows) composes only with "
                             "dense caches")
        ps = int(page_size)
        index = (page_table[rows, cols // ps].long(), slice(None),
                 cols % ps)
        _write_kv(k_cache, index, k[:, 0])
        _write_kv(v_cache, index, v[:, 0])
        n_win = (-(-int(window) // ps) if window is not None
                 else page_table.shape[1])
        att = paged_decode_attention(
            q, k_cache, v_cache, page_table[:, :n_win], positions,
            window=window, impl=attn_impl)
    else:
        _write_kv(k_cache, (rows, cols), k[:, 0])
        _write_kv(v_cache, (rows, cols), v[:, 0])
        if window is not None and window < k_cache.shape[1]:
            k_win = kv_slice_in_dim(k_cache, 0, window, axis=1)
            v_win = kv_slice_in_dim(v_cache, 0, window, axis=1)
        else:
            k_win, v_win = k_cache, v_cache
        att = decode_attention(q, k_win, v_win, positions, starts=starts,
                               impl=attn_impl)
    att = _cols(att.reshape(n, 1, -1).to(dtype), d, tp)
    x_t = x_t + _cols(_dense(att, p.attn.wo, dtype), d, tp)
    return x_t + _ffn(p, x_t, dtype, eps, tp)


def draft_bucket(tokens: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Draft-table bucket of each token id: ``uint32(t * PRIME) %
    n_buckets``. torch has no uint32 arithmetic on every device, so the
    product is taken in int64 (exact for ids below 2^31) and masked to
    its low 32 bits."""
    t = (tokens.to(torch.int64) * DRAFT_HASH_PRIME) & 0xFFFFFFFF
    return (t % int(n_buckets)).to(torch.int32)


def _block_verify_slots(p, x_t, k_cache, v_cache, positions, h, dtype,
                        eps, window=None, attn_impl="auto",
                        page_table=None, page_size=None, tp=None):
    """k-query verify variant of :func:`_block_decode_slots`: ``x_t`` is
    ``[N, K1, D]``, each row's pending token plus its ``K1 - 1`` drafts.
    Row ``i``'s K/V is written at column ``positions + i`` (all K1
    columns, before the attention, so later rows see earlier rows'
    keys), then row ``i`` attends ``[0, positions + i]`` through
    :func:`..ops.decode_attention.verify_decode_attention` (or its paged
    twin).

    Columns past a row's accepted frontier hold rejected drafts; every
    later read masks them until the frontier's own write replaces them.
    Writes past the end of the sequence: dense caches carry ``K1 - 1``
    spare columns past ``s_max`` (the engine allocates them), where such
    writes land and are never read (the JAX package drops them); a
    paged write whose block lies past the table goes to the scratch page
    0, as in the JAX package, so a draft never touches another tenant's
    page or a shared prefix page. ``tp``: as in
    :func:`_block_decode_slots`."""
    n, k1, d = x_t.shape
    hn = _ln(x_t, p.ln1, eps).to(dtype)
    q, k, v = _dense(hn, p.attn.wqkv, dtype).chunk(3, dim=-1)
    q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    cols = (positions.long()[:, None]
            + torch.arange(k1, device=x_t.device)[None, :])  # [N, K1]
    if page_table is not None:
        ps = int(page_size)
        blk = cols // ps
        n_tab = page_table.shape[1]
        ids = torch.gather(page_table, 1, blk.clamp(max=n_tab - 1)).long()
        ids = torch.where(blk < n_tab, ids, torch.zeros_like(ids))
        index = (ids, slice(None), cols % ps)
        _write_kv(k_cache, index, k)
        _write_kv(v_cache, index, v)
        n_win = (-(-int(window) // ps) if window is not None
                 else page_table.shape[1])
        att = paged_verify_decode_attention(
            q, k_cache, v_cache, page_table[:, :n_win], positions,
            window=window, impl=attn_impl)
    else:
        rows = torch.arange(n, device=x_t.device)[:, None]
        _write_kv(k_cache, (rows, cols), k)
        _write_kv(v_cache, (rows, cols), v)
        if window is not None and window < k_cache.shape[1]:
            k_win = kv_slice_in_dim(k_cache, 0, window, axis=1)
            v_win = kv_slice_in_dim(v_cache, 0, window, axis=1)
        else:
            k_win, v_win = k_cache, v_cache
        att = verify_decode_attention(q, k_win, v_win, positions,
                                      impl=attn_impl)
    att = _cols(att.reshape(n, k1, -1).to(dtype), d, tp)
    x_t = x_t + _cols(_dense(att, p.attn.wo, dtype), d, tp)
    return x_t + _ffn(p, x_t, dtype, eps, tp)


def _filter_logits(logits, temperature: float, top_k: int,
                   top_p: float):
    """The logits a draw is made from: divided by ``temperature``, then
    top-k, then nucleus top-p (dropped tokens at ``-inf``)."""
    logits = logits / temperature
    if top_k:
        kth = logits.sort(dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p and top_p < 1.0:
        # nucleus: the smallest prefix of probability-sorted tokens
        # whose mass reaches top_p (the top token always stays; ties at
        # the cut are kept together)
        probs = torch.softmax(logits, dim=-1)
        sorted_p = probs.sort(dim=-1, descending=True).values
        before = sorted_p.cumsum(dim=-1) - sorted_p
        cut = torch.where(before < top_p, sorted_p,
                          torch.full_like(sorted_p, float("inf")))
        cut = cut.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(probs < cut, float("-inf"))
    return logits


def _sample(logits, temperature: float, top_k: int, top_p: float,
            generator: Optional[torch.Generator]):
    """``[B, V]`` logits -> ``[B]`` tokens (greedy when temperature is
    0; otherwise a draw from :func:`_filter_logits`'s logits with
    ``generator``)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k,
                                         top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _decode_horizon(model, k_caches, v_caches, positions, last_tokens,
                    active, remaining, eos_ids, horizon: int, *,
                    window: Optional[int] = None, attn_impl: str = "auto",
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    page_table: Optional[torch.Tensor] = None,
                    page_size: Optional[int] = None, draft_k: int = 0,
                    draft_table: Optional[torch.Tensor] = None,
                    draft_model=None, draft_k_caches=None,
                    draft_v_caches=None,
                    offsets: Optional[torch.Tensor] = None):
    """``horizon`` cached decode steps over every row, with the freeze
    gates on the device: a row whose sampled token is its ``eos_ids``
    entry, or whose ``remaining`` budget reaches zero, emits that final
    token and freezes (position pinned, pending token unchanged, ``-1``
    emitted from then on, no budget consumed).

    Args:
      model: the bound ``GPT``, or a rank's tensor-parallel shard
        (``model.tp``; its caches hold its ``H / M`` heads).
      k_caches, v_caches: ``[L, N, S, H, Dh]`` caches, written in place.
      positions: ``[N]`` int32 next write column per row.
      last_tokens: ``[N]`` int32 pending tokens.
      active: ``[N]`` bool; remaining: ``[N]`` int32 budgets; eos_ids:
        ``[N]`` int32 stop tokens (``-1`` = none).
      window: attention prefix ``[0, window)`` (None = the whole cache).
      page_table / page_size: paged mode — the caches are ``[L, P, H,
        page_size, Dh]`` pages and ``page_table`` ``[N,
        pages_per_slot]`` int32 maps each row's columns onto them (read
        only here). See :func:`_block_decode_slots`.
      draft_k: > 0 arms speculative decode: each of the ``horizon``
        passes proposes ``draft_k`` tokens per row, verifies them with
        one ``draft_k + 1``-query target pass and emits the verified
        prefix (1 to ``draft_k + 1`` tokens per active row), with the
        same freeze gates. Greedy only. Dense caches need ``draft_k``
        spare columns past the last column a row can hold (see
        :func:`_block_verify_slots`).
      draft_table: self-drafting — ``[N, buckets, draft_k]`` int32
        n-gram tables (``-1`` = no proposal, never accepted), looked up
        by :func:`draft_bucket` on each pass's pending token.
      draft_model / draft_k_caches / draft_v_caches: draft-model mode —
        a bound GPT proposing the tokens autoregressively against its
        own dense ``[L_d, N, S + draft_k, H_d, Dh_d]`` caches (written in
        place; the last ``draft_k`` columns are spare, as above).
      offsets: ``[N]`` int32 left-pad widths of a ragged ``generate``
        batch (dense caches, no speculation): position-embedding ids
        become ``max(positions - offsets, 0)``, and row ``j``'s
        attention starts at column ``offsets[j]``.

    Returns ``(tokens [horizon, N] int32, (positions, last_tokens,
    active, remaining))``; with ``draft_k`` the block is ``[horizon *
    (draft_k + 1), N]``, step-major (pass ``j``'s ``draft_k + 1``
    emission rows, then pass ``j + 1``'s), ``-1`` marking rejected or
    frozen rows.
    """
    if draft_k:
        if temperature > 0.0:
            raise ValueError(
                "speculative decode (draft_k > 0) is greedy-only: a "
                "sampled stream cannot be verified by argmax matching "
                "(temperature > 0)")
        if (draft_table is None) == (draft_model is None):
            raise ValueError(
                "draft_k > 0 needs exactly one draft source: "
                "draft_table (self-drafting) or draft_model (+ its "
                "caches)")
        if offsets is not None:
            raise ValueError(
                "speculative decode composes with no ragged offsets "
                "(serving slots only)")
        return _decode_horizon_spec(
            model, k_caches, v_caches, positions, last_tokens, active,
            remaining, eos_ids, horizon, window=window,
            attn_impl=attn_impl, page_table=page_table,
            page_size=page_size, draft_k=int(draft_k),
            draft_table=draft_table, draft_model=draft_model,
            draft_k_caches=draft_k_caches, draft_v_caches=draft_v_caches)
    dtype, eps, h, tp = model.dtype, model.ln_eps, local_heads(model), \
        model.tp
    emitted_steps = []
    for _ in range(horizon):
        ids = (positions if offsets is None
               else (positions - offsets).clamp(min=0))
        x_t = _cols(model.embed[last_tokens][:, None, :].to(dtype)
                    + model.pos_embed[ids][:, None, :].to(dtype),
                    model.hidden_size, tp)
        for i in range(model.num_layers):
            x_t = _block_decode_slots(
                model.block(i), x_t, k_caches[i], v_caches[i], positions,
                h, dtype, eps, window=window, attn_impl=attn_impl,
                page_table=page_table, page_size=page_size, tp=tp,
                starts=offsets)
        logits = _logits(model, x_t, eps)[:, 0]
        nxt = _sample(logits, temperature, top_k, top_p,
                      generator).to(torch.int32)
        # the finishing token IS emitted, then the row freezes
        emitted_steps.append(torch.where(active, nxt,
                                         torch.full_like(nxt, -1)))
        remaining = torch.where(active, remaining - 1, remaining)
        finished = active & ((nxt == eos_ids) | (remaining <= 0))
        positions = torch.where(active, positions + 1, positions)
        last_tokens = torch.where(active, nxt, last_tokens)
        active = active & ~finished
    return (torch.stack(emitted_steps),
            (positions, last_tokens, active, remaining))


def _draft_with_model(draft, dk, dv, positions, last_tokens, kk: int,
                      attn_impl: str):
    """``kk + 1`` cached greedy steps of the draft model from each
    row's pending token (the last step only fills the draft cache's
    column ``position + kk``, so full acceptance leaves no gap for the
    next pass to read stale data through). The draft attends the first
    ``S`` columns of its ``S + kk``-wide caches, and position-embedding
    ids are clipped into its table, as in the JAX package. Returns the
    first ``kk`` outputs, ``[N, kk]`` int32."""
    d_dtype, d_eps, d_h = draft.dtype, draft.ln_eps, draft.num_heads
    pe = draft.pos_embed
    window = dk.shape[2] - kk
    t, p_d, toks = last_tokens, positions, []
    for step in range(kk + 1):
        ids = p_d.clamp(0, pe.shape[0] - 1)
        x_d = (draft.embed[t][:, None, :].to(d_dtype)
               + pe[ids][:, None, :].to(d_dtype))
        for i in range(draft.num_layers):
            x_d = _block_decode_slots(draft.block(i), x_d, dk[i], dv[i],
                                      p_d, d_h, d_dtype, d_eps,
                                      window=window, attn_impl=attn_impl)
        if step < kk:  # the last step's token is never proposed
            t = _logits(draft, x_d, d_eps)[:, 0].argmax(dim=-1).to(
                torch.int32)
            toks.append(t)
        p_d = p_d + 1
    return torch.stack(toks, dim=1)


def _decode_horizon_spec(model, k_caches, v_caches, positions,
                         last_tokens, active, remaining, eos_ids,
                         horizon: int, *, window, attn_impl, page_table,
                         page_size, draft_k: int, draft_table, draft_model,
                         draft_k_caches, draft_v_caches):
    """The speculative body of :func:`_decode_horizon`: ``horizon``
    draft-then-verify passes. Per pass and row: propose ``k`` tokens,
    run one ``k + 1``-query target pass over the pending token and the
    drafts, take the target's greedy outputs ``g_0 .. g_k`` and emit
    ``g_i`` iff every draft before it matched, the row is active, ``i <
    remaining`` and no earlier ``g_j`` was the stop token — the tokens
    ``i`` single greedy steps would have emitted, with the same freeze
    gates. The acceptance is tensor ops on the device (cumprod of the
    matches, a cumsum for the stop token, a gather): no host read, no
    shape that depends on it."""
    dtype, eps, h, tp = model.dtype, model.ln_eps, local_heads(model), \
        model.tp
    kk, vocab, n = draft_k, model.vocab_size, positions.shape[0]
    dev = positions.device
    steps = torch.arange(kk + 1, device=dev)
    row_ids = torch.arange(n, device=dev)
    pe = model.pos_embed
    emitted_steps = []
    for _ in range(horizon):
        if draft_model is not None:
            drafts = _draft_with_model(draft_model, draft_k_caches,
                                       draft_v_caches, positions,
                                       last_tokens, kk, attn_impl)
            draft_ok = torch.ones_like(drafts, dtype=torch.bool)
        else:
            bucket = draft_bucket(last_tokens, draft_table.shape[1])
            drafts = draft_table[row_ids, bucket.long()]      # [N, k]
            draft_ok = drafts >= 0  # -1 = no proposal, never accepted
        drafts = torch.where(draft_ok, drafts.clamp(0, vocab - 1),
                             torch.zeros_like(drafts))

        # verify: one (k+1)-query target pass
        qtok = torch.cat([last_tokens[:, None], drafts], dim=1)
        cols = positions.long()[:, None] + steps[None, :]
        ids = cols.clamp(0, pe.shape[0] - 1)
        x_t = _cols(model.embed[qtok].to(dtype) + pe[ids].to(dtype),
                    model.hidden_size, tp)
        for i in range(model.num_layers):
            x_t = _block_verify_slots(
                model.block(i), x_t, k_caches[i], v_caches[i], positions,
                h, dtype, eps, window=window, attn_impl=attn_impl,
                page_table=page_table, page_size=page_size, tp=tp)
        greedy = _logits(model, x_t, eps).argmax(dim=-1).to(torch.int32)

        # greedy acceptance, composed with the freeze gates
        match = (drafts == greedy[:, :kk]) & draft_ok
        accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        is_eos = greedy == eos_ids[:, None]
        eos_i = is_eos.to(torch.int32)
        eos_before = eos_i.cumsum(dim=1) - eos_i
        can = ((steps[None, :] <= accepted[:, None])
               & (steps[None, :] < remaining[:, None])
               & (eos_before == 0) & active[:, None])
        e = can.sum(dim=1, dtype=torch.int32)                 # [N] emitted
        emitted_steps.append(torch.where(can, greedy,
                                         torch.full_like(greedy, -1)))
        last = greedy.gather(1, (e.long() - 1).clamp(min=0)[:, None])[:, 0]
        last_tokens = torch.where(e > 0, last, last_tokens)
        remaining = remaining - e
        hit_eos = (can & is_eos).any(dim=1)
        finished = active & (hit_eos | (remaining <= 0))
        positions = positions + e
        active = active & ~finished
    # [H, N, k+1] -> [H * (k+1), N], step-major
    tokens = torch.stack(emitted_steps).permute(0, 2, 1).reshape(-1, n)
    return tokens, (positions, last_tokens, active, remaining)


def _prefill(model, prompt, s_max: int, offsets=None):
    """One causal pass over ``prompt`` ``[B, T]``; returns ``(x,
    k_caches, v_caches)`` with caches ``[L, B, s_max, H, Dh]`` written on
    ``[0, T)`` (a shard's ``H / M`` heads). ONE copy shared by
    :func:`generate` and :func:`beam_search`, as in JAX. ``offsets``
    (``[B]``): a left-padded ragged batch's pad widths (positions
    re-based, pad columns masked)."""
    b, t = prompt.shape
    dtype, h = model.dtype, local_heads(model)
    shape = (model.num_layers, b, s_max, h, model.head_dim)
    k_caches = torch.zeros(shape, dtype=dtype, device=prompt.device)
    v_caches = torch.zeros(shape, dtype=dtype, device=prompt.device)
    kv_valid = (None if offsets is None else
                torch.arange(t, device=prompt.device)[None, :]
                >= offsets.long()[:, None])
    x = _embed(model, prompt, dtype, offsets)
    for i in range(model.num_layers):
        x, k, v = _block_prefill(model.block(i), x, h, dtype, model.ln_eps,
                                 model.tp, kv_valid)
        k_caches[i, :, :t] = k
        v_caches[i, :, :t] = v
    return x, k_caches, v_caches


def _block_chunk_prefill(p, x, k_cache, v_cache, start: int, h: int,
                         dtype, eps, tp=None):
    """One chunk of an incremental prefill: ``x`` ``[B, C, D]`` holds
    the prompt tokens at positions ``[start, start + C)``;
    ``k_cache``/``v_cache`` ``[B, W, H, Dh]`` hold the prefix columns
    ``[0, start)``. Writes this chunk's K/V at ``[start, start + C)`` (in
    place) and attends row ``r`` to columns ``[0, start + r]`` — the
    causal set :func:`_block_prefill` gives that token, so chunked and
    whole-prompt prefill agree. Right-pad rows of a last partial chunk
    write columns past the prompt, which stay masked until decode
    overwrites them. ``tp``: as in :func:`_block_decode_slots`."""
    b, c, d = x.shape
    hn = _ln(x, p.ln1, eps).to(dtype)
    q, k, v = _dense(hn, p.attn.wqkv, dtype).chunk(3, dim=-1)
    q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    k_cache[:, start:start + c] = k
    v_cache[:, start:start + c] = v
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale  # [B, H, C, W]
    w = k_cache.shape[1]
    mask = (torch.arange(w, device=x.device)[None, :]
            <= start + torch.arange(c, device=x.device)[:, None])
    probs = torch.softmax(
        logits.masked_fill(~mask[None, None], float("-inf")), dim=-1)
    att = torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.float())
    att = _cols(att.reshape(b, c, -1).to(dtype), d, tp)
    x = x + _cols(_dense(att, p.attn.wo, dtype), d, tp)
    return x + _ffn(p, x, dtype, eps, tp)


def _embed_at(model, tokens, start: int, dtype):
    """Embed ``tokens`` ``[B, C]`` at positions ``start + r``, position
    ids clamped into the table (pad rows past the prompt may lie beyond
    ``max_seq_len``; they are never attended to)."""
    c = tokens.shape[1]
    ids = torch.clamp(start + torch.arange(c, device=tokens.device), 0,
                      model.pos_embed.shape[0] - 1)
    return _cols(model.embed[tokens].to(dtype)
                 + model.pos_embed[ids][None].to(dtype), model.hidden_size,
                 model.tp)


def generate(model, prompt: torch.Tensor, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             attn_impl: str = "auto", mesh=None,
             prompt_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt``.

    Args:
      model: the bound ``GPT`` (its params' device is where this runs).
      prompt: ``[B, T]`` int tokens on the model's device,
        ``T + max_new_tokens <= model.max_seq_len``.
      temperature: 0 = greedy; else softmax temperature sampling.
      top_k / top_p: restrict sampling (0 = off).
      generator: a ``torch.Generator`` on the model's device (required
        when sampling).
      attn_impl: decode attention, ``auto`` | ``cuda`` | ``torch``.
      mesh: a ``(1, M)`` grid with a ``model`` axis
        (:func:`..parallel.mesh.make_grid`), on every rank of it:
        tensor-parallel decode on this rank's shard of ``model``
        (:func:`.tp.shard_params_for_tp_decode`; a shard is taken as it
        is). ``M`` must divide the heads. The same tokens as the
        single-shard path, on every rank.
      prompt_lengths: optional ``[B]`` ints for a RAGGED batch: row
        ``i`` is LEFT-padded to ``T`` with its real tokens in columns
        ``[T - L_i, T)`` (any pad id: pad columns are never attended
        and get clamped positions). Row ``i`` then generates exactly
        what a one-row call on its unpadded prompt would. Caller
        contract, as in JAX: ``1 <= L_i <= T`` (not validated).

    Returns ``[B, T + max_new_tokens]`` tokens (prompt included).
    """
    b, t = prompt.shape
    s_max = t + max_new_tokens
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_k < 0 or top_k > model.vocab_size:
        raise ValueError(
            f"top_k must be in [0, vocab_size={model.vocab_size}], got "
            f"{top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if s_max > model.max_seq_len:
        raise ValueError(
            f"prompt {t} + max_new_tokens {max_new_tokens} exceeds "
            f"max_seq_len={model.max_seq_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    if getattr(model, "seq_axis", None) is not None:
        raise NotImplementedError(
            "generate wants the dense view of an SP model — pass "
            "model.clone(seq_axis=None) (the params are identical; "
            "train_lm.py --sample does this)")
    if mesh is not None:
        check_mesh(mesh, model.num_heads, "TP decode")
        model = shard_params_for_tp_decode(model, mesh)
    offsets = None
    if prompt_lengths is not None:
        prompt_lengths = torch.as_tensor(prompt_lengths,
                                         device=prompt.device)
        if tuple(prompt_lengths.shape) != (b,):
            raise ValueError(
                f"prompt_lengths must have shape ({b},), got "
                f"{tuple(prompt_lengths.shape)}")
        offsets = (t - prompt_lengths).to(torch.int32).contiguous()
    x, k_caches, v_caches = _prefill(model, prompt, s_max, offsets)
    first_logits = _logits(model, x[:, -1:], model.ln_eps)[:, 0]
    tok0 = _sample(first_logits, temperature, top_k, top_p,
                   generator).to(torch.int32)
    generated = tok0[:, None]
    if max_new_tokens > 1:
        dev = prompt.device
        toks, _ = _decode_horizon(
            model, k_caches, v_caches,
            torch.full((b,), t, dtype=torch.int32, device=dev), tok0,
            torch.ones(b, dtype=torch.bool, device=dev),
            torch.full((b,), max_new_tokens, dtype=torch.int32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev),
            max_new_tokens - 1, attn_impl=attn_impl,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator, offsets=offsets)
        generated = torch.cat([generated, toks.T], dim=1)
    return torch.cat([prompt, generated.to(prompt.dtype)], dim=1)


def _top_k(x, k: int, tie=None):
    """The ``k`` largest entries of each row of ``x`` and their indices,
    best first. A tie goes to the larger entry of ``tie`` where given,
    then to the lower index, as ``jax.lax.top_k`` breaks it
    (``torch.topk`` promises no order): stable descending sorts, the
    last key first."""
    if tie is None:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    order = torch.sort(tie, dim=-1, descending=True, stable=True).indices
    vals, at = torch.sort(x.gather(-1, order), dim=-1, descending=True,
                          stable=True)
    return vals[:, :k], order.gather(-1, at[:, :k])


def beam_search(model, prompt: torch.Tensor, *, max_new_tokens: int,
                beam_size: int, attn_impl: str = "auto"):
    """Beam-search decoding over the same KV-cached machinery (JAX's
    ``beam_search``).

    Log-probability beam search with no length penalty: a beam's score
    is its summed token log-probs. ``beam_size=1`` is greedy
    :func:`generate` exactly; ``beam_size >= V ** (max_new_tokens - 1)``
    is exhaustive. Two candidates whose f32 scores are equal rank by
    their next-token logits, then by index: where a beam's running score
    rounds two tokens' log-probs to one sum, JAX's ``lax.top_k`` takes
    the lower index and can part from greedy decoding; here one beam
    stays the argmax of the logits. Elsewhere the beams are JAX's.

    Args:
      model: the bound ``GPT`` (dense or MoE; an SP model's dense
        clone).
      prompt: ``[B, T]`` int tokens (uniform length) on the model's
        device.
      max_new_tokens: tokens each beam generates.
      beam_size: beams kept per batch row, in ``[1, vocab_size]``.
      attn_impl: decode attention, ``auto`` | ``cuda`` | ``torch``.

    Returns ``(tokens, scores)``: ``tokens`` ``[B, K, T +
    max_new_tokens]`` (prompt included), ``scores`` ``[B, K]`` f32
    summed log-probs, both best first along K.
    """
    b, t = prompt.shape
    s_max = t + max_new_tokens
    k_beams = int(beam_size)
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if k_beams < 1 or k_beams > model.vocab_size:
        raise ValueError(
            f"beam_size must be in [1, vocab_size={model.vocab_size}], "
            f"got {k_beams}")
    if s_max > model.max_seq_len:
        raise ValueError(
            f"prompt {t} + max_new_tokens {max_new_tokens} exceeds "
            f"max_seq_len={model.max_seq_len}")
    if getattr(model, "seq_axis", None) is not None:
        raise NotImplementedError(
            "beam_search wants the dense view of an SP model — pass "
            "model.clone(seq_axis=None)")
    dtype, eps, h = model.dtype, model.ln_eps, model.num_heads
    v_size, dev = model.vocab_size, prompt.device

    # prefill once on the B prompts (the pass generate runs)
    x, k_caches, v_caches = _prefill(model, prompt, s_max)
    logits = _logits(model, x[:, -1:], eps)[:, 0]
    # seed K beams from the top-K first tokens; caches tiled per beam,
    # row b * K + j = beam j of prompt b
    scores, tok = _top_k(torch.log_softmax(logits, dim=-1), k_beams,
                         tie=logits)
    k_caches = k_caches.repeat_interleave(k_beams, dim=1)
    v_caches = v_caches.repeat_interleave(k_beams, dim=1)
    history = torch.zeros((b, k_beams, max_new_tokens), dtype=torch.long,
                          device=dev)
    history[:, :, 0] = tok
    rows = torch.arange(b, device=dev)[:, None] * k_beams
    for j in range(1, max_new_tokens):
        pos = t + j - 1
        positions = torch.full((b * k_beams,), pos, dtype=torch.int32,
                               device=dev)
        x_t = (model.embed[tok.reshape(-1)][:, None, :].to(dtype)
               + model.pos_embed[pos][None, None, :].to(dtype))
        for i in range(model.num_layers):
            x_t = _block_decode_slots(
                model.block(i), x_t, k_caches[i], v_caches[i], positions,
                h, dtype, eps, attn_impl=attn_impl)
        logits = _logits(model, x_t, eps)[:, 0]
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k_beams, v_size)
        total = scores[:, :, None] + logp  # [B, K, V]
        scores, flat = _top_k(total.reshape(b, k_beams * v_size), k_beams,
                              tie=logits.reshape(b, k_beams * v_size))
        parent = flat // v_size  # [B, K] the surviving parent beams
        tok = flat % v_size
        if j < max_new_tokens - 1:  # the last step's caches are not read
            src = (rows + parent).reshape(-1)
            k_caches = k_caches.index_select(1, src)
            v_caches = v_caches.index_select(1, src)
        history = history.gather(1, parent[:, :, None].expand_as(history))
        history[:, :, j] = tok
    prompt_k = prompt[:, None, :].expand(b, k_beams, t)
    return torch.cat([prompt_k, history.to(prompt.dtype)], dim=2), scores


def teacher_forced_logits(model, tokens: torch.Tensor, prompt_len: int, *,
                          kv_dtype: str = "model",
                          attn_impl: str = "auto") -> torch.Tensor:
    """Decode-path logits along a FIXED transcript with the KV cache in
    ``kv_dtype`` (``"model"`` or ``"int8"``): the int8 cache's quality
    instrument (the JAX package's ``teacher_forced_logits``).

    Prefills ``tokens[:, :prompt_len]``, quantizes the prefilled cache
    as the serving engine's insert does (int8), then teacher-forces
    ``tokens[:, prompt_len:]`` through the shared decode body. Returns
    ``[T - prompt_len, B, V]`` f32: row 0 is the prefill's next-token
    logits, row ``j`` predicts position ``prompt_len + j``. Two runs
    (model dtype, int8) on one transcript isolate the cache
    representation's logit cost."""
    b, total = tokens.shape
    steps = total - int(prompt_len)
    if steps < 1:
        raise ValueError(
            f"need at least one decode position: prompt_len="
            f"{prompt_len} vs {total} tokens")
    dtype, eps, h = model.dtype, model.ln_eps, local_heads(model)
    x, k_caches, v_caches = _prefill(model, tokens[:, :prompt_len], total)
    out = [_logits(model, x[:, -1:], eps)[:, 0]]
    if kv_dtype == "int8":
        # whole-cache quantization == insert-time quantization: the
        # untouched tail columns become (data 0, scale 1)
        k_caches, v_caches = quantize_kv(k_caches), quantize_kv(v_caches)
    elif kv_dtype != "model":
        raise ValueError(f"kv_dtype must be 'model' or 'int8', got "
                         f"{kv_dtype!r}")
    for p_idx in range(prompt_len, total - 1):
        pos = torch.full((b,), p_idx, dtype=torch.int32,
                         device=tokens.device)
        x_t = _cols(model.embed[tokens[:, p_idx]][:, None, :].to(dtype)
                    + model.pos_embed[p_idx][None, None, :].to(dtype),
                    model.hidden_size, model.tp)
        for i in range(model.num_layers):
            x_t = _block_decode_slots(
                model.block(i), x_t, k_caches[i], v_caches[i], pos, h,
                dtype, eps, attn_impl=attn_impl, tp=model.tp)
        out.append(_logits(model, x_t, eps)[:, 0])
    return torch.stack(out)


# ------------------------------------------------------- memory ledger

def generate_kv_bytes(model, batch: int, s_max: int,
                      kv_dtype: str = "model") -> int:
    """Worst-case K+V cache bytes one :func:`generate` call holds:
    ``batch`` rows of the serving pool's per-slot product (the one copy
    of the shape x dtype arithmetic, ``SlotPool.per_slot_kv_bytes``)."""
    from ..serving.kv_slots import SlotPool

    return int(batch) * SlotPool.per_slot_kv_bytes(model, int(s_max),
                                                   kv_dtype)


def register_generate_hbm(model, batch: int, s_max: int) -> None:
    """Put one generate call's KV residency on the armed device-memory
    ledger (``inference.kv_cache``, JAX's entry); the CLIs call it
    right before the decode. Disarmed: one global read."""
    from ..runtime import hbm

    hbm.register("inference.kv_cache",
                 generate_kv_bytes(model, batch, s_max),
                 category="kv", batch=int(batch), s_max=int(s_max))
