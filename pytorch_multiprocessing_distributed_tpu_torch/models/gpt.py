"""Decoder-only transformer language models (GPT family).

The port of the JAX package's ``models/gpt.py``: pre-LN GPT-2 style —
learned positional embeddings, N blocks of (LN -> causal MHA ->
residual, LN -> GELU MLP -> residual), final LN, untied linear head.
Matmuls in ``dtype``, LayerNorm/softmax/head in f32, params in f32.
Attention is ``attn_impl="flash"`` by default, as in JAX: the forward
calls :func:`..ops.flash_attention.flash_attention` (the CUDA kernels on
the card, their plain versions on the CPU); ``"xla"`` is the plain
masked-softmax math of :func:`_block_prefill`.

Parameters keep the JAX tree's names and layouts, so a flattened JAX
tree maps onto ``state_dict()`` one to one (``block_0/attn/wqkv/kernel``
is ``block_0.attn.wqkv.kernel``) and Dense kernels stay ``[in, out]``
(``x @ kernel + bias``, in :func:`_dense` only). A freshly built model
holds its parameters on the ``meta`` device (no memory) with
``requires_grad=False`` (serving records no graph); bind real values
with ``model.load_state_dict(params, assign=True)`` from
:func:`..serving.params.init_params`, ``from_jax_params`` or
``load_params``. Training turns gradients on for the bound leaves
(:func:`..train.lm.create_lm_train_state`).

The math helpers below (:func:`_ln`, :func:`_dense`, :func:`_ffn`,
:func:`_block_prefill`, ...) are shared with :mod:`..inference.generate`
so the cached decode path and the model's forward cannot drift; the
serving prefill keeps the plain attention of :func:`_block_prefill`.

Sequence parallelism: ``seq_axis`` names the grid axis
(:func:`..parallel.mesh.make_grid` with ``axis="seq"``) the sequence is
split over. Tokens arrive as this rank's slice of the global sequence,
the position table is sliced to match (two chunks under ``sp_mode=
"zigzag"``), and attention runs :func:`..parallel.ring_attention
.ring_attention` (``"ring"``, ``"zigzag"``) or :func:`..parallel
.ulysses.ulysses_attention` (``"ulysses"``), whatever ``attn_impl``
says; every other op is per position and stays local.

Mixture of Experts: ``n_experts > 0`` puts :class:`..ops.moe.MoEMlp`
(``moe``) in every block in place of ``fc1``/``fc2``. The model's
forward runs JAX's training layer (capacity slots, dropped tokens) and,
when asked (``moe_losses=True``), returns the layer means of its
balance and router z losses beside the output; the decode helpers
(:func:`_ffn`) run its dropless twin, as JAX's ``generate`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.moe import MoEMlp
from ..parallel.mesh import axis as grid_axis
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention
from .registry import register

SP_MODES = ("ring", "zigzag", "ulysses")


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"),
                        requires_grad=False)


class Dense(nn.Module):
    """Flax ``nn.Dense`` layout: ``kernel`` ``[in, out]``, ``bias``
    ``[out]``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = _meta(d_in, d_out)
        self.bias = _meta(d_out) if bias else None


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` parameters: ``scale`` and ``bias``."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = _meta(d)
        self.bias = _meta(d)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.wqkv = Dense(d, 3 * d)
        self.wo = Dense(d, d)


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and the feed-forward: ``fc1``/``fc2``,
    or ``moe`` when ``n_experts > 0``."""

    def __init__(self, d: int, mlp_dim: int, n_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.0):
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.attn = Attention(d)
        self.ln2 = LayerNorm(d)
        if n_experts > 0:
            self.moe = MoEMlp(d, n_experts, mlp_dim, moe_capacity_factor,
                              moe_top_k)
        else:
            self.fc1 = Dense(d, mlp_dim)
            self.fc2 = Dense(mlp_dim, d)


# ---- the math (shared with inference.generate) ------------------------

def _ln(x, p: LayerNorm, eps: float):
    """LayerNorm in f32 with the fast variance E[x^2] - E[x]^2 (flax's
    default): the cached path must match the model's forward bit for bit
    or near-tied argmaxes flip tokens."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out * p.scale + p.bias


def _dense(x, p: Dense, dtype):
    """``x @ kernel + bias`` in ``dtype`` on the ``[in, out]`` kernel —
    the one place the Dense layout is read."""
    out = x.to(dtype) @ p.kernel.to(dtype)
    return out if p.bias is None else out + p.bias.to(dtype)


def _cols(t, full: int, tp):
    """``t`` with its last dim whole (``full`` columns). Under
    tensor-parallel decode (``tp``, :class:`..inference.tp.TPShard`) a
    rank computes the columns it holds of a Dense output or an
    embedding, and the all-gather joins every rank's in rank order; a
    leaf JAX replicates gives whole columns already."""
    if tp is None or t.shape[-1] == full:
        return t
    return tp.gather(t)


def _ffn(p: Block, x, dtype, eps: float, tp=None):
    """ln2 -> fc1 -> tanh-approximate GELU (``jax.nn.gelu``'s default)
    -> fc2, in ``dtype``; or, in an MoE block, ln2 -> the dropless MoE
    layer (:meth:`..ops.moe.MoEMlp.dropless`, f32 out): the decode
    path's feed-forward. ``tp``: a rank's shard (:func:`_cols` after
    the GELU and after fc2)."""
    cols = None if tp is None else (lambda t, n: _cols(t, n, tp))
    if hasattr(p, "moe"):
        return p.moe.dropless(_ln(x, p.ln2, eps), dtype, cols)
    hn = _ln(x, p.ln2, eps).to(dtype)
    y = F.gelu(_dense(hn, p.fc1, dtype), approximate="tanh")
    y = _cols(y, p.fc2.kernel.shape[0], tp)  # fc2 reads every channel
    return _cols(_dense(y, p.fc2, dtype), x.shape[-1], tp)


def _split_heads(t, h: int):
    b, s, d = t.shape
    return t.reshape(b, s, h, d // h)


def _causal_xla(q, k, v, kv_valid=None):
    """Plain causal attention on ``[B, S, H, Dh]``: f32 logits, masked
    softmax, f32 PV (the JAX ``attn_impl="xla"`` math). ``kv_valid``
    (``[B, S]`` bool, a left-padded ragged batch): pad columns receive
    no attention, and a pad query attends only itself (JAX's fallback:
    its softmax stays finite; its output is never read)."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if kv_valid is not None:
        eye = torch.eye(s, dtype=torch.bool, device=q.device)
        mask = (mask & kv_valid[:, None, None, :]) | eye
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def _block(p: Block, x, h: int, dtype, eps: float, attn_impl,
           moe_losses=None, moe_stats=None, tp=None):
    """One block over ``x`` ``[B, S, D]``; returns ``(y, k, v)`` with
    k/v ``[B, S, H, Dh]`` in ``dtype``. ``attn_impl="flash"`` runs
    :func:`..ops.flash_attention.flash_attention` on the views of the
    fused QKV projection (read in place by the kernels); a callable
    ``attn_impl(q, k, v)`` is the sequence-parallel attention.

    ``moe_losses`` (a list): an MoE block runs the training layer
    (capacity slots, JAX's ``MoEMlp``) and appends its ``(aux, z)``,
    with ``moe_stats`` its ``stats_group``; None: the dropless decode
    layer of :func:`_ffn`. A dense block ignores both.

    ``tp``: a rank's shard (:mod:`..inference.tp`): ``h`` is its heads,
    k/v are theirs, and attention's output and ``wo``'s are gathered
    (:func:`_cols`)."""
    b, s, d = x.shape
    hn = _ln(x, p.ln1, eps).to(dtype)
    q, k, v = _dense(hn, p.attn.wqkv, dtype).chunk(3, dim=-1)
    q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    if callable(attn_impl):
        att = attn_impl(q, k, v)
    elif attn_impl == "flash":
        att = flash_attention(q, k, v, causal=True)
    else:
        att = _causal_xla(q, k, v)
    att = _cols(att.reshape(b, s, -1).to(dtype), d, tp)
    x = x + _cols(_dense(att, p.attn.wo, dtype), d, tp)
    if moe_losses is not None and hasattr(p, "moe"):
        y, aux, z = p.moe(_ln(x, p.ln2, eps), dtype, moe_stats)
        moe_losses.append((aux, z))
        return x + y, k, v
    return x + _ffn(p, x, dtype, eps, tp), k, v


def _block_prefill(p: Block, x, h: int, dtype, eps: float, tp=None,
                   kv_valid=None):
    """Full causal pass over ``x`` ``[B, S, D]`` with the plain
    attention and the dropless MoE layer (the serving prefill, mirroring
    JAX ``generate.py``); returns ``(y, k, v)`` with k/v ``[B, S, H,
    Dh]`` in ``dtype`` (a shard's ``h`` heads under ``tp``).
    ``kv_valid``: a ragged batch's key-column validity
    (:func:`_causal_xla`)."""
    attn = ("xla" if kv_valid is None
            else (lambda q, k, v: _causal_xla(q, k, v, kv_valid)))
    return _block(p, x, h, dtype, eps, attn, tp=tp)


def _embed(model: "GPT", tokens, dtype, offsets=None):
    """Token + position embeddings for ``tokens`` ``[B, S]`` at
    positions ``0..S-1``, each cast BEFORE the add (the model's own
    order: under bf16, bf16(a) + bf16(b) != bf16(a + b)); a shard's
    columns gathered. ``offsets`` (``[B]``, a left-padded ragged
    batch): row ``i``'s first real token, at column ``offsets[i]``, gets
    position 0, and its pad columns clamp to position 0."""
    s = tokens.shape[1]
    if offsets is None:
        pos = model.pos_embed[:s]
    else:
        ids = (torch.arange(s, device=tokens.device)[None, :]
               - offsets.long()[:, None]).clamp(min=0)
        pos = model.pos_embed[ids]  # [B, S, D]
    return _cols(model.embed[tokens].to(dtype) + pos.to(dtype),
                 model.hidden_size, model.tp)


def _logits(model: "GPT", x, eps: float):
    """Final LN and the f32 head (a head split over a shard's ranks
    gathered: whole on every registered model)."""
    out = _ln(x, model.ln_final, eps) @ model.head.kernel.float()
    if model.head.bias is not None:
        out = out + model.head.bias
    return _cols(out, model.vocab_size, model.tp)


def layer_means(losses, like: torch.Tensor):
    """``(aux, z)`` means over the layers' ``(aux, z)`` pairs (f32
    zeros on ``like``'s device where there are none: a dense model)."""
    if not losses:
        zero = torch.zeros((), dtype=torch.float32, device=like.device)
        return zero, zero
    n = len(losses)
    return (sum(a for a, _ in losses) / n, sum(z for _, z in losses) / n)


class GPT(nn.Module):
    """Decoder-only LM. ``forward(tokens [B, S])`` -> f32 logits
    ``[B, S, vocab]`` (under ``seq_axis``, ``S`` is this rank's slice of
    the global sequence).

    ``tp``: None, or on a rank's tensor-parallel decode shard
    (:func:`..inference.tp.shard_params_for_tp_decode`) its
    :class:`..inference.tp.TPShard`; the decode helpers read it."""

    tp = None

    def __init__(self, vocab_size: int = 50257, max_seq_len: int = 1024,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "flash", seq_axis: Optional[str] = None,
                 sp_mode: str = "ring", n_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.0,
                 ln_eps: float = 1e-6, head_bias: bool = True,
                 expert_axis: Optional[str] = None):
        super().__init__()
        if attn_impl not in ("flash", "xla"):
            raise ValueError(
                f"attn_impl must be 'flash' or 'xla', got {attn_impl!r}")
        if seq_axis is not None and sp_mode not in SP_MODES:
            raise ValueError(
                f"sp_mode must be 'ring', 'zigzag' or 'ulysses', got "
                f"{sp_mode!r} (a typo would otherwise silently benchmark "
                "the wrong strategy)")
        if expert_axis is not None:
            raise NotImplementedError(
                "expert parallelism (expert_axis) is not ported to PyTorch "
                "yet (ROADMAP.md, 'Port: modules still to port')")
        if hidden_size % num_heads:
            raise ValueError(
                f"hidden_size {hidden_size} not divisible by num_heads "
                f"{num_heads}")
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.seq_axis = seq_axis
        self.sp_mode = sp_mode
        self.n_experts = n_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.ln_eps = ln_eps
        self.embed = _meta(vocab_size, hidden_size)
        self.pos_embed = _meta(max_seq_len, hidden_size)
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(
                hidden_size, mlp_dim, n_experts, moe_top_k,
                moe_capacity_factor))
        self.ln_final = LayerNorm(hidden_size)
        self.head = Dense(hidden_size, vocab_size, bias=head_bias)

    @staticmethod
    def jax_to_torch_dims(name: str, shape) -> tuple:
        """Every parameter keeps the JAX tree's layout (Dense kernels
        ``[in, out]``): JAX dim ``j`` is dim ``j`` here (the placement
        rules of :mod:`..train.placement` read it)."""
        return tuple(range(len(shape)))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def block(self, i: int) -> Block:
        return getattr(self, f"block_{i}")

    def clone(self, **overrides) -> "GPT":
        """The same model with ``overrides`` (e.g. ``seq_axis=None``, the
        dense model a sequence-parallel run samples with), sharing this
        model's parameter storage."""
        kw = dict(vocab_size=self.vocab_size, max_seq_len=self.max_seq_len,
                  hidden_size=self.hidden_size, num_layers=self.num_layers,
                  num_heads=self.num_heads, mlp_dim=self.mlp_dim,
                  dtype=self.dtype, attn_impl=self.attn_impl,
                  seq_axis=self.seq_axis, sp_mode=self.sp_mode,
                  n_experts=self.n_experts, moe_top_k=self.moe_top_k,
                  moe_capacity_factor=self.moe_capacity_factor,
                  ln_eps=self.ln_eps, head_bias=self.head.bias is not None)
        kw.update(overrides)
        other = GPT(**kw)
        other.load_state_dict(self.state_dict(), assign=True)
        return other

    def _positions(self, s: int) -> torch.Tensor:
        """This rank's rows of the position table for ``s`` local
        tokens."""
        if self.seq_axis is None:
            if s > self.max_seq_len:
                raise ValueError(
                    f"sequence {s} exceeds max_seq_len={self.max_seq_len}")
            return self.pos_embed[:s]
        ax = grid_axis(self.seq_axis)
        n, idx = ax.size, ax.index
        if s * n > self.max_seq_len:
            raise ValueError(
                f"global sequence {s} x {n} shards = {s * n} exceeds "
                f"max_seq_len={self.max_seq_len}")
        if self.sp_mode == "zigzag":
            # chunks idx and 2N-1-idx of the 2N-chunked sequence
            c = s // 2
            j = 2 * n - 1 - idx
            return torch.cat([self.pos_embed[idx * c:(idx + 1) * c],
                              self.pos_embed[j * c:(j + 1) * c]])
        return self.pos_embed[idx * s:(idx + 1) * s]

    def _attention(self):
        if self.seq_axis is None:
            return self.attn_impl
        if self.sp_mode == "ulysses":
            return lambda q, k, v: ulysses_attention(
                q, k, v, axis_name=self.seq_axis, causal=True)
        zigzag = self.sp_mode == "zigzag"
        return lambda q, k, v: ring_attention(
            q, k, v, axis_name=self.seq_axis, causal=True, zigzag=zigzag)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                moe_losses: bool = False, moe_stats=None):
        """f32 logits, or with ``return_hidden=True`` the f32 hiddens
        after the final LayerNorm ``[B, S, D]`` (the input of
        :func:`..ops.losses.chunked_lm_ce`). ``moe_losses=True`` returns
        ``(out, aux, z)``: the layer means of the MoE balance and router
        z losses (JAX's sown ``losses`` through ``_collect_moe_losses``;
        zeros for a dense model). ``moe_stats``: the layers'
        ``stats_group`` (:meth:`..ops.moe.MoEMlp.forward`)."""
        pos = self._positions(tokens.shape[1])
        x = self.embed[tokens].to(self.dtype) + pos.to(self.dtype)
        attn = self._attention()
        losses = []
        for i in range(self.num_layers):
            x, _, _ = _block(self.block(i), x, self.num_heads, self.dtype,
                             self.ln_eps, attn, losses, moe_stats)
        if return_hidden:
            out = _ln(x, self.ln_final, self.ln_eps).float()
        else:
            out = _logits(self, x, self.ln_eps).float()
        if not moe_losses:
            return out
        return (out, *layer_means(losses, x))


def _family(kw, **defaults):
    for key, value in defaults.items():
        kw.setdefault(key, value)
    return GPT(**kw)


def GPT_Small(**kw) -> GPT:
    """GPT-2 small geometry (124M at the 50257 vocab)."""
    return _family(kw, hidden_size=768, num_layers=12, num_heads=12,
                   mlp_dim=3072)


def GPT_Medium(**kw) -> GPT:
    """GPT-2 medium geometry (350M)."""
    return _family(kw, hidden_size=1024, num_layers=24, num_heads=16,
                   mlp_dim=4096)


def GPT_Tiny(**kw) -> GPT:
    """4-layer/128-wide smoke model for tests and CPU runs."""
    return _family(kw, vocab_size=257, max_seq_len=256, hidden_size=128,
                   num_layers=4, num_heads=4, mlp_dim=512)


register("gpt_small", lm=True)(GPT_Small)
register("gpt_medium", lm=True)(GPT_Medium)
register("gpt_tiny", lm=True)(GPT_Tiny)
