"""Pipelined GPT training over a ``(data, pipe)`` grid of ranks (the
port of the JAX package's ``parallel/gpt_pipeline.py``).

The JAX program is one SPMD step in which every stage-heterogeneous
tensor is sharded over the ``pipe`` axis. The port keeps that layout
leaf for leaf, each rank holding its stage's slice only:

- ``embed``: the vocab rows ``[i * Vs, (i + 1) * Vs)`` of the table,
  ``Vs = ceil(V / N)``, zero-padded past ``V`` (the vocab-parallel
  lookup: each stage gathers the rows it owns, one sum over the pipe
  group builds the activation);
- ``blocks``: the stage's ``L / N`` consecutive blocks, run through the
  model's own block (:func:`..models.gpt._block`, the flash kernels on
  a card) on the schedules of :mod:`.pipeline`;
- ``head``: the vocab columns of the same slice (``[D, Vs]`` kernel,
  ``[Vs]`` bias). Under ``schedule="gpipe"`` the loss is vocab-parallel
  (local partial logits, padded slots masked to ``-1e9``, the
  log-sum-exp by a max and a sum over the pipe group), so the
  ``[B, S, V]`` logits exist nowhere; ``"1f1b"`` gathers the head for
  the step and takes a dense CE per microbatch where the last stage's
  output lands;
- ``pos`` and ``ln_f``: small, whole on every stage.

A stage is held as a :class:`..models.gpt.GPT` of ``Vs`` vocab and
``L / N`` layers (the parameters of one stage are exactly those of such
a model), bound to flat buffers (:class:`PipelinedState`). Checkpoints
carry JAX's stacked tree (:func:`stack_pipeline_params`: ``embed``
``[N, Vs, D]``, ``blocks/...`` ``[N, L / N, ...]``, ``head_k`` ``[N, D,
Vs]``, ``head_b`` ``[N, Vs]``), gathered over the pipe group on save
and sliced by each stage on resume.

Gradients: the JAX step differentiates under ``check_vma``, which sums
each leaf's cotangent over the axes it is replicated on. The port gets
the same sums explicitly: the vocab-parallel sums are autograd nodes
whose backward passes the (replicated) cotangent through, the head's
input sums its per-stage cotangents over the pipe group
(:func:`_vary`), the pipeline hands back the input cotangent on every
stage, and the whole gradient buffer is then summed over the data group
once. ``pos`` and ``ln_f`` thereby come out summed over both axes, the
pipe-sharded leaves over ``data`` only; a further sum would scale them
(the 2x/8x updates JAX's comment records).

MoE: a stage of an MoE model returns its layers' sum of ``[aux, z]``
beside its output (the schedules carry it, :mod:`.pipeline`), and the
objective adds ``(w_aux * A + w_z * Z) / dp`` with ``A``, ``Z`` those
sums over the stages divided by ``L * m``: JAX's layer-mean and
microbatch-mean. Each microbatch routes its own rows (capacity of the
whole ``S``, statistics per microbatch), as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from ..models.gpt import GPT, _block
from ..train.state import TrainState
from .mesh import DATA_AXIS, PIPE_AXIS, Axis
from .mesh import axis as grid_axis
from .pipeline import pipeline_1f1b, pipeline_apply

Params = Dict[str, torch.Tensor]
_MASKED = -1e9  # padded vocab slots' logit: no softmax mass


# ------------------------------------------------------------- the layout


def _num_layers(params: Params) -> int:
    n = 0
    while f"block_{n}.ln1.scale" in params:
        n += 1
    return n


def _block_paths(params: Params, prefix: str = "block_0.") -> List[str]:
    return [k[len(prefix):] for k in params if k.startswith(prefix)]


def stack_pipeline_params(params: Params, n_stages: int) -> Params:
    """A GPT's params (the port's ``state_dict`` names) -> JAX's
    pipe-shardable tree, under its flattened names: ``embed`` ``[N, Vs,
    D]`` (vocab rows, zero-padded), ``pos``, ``blocks.<path>`` ``[N,
    L/N, ...]``, ``ln_f.scale``/``ln_f.bias``, ``head_k`` ``[N, D, Vs]``
    and (with a head bias) ``head_b`` ``[N, Vs]`` (vocab columns,
    zero-padded). Padded slots are masked by the forward passes from the
    true vocab size, never here."""
    layers = _num_layers(params)
    if layers == 0:
        raise ValueError("params has no block_<i> entries — not a GPT tree")
    if layers % n_stages:
        raise ValueError(
            f"{layers} layers not divisible by n_stages={n_stages}")
    per = layers // n_stages
    vocab, d = params["embed"].shape
    vs = -(-vocab // n_stages)
    pad = n_stages * vs - vocab
    out = {"embed": F.pad(params["embed"], (0, 0, 0, pad)).reshape(
        n_stages, vs, d), "pos": params["pos_embed"].clone()}
    for path in _block_paths(params):
        leaf = torch.stack([params[f"block_{i}.{path}"]
                            for i in range(layers)])
        out[f"blocks.{path}"] = leaf.reshape(n_stages, per, *leaf.shape[1:])
    for key in ("scale", "bias"):
        out[f"ln_f.{key}"] = params[f"ln_final.{key}"].clone()
    out["head_k"] = F.pad(params["head.kernel"], (0, pad)).reshape(
        d, n_stages, vs).permute(1, 0, 2).contiguous()
    if "head.bias" in params:
        out["head_b"] = F.pad(params["head.bias"], (0, pad)).reshape(
            n_stages, vs)
    return out


def unstack_pipeline_params(stacked: Params, vocab_size: int) -> Params:
    """Inverse of :func:`stack_pipeline_params`: the GPT's params under
    the port's names."""
    n_stages, vs, d = stacked["embed"].shape
    out = {"embed": stacked["embed"].reshape(n_stages * vs, d)[:vocab_size],
           "pos_embed": stacked["pos"]}
    paths = [k[len("blocks."):] for k in stacked if k.startswith("blocks.")]
    per = stacked[f"blocks.{paths[0]}"].shape[1]
    for s in range(n_stages):
        for j in range(per):
            for path in paths:
                out[f"block_{s * per + j}.{path}"] = stacked[
                    f"blocks.{path}"][s, j]
    for key in ("scale", "bias"):
        out[f"ln_final.{key}"] = stacked[f"ln_f.{key}"]
    out["head.kernel"] = stacked["head_k"].permute(1, 0, 2).reshape(
        d, n_stages * vs)[:, :vocab_size]
    if "head_b" in stacked:
        out["head.bias"] = stacked["head_b"].reshape(-1)[:vocab_size]
    return out


def stage_params(stacked: Params, stage: int) -> Params:
    """Stage ``stage``'s slice of the stacked tree, under the names of
    its :func:`stage_model`."""
    paths = [k[len("blocks."):] for k in stacked if k.startswith("blocks.")]
    per = stacked[f"blocks.{paths[0]}"].shape[1]
    out = {"embed": stacked["embed"][stage], "pos_embed": stacked["pos"]}
    for j in range(per):
        for path in paths:
            out[f"block_{j}.{path}"] = stacked[f"blocks.{path}"][stage, j]
    for key in ("scale", "bias"):
        out[f"ln_final.{key}"] = stacked[f"ln_f.{key}"]
    out["head.kernel"] = stacked["head_k"][stage]
    if "head_b" in stacked:
        out["head.bias"] = stacked["head_b"][stage]
    return out


def stack_stages(stages: List[Params]) -> Params:
    """Every stage's params (stage order) as the stacked tree (the
    inverse of :func:`stage_params`; ``pos`` and ``ln_f`` from stage
    0)."""
    first = stages[0]
    per = _num_layers(first)
    out = {"embed": torch.stack([s["embed"] for s in stages]),
           "pos": first["pos_embed"]}
    for path in _block_paths(first):
        out[f"blocks.{path}"] = torch.stack([torch.stack(
            [s[f"block_{j}.{path}"] for j in range(per)]) for s in stages])
    for key in ("scale", "bias"):
        out[f"ln_f.{key}"] = first[f"ln_final.{key}"]
    out["head_k"] = torch.stack([s["head.kernel"] for s in stages])
    if "head.bias" in first:
        out["head_b"] = torch.stack([s["head.bias"] for s in stages])
    return out


def stage_model(model: GPT, n_stages: int) -> GPT:
    """One stage of ``model`` on ``n_stages``: a GPT of ``ceil(V / N)``
    vocab and ``L / N`` layers, the same widths, dtype and attention
    (parameters on the ``meta`` device until bound)."""
    return GPT(vocab_size=-(-model.vocab_size // n_stages),
               max_seq_len=model.max_seq_len, hidden_size=model.hidden_size,
               num_layers=model.num_layers // n_stages,
               num_heads=model.num_heads, mlp_dim=model.mlp_dim,
               dtype=model.dtype, attn_impl=model.attn_impl,
               n_experts=model.n_experts, moe_top_k=model.moe_top_k,
               moe_capacity_factor=model.moe_capacity_factor,
               ln_eps=model.ln_eps, head_bias=model.head.bias is not None)


# -------------------------------------------------------------- the state


class _Payload:
    """A gathered pipelined state: ``to_dict`` is the checkpoint."""

    def __init__(self, payload: Dict[str, object]):
        self.payload = payload

    def to_dict(self) -> Dict[str, object]:
        return self.payload


@dataclass
class PipelinedState(TrainState):
    """A :class:`..train.state.TrainState` over one stage's
    :func:`stage_model` (this rank's slice of every leaf), with the
    stage's place."""

    stage: int = 0
    n_stages: int = 1

    def stacked(self, flat: torch.Tensor) -> Params:
        """The stacked tree of the flat buffer ``flat`` (params or
        momentum) from every stage of this rank's data replica: one
        all-gather over the pipe group (a collective)."""
        ax = grid_axis(PIPE_AXIS)
        if ax.size > 1:
            every = flat.new_empty(ax.size * flat.numel())
            tdist.all_gather_into_tensor(every, flat.contiguous(),
                                         group=ax.group)
            rows = every.view(ax.size, -1)
        else:
            rows = flat.view(1, -1)
        return stack_stages([self.views(row) for row in rows])

    def gathered(self) -> _Payload:
        """The checkpoint payload in JAX's stacked layout (params,
        momentum, count, initialized, epoch). A collective: every rank
        calls it."""
        out: Dict[str, object] = {}
        for prefix, flat in (("params", self.params),
                             ("opt_state/momentum", self.momentum)):
            for key, t in self.stacked(flat).items():
                out[f"{prefix}/{key.replace('.', '/')}"] = t.detach().to(
                    "cpu", copy=True)
        out["opt_state/count"] = self.count.detach().to("cpu", copy=True)
        out["opt_state/initialized"] = self.initialized.detach().to(
            "cpu", copy=True)
        out["epoch"] = int(self.epoch)
        return _Payload(out)

    def to_dict(self, momentum=None, nu=None) -> Dict[str, object]:
        return self.gathered().to_dict()

    @torch.no_grad()
    def load_dict(self, d: Dict[str, object]) -> None:
        """Copy this stage's slice of a stacked payload into the live
        buffers (JAX's resume of a pipelined state)."""
        for prefix, flat in (("params", self.params),
                             ("opt_state/momentum", self.momentum)):
            head = prefix + "/"
            stacked = {k[len(head):].replace("/", "."): v
                       for k, v in d.items() if k.startswith(head)}
            embed = stacked.get("embed")
            if embed is None or embed.dim() != 3:
                raise ValueError(
                    "the checkpoint is not in the pipelined (stacked) "
                    "layout: resume it with the --parallel it was "
                    "written by")
            if embed.shape[0] != self.n_stages:
                raise ValueError(
                    f"the checkpoint was stacked for {embed.shape[0]} "
                    f"stages but this run has {self.n_stages}")
            mine = stage_params(stacked, self.stage)
            for name, t in self.views(flat).items():
                src = mine[name]
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {prefix}/{name} has shape "
                        f"{tuple(src.shape)}, the stage {tuple(t.shape)}")
                t.copy_(src)
        self.count.copy_(d["opt_state/count"])
        self.initialized.copy_(d["opt_state/initialized"])
        self.epoch = int(d["epoch"])

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes this rank holds of params and of the momentum (f32)."""
        return {"params": 4 * self.n, "opt_state": 4 * self.n}


def create_pipelined_lm_state(model: GPT, params: Params, n_stages: int,
                              stage: Optional[int] = None
                              ) -> PipelinedState:
    """The pipelined train state of this rank's stage (its pipe index
    on the grid, or ``stage``): ``params`` (a dense GPT's, on the target
    device: :func:`..serving.params.init_params` or ``from_jax_params``)
    restacked, the stage's slice bound into flat buffers, zero momenta,
    epoch 1. Raises JAX's words where the layers do not split."""
    stacked = stack_pipeline_params(params, n_stages)
    if stage is None:
        stage = grid_axis(PIPE_AXIS).index
    smodel = stage_model(model, n_stages)
    smodel.load_state_dict(stage_params(stacked, stage), assign=True)
    base = TrainState.bind(smodel)
    return PipelinedState(**{f.name: getattr(base, f.name)
                             for f in fields(TrainState)},
                          stage=stage, n_stages=n_stages)


# ------------------------------------------------------------- the parts


def _sum_over(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _SumOver.apply(x, ax)


def _vary(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Vary.apply(x, ax)


class _SumOver(torch.autograd.Function):
    """The sum over an axis of a per-rank value, replicated after
    (JAX ``psum``): the backward passes the (replicated) cotangent to
    each rank's input."""

    @staticmethod
    def forward(ctx, x, ax: Axis):
        y = x.clone()
        tdist.all_reduce(y, group=ax.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Vary(torch.autograd.Function):
    """A replicated value entering per-rank computation (JAX's ``pcast``
    to varying): the identity, whose backward sums the per-rank
    cotangents over the axis."""

    @staticmethod
    def forward(ctx, x, ax: Axis):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.ax.group)
        return g, None


def _stage_fn(model: GPT, stage: GPT):
    """This stage's blocks over ``x`` ``[mb, S, D]``; an MoE model's
    returns ``(y, [aux, z])``, the layers' sums of its losses."""
    moe = model.n_experts > 0

    def run(x):
        losses = []
        for j in range(stage.num_layers):
            x, _, _ = _block(stage.block(j), x, model.num_heads,
                             model.dtype, model.ln_eps, model.attn_impl,
                             losses)
        if not moe:
            return x
        return x, torch.stack([sum(a for a, _ in losses),
                               sum(z for _, z in losses)])

    return run


def _embed(model: GPT, stage: GPT, tokens: torch.Tensor,
           ax: Axis) -> torch.Tensor:
    """The vocab-parallel lookup: this stage's rows, summed over the
    pipe group, plus the positions, in the model dtype."""
    emb = stage.embed
    vs = emb.shape[0]
    idx = tokens - ax.index * vs
    mine = (idx >= 0) & (idx < vs)
    h = emb[idx.clamp(0, vs - 1)] * mine[..., None]
    h = _sum_over(h, ax)
    return (h + stage.pos_embed[:tokens.shape[1]]).to(model.dtype)


def _final_ln(h: torch.Tensor, stage: GPT, eps: float) -> torch.Tensor:
    """The final LayerNorm of the pipelined steps (JAX's ``final_ln``:
    the two-pass variance)."""
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps)
    return out * stage.ln_final.scale + stage.ln_final.bias


def _targets(tokens: torch.Tensor):
    """(next-token targets as int64, f32 weights masking the last
    position)."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))],
                        dim=1).long()
    w = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    return targets, w


def _check(state: PipelinedState, rows: torch.Tensor, m: int):
    """JAX's step checks; returns the (pipe, data) axes."""
    ax, dax = grid_axis(PIPE_AXIS), grid_axis(DATA_AXIS)
    if state.n_stages != ax.size:
        raise ValueError(
            f"state was stacked for {state.n_stages} stages but the mesh "
            f"{PIPE_AXIS!r} axis has {ax.size} — create the state with "
            "n_stages matching the mesh")
    b = rows.shape[0] * dax.size
    if b % (dax.size * m):
        raise ValueError(
            f"global batch {b} must divide by data axis x n_microbatches "
            f"= {dax.size} x {m}")
    return ax, dax


def _forward_ce(model: GPT, stage: GPT, tokens: torch.Tensor, ax: Axis,
                m: int) -> torch.Tensor:
    """The GPipe objective's CE sum over this replica's rows: the
    vocab-parallel embed, the pipelined blocks, the final LN and the
    vocab-parallel log-sum-exp CE (replicated over the pipe group)."""
    return _forward_objective(model, stage, tokens, ax, m)[0]


def _forward_objective(model: GPT, stage: GPT, tokens: torch.Tensor,
                       ax: Axis, m: int):
    """``(ce_sum, moe)``: :func:`_forward_ce`'s CE sum and, for an MoE
    model, ``[aux, z]`` summed over the stages and divided by ``L * m``
    (replicated over the pipe group; None for a dense model)."""
    targets, w = _targets(tokens)
    b, s = tokens.shape
    vs = stage.embed.shape[0]
    start = ax.index * vs
    h = _embed(model, stage, tokens, ax)
    moe = model.n_experts > 0
    out = pipeline_apply(_stage_fn(model, stage),
                         h.reshape(m, b // m, s, -1), axis_name=PIPE_AXIS,
                         with_stage_aux=moe)
    aux_vec = None
    if moe:
        out, aux_local = out
        aux_vec = _sum_over(aux_local, ax) / (model.num_layers * m)
    h = _final_ln(out.reshape(b, s, -1).float(), stage, model.ln_eps)
    logits = _vary(h, ax) @ stage.head.kernel
    if stage.head.bias is not None:
        logits = logits + stage.head.bias
    slot_valid = start + torch.arange(vs, device=tokens.device) \
        < model.vocab_size
    logits = torch.where(slot_valid, logits, _MASKED)
    gmax = logits.detach().amax(-1)
    if ax.size > 1:
        tdist.all_reduce(gmax, op=tdist.ReduceOp.MAX, group=ax.group)
    lse = torch.log(_sum_over(
        torch.exp(logits - gmax[..., None]).sum(-1), ax)) + gmax
    tidx = targets - start
    tmine = (tidx >= 0) & (tidx < vs)
    tlogit = torch.gather(logits, -1, tidx.clamp(0, vs - 1)[..., None]
                          )[..., 0] * tmine
    tlogit = _sum_over(tlogit, ax)
    return ((lse - tlogit) * w).sum(), aux_vec


def _gather_cols(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[..., Vs]`` slices of every stage laid end to end along the
    last dim (JAX ``all_gather(..., tiled=True)``), as a new leaf."""
    if ax.size == 1:
        return t.detach().requires_grad_()
    every = t.new_empty(ax.size * t.numel())
    tdist.all_gather_into_tensor(every, t.detach().reshape(-1),
                                 group=ax.group)
    return every.view(ax.size, *t.shape).movedim(0, -2).reshape(
        *t.shape[:-1], -1).requires_grad_()


def _scatter_cols(g: Optional[torch.Tensor], like: torch.Tensor,
                  ax: Axis) -> torch.Tensor:
    """This stage's ``[..., Vs]`` columns of the gathered gradient ``g``
    summed over the pipe group (the transpose of :func:`_gather_cols`:
    JAX's ``psum_scatter``)."""
    if g is None:
        g = like.new_zeros(tuple(like.shape[:-1]) + (ax.size
                                                     * like.shape[-1],))
    if ax.size == 1:
        return g
    parts = g.reshape(*like.shape[:-1], ax.size, like.shape[-1]) \
        .movedim(-2, 0).contiguous()
    out = like.new_empty(like.shape)
    tdist.reduce_scatter_tensor(out.view(-1), parts.view(-1),
                                group=ax.group)
    return out


def _ln_f_grads(state: PipelinedState) -> torch.Tensor:
    """The slice of the gradient buffer holding ``ln_final``'s scale and
    bias (adjacent in the stage's parameter order)."""
    offs = {name: (off, shape.numel()) for name, off, shape in state.layout}
    first, _ = offs["ln_final.scale"]
    last, size = offs["ln_final.bias"]
    return state.grads[first:last + size]


# -------------------------------------------------------------- the steps


def make_pipelined_lm_train_step(model: GPT, optimizer, *,
                                 n_microbatches: Optional[int] = None,
                                 schedule: str = "gpipe",
                                 moe_aux_weight: float = 0.01,
                                 moe_z_weight: float = 1e-3):
    """Build ``step(state, rows) -> (state, metrics)`` for a
    :class:`PipelinedState` on the grid's ``(data, pipe)`` axes (JAX
    ``make_pipelined_lm_train_step``).

    ``rows``: this rank's data index's ``[b, S]`` rows (the same on
    every stage of a replica), split into ``n_microbatches``
    (default: the pipe size) contiguous microbatches. ``schedule``:
    ``"gpipe"`` (:func:`.pipeline.pipeline_apply`, the vocab-parallel
    CE) or ``"1f1b"`` (:func:`.pipeline.pipeline_1f1b`, the head
    gathered for the step, a dense CE per microbatch); the same update
    either way. ``metrics`` as :func:`..train.lm.make_lm_train_step`'s
    (``loss``, ``count``; ``skipped`` is always 0: JAX's pipelined step
    has no NaN guard); an MoE model adds ``moe_aux``, the balance
    loss's layer and microbatch mean, averaged over the data replicas.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
    moe = model.n_experts > 0
    weights = (moe_aux_weight, moe_z_weight)

    def sum_over_data(state, dax):
        if dax.size > 1:
            tdist.all_reduce(state.grads, group=dax.group)

    def gpipe(state, rows, ax, dax, m, count):
        ce_sum, aux_vec = _forward_objective(model, state.model, rows, ax, m)
        obj = ce_sum / count
        if moe:
            obj = obj + (weights[0] * aux_vec[0]
                         + weights[1] * aux_vec[1]) / dax.size
        obj.backward()
        state.grads[state.n] = ce_sum.detach()
        sum_over_data(state, dax)
        return state.grads[state.n] / count, (
            aux_vec[0].detach() if moe else None)

    def one_f_one_b(state, rows, ax, dax, m, count):
        stage = state.model
        b, s = rows.shape
        mb = b // m
        targets, w = _targets(rows)
        h = _embed(model, stage, rows, ax)
        full_k = _gather_cols(stage.head.kernel, ax)
        full_b = (None if stage.head.bias is None
                  else _gather_cols(stage.head.bias, ax))
        tj, wj = targets.reshape(m, mb, s), w.reshape(m, mb, s)
        slots = torch.arange(full_k.shape[1], device=rows.device)

        def mb_loss(y, j):
            hh = _final_ln(y.float(), stage, model.ln_eps)
            logits = hh @ full_k
            if full_b is not None:
                logits = logits + full_b
            logits = torch.where(slots < model.vocab_size, logits, _MASKED)
            gmax = logits.detach().amax(-1)
            lse = torch.log(torch.exp(logits - gmax[..., None]).sum(-1)) \
                + gmax
            tlogit = torch.gather(logits, -1, tj[j][..., None])[..., 0]
            return ((lse - tlogit) * wj[j]).sum() / count

        micro = h.reshape(m, mb, s, -1)
        aux_sum = None
        if moe:
            # the objective's constant d/d(stage aux): its weights over
            # L * m * dp
            ct = torch.tensor(weights, dtype=torch.float32,
                              device=rows.device) / (
                model.num_layers * m * dax.size)
            loss_sum, d_micro, aux_local = pipeline_1f1b(
                _stage_fn(model, stage), micro.detach(), mb_loss,
                axis_name=PIPE_AXIS, with_stage_aux=True,
                stage_aux_cotangent=ct)
            aux_sum = aux_local[0].clone()
            if ax.size > 1:
                tdist.all_reduce(aux_sum, group=ax.group)
            aux_sum = aux_sum / (model.num_layers * m)
        else:
            loss_sum, d_micro = pipeline_1f1b(
                _stage_fn(model, stage), micro.detach(), mb_loss,
                axis_name=PIPE_AXIS)
        with torch.no_grad():
            stage.head.kernel.grad.add_(_scatter_cols(full_k.grad,
                                                      stage.head.kernel, ax))
            if full_b is not None:
                stage.head.bias.grad.add_(_scatter_cols(
                    full_b.grad, stage.head.bias, ax))
            if ax.size > 1:  # ln_f's partials, on the last stage
                tdist.all_reduce(_ln_f_grads(state), group=ax.group)
        torch.autograd.backward(micro, d_micro)
        state.grads[state.n] = loss_sum
        sum_over_data(state, dax)
        return state.grads[state.n].clone(), aux_sum

    body = one_f_one_b if schedule == "1f1b" else gpipe

    def step(state: PipelinedState, rows: torch.Tensor):
        m = n_microbatches or state.n_stages
        ax, dax = _check(state, rows, m)
        b, s = rows.shape
        count = float(b * dax.size * (s - 1))
        state.grads.zero_()
        loss, aux = body(state, rows, ax, dax, m, count)
        keep = torch.ones((), dtype=torch.bool, device=rows.device)
        optimizer.apply_(state.params, state.grads[:state.n],
                         state.momentum, state.initialized, state.count,
                         keep, lr_step=state.epoch)
        metrics = {"loss": loss, "count": torch.tensor(count),
                   "skipped": torch.zeros((), dtype=torch.int32)}
        if moe:
            aux = aux.reshape(1)
            if dax.size > 1:
                tdist.all_reduce(aux, group=dax.group)
            metrics["moe_aux"] = aux[0] / dax.size
        return state, metrics

    return step


def make_pipelined_lm_eval_step(model: GPT, *,
                                n_microbatches: Optional[int] = None):
    """Forward-only pipelined eval (JAX ``make_pipelined_lm_eval_step``):
    ``eval_step(state, rows) -> {loss, count}``, the exact mean
    next-token CE over the global batch through the GPipe forward of the
    train step."""

    @torch.no_grad()
    def eval_step(state: PipelinedState, rows: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        m = n_microbatches or state.n_stages
        ax, dax = _check(state, rows, m)
        b, s = rows.shape
        count = float(b * dax.size * (s - 1))
        ce_sum = _forward_ce(model, state.model, rows, ax, m).reshape(1)
        if dax.size > 1:
            tdist.all_reduce(ce_sum, group=dax.group)
        return {"loss": ce_sum[0] / count, "count": torch.tensor(count)}

    return eval_step
