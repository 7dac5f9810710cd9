"""Pipeline parallelism over the grid's ``pipe`` axis (the port of the
JAX package's ``parallel/pipeline.py``: ``pipeline_apply``, the GPipe
schedule, and ``pipeline_1f1b``).

Stage ``i`` of ``n`` is the rank at pipe index ``i`` of its data
replica (:func:`.mesh.make_grid` with ``axis="pipe"``). The JAX schedule
is a ``lax.scan`` over ticks inside ``shard_map``, activations hopping
one stage a tick by ``ppermute``; autodiff reverses the scan. Here each
stage is its own process, so nothing differentiates through the
schedule: the port writes out both directions, tick by tick.

- A tick's transfers go in ONE ``batch_isend_irecv`` on the pipe
  group, every rank posting its sends and receives of the tick in one
  global order (activations to ``i + 1``, cotangents to ``i - 1``).
  A rank with nothing to move in a tick posts nothing; the neighbour
  that would have paired with it has nothing to move either.
- The first point-to-point call on a communicator is collective over
  its group, so each pipe group is warmed by one ring exchange that
  every stage joins (:func:`_warm`).
- GPipe (:func:`pipeline_apply`): at tick ``t`` stage ``i`` runs
  microbatch ``t - i`` (``n + m - 1`` ticks). Each stage keeps the
  autograd graph of every microbatch it ran; the backward is the
  reverse schedule, the last stage seeding each microbatch's backward
  with its slice of the output cotangent and every stage sending the
  cotangent of its input to ``i - 1``. :func:`pipeline_apply` is one
  autograd node: its output is replicated over the axis (broadcast from
  the last stage, JAX's ``psum`` of the masked output) and the
  cotangent of its input comes back replicated (stage 0's, JAX's
  ``psum`` over the axis of the ``pcast``).
- 1F1B (:func:`pipeline_1f1b`): the forward of microbatch ``j`` runs on
  stage ``i`` at tick ``j + i`` without a graph; the last stage takes
  the microbatch's loss and its output cotangent at once, and the
  backward of ``j`` runs at tick ``j + 2n - 1 - i``, rematerializing
  the stage forward from the stored input (``m + 2n - 1`` ticks). A
  stage holds at most ``2(n - i) - 1`` microbatch inputs at a time,
  whatever ``m`` is (JAX's ``2S - 1`` buffer at stage 0).

A stage function may return ``(y, aux)`` with ``aux`` a small f32
vector of this stage's side losses (the MoE balance and z losses summed
over its layers, JAX's ``with_stage_aux``): both schedules sum it over
the stage's valid microbatches (once each: 1F1B's rematerialized
forward does not count again) and seed its cotangent beside the
activation's in each microbatch's backward, so its gradient reaches the
stage's parameters and flows upstream with the input cotangent.

Bubble ticks compute nothing here (JAX computes masked garbage in
them). The stage function runs the model's own blocks, so on the card
it launches the flash kernels once a layer and microbatch (twice for
the forward under 1F1B: once without a graph, once rematerialized).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as tdist

from .mesh import PIPE_AXIS, Axis
from .mesh import axis as grid_axis

_FWD_TAG, _BWD_TAG, _WARM_TAG = 1, 2, 3
_WARMED: Dict[Tuple[int, ...], bool] = {}


def _warm(ax: Axis, like: torch.Tensor) -> None:
    """One ring exchange of a scalar that every rank of the pipe group
    joins, before the group's first partial exchange (a point-to-point
    call that opens a communicator is collective over its group)."""
    key = ax.ranks + (like.device.type == "cuda",)
    if _WARMED.get(key):
        return
    send = like.new_zeros(1)
    recv = like.new_empty(1)
    nxt = ax.ranks[(ax.index + 1) % ax.size]
    prv = ax.ranks[(ax.index - 1) % ax.size]
    for req in tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, nxt, ax.group, _WARM_TAG),
            tdist.P2POp(tdist.irecv, recv, prv, ax.group, _WARM_TAG)]):
        req.wait()
    _WARMED[key] = True


def forget_warm_groups() -> None:
    """Forget which pipe groups were warmed (their grid is gone)."""
    _WARMED.clear()


class _Ticks:
    """One stage's transfers with its neighbours, a tick at a time: the
    tick's sends and receives posted together, waited before the next
    tick's compute reads them."""

    def __init__(self, ax: Axis, like: torch.Tensor):
        self.group = ax.group
        self.next = ax.ranks[ax.index + 1] if ax.index < ax.size - 1 else None
        self.prev = ax.ranks[ax.index - 1] if ax.index > 0 else None
        self.reqs: list = []
        _warm(ax, like)

    def post(self, send_next=None, send_prev=None, recv_prev=None,
             recv_next=None) -> None:
        ops = []
        if send_next is not None:
            ops.append(tdist.P2POp(tdist.isend, send_next, self.next,
                                   self.group, _FWD_TAG))
        if send_prev is not None:
            ops.append(tdist.P2POp(tdist.isend, send_prev, self.prev,
                                   self.group, _BWD_TAG))
        if recv_prev is not None:
            ops.append(tdist.P2POp(tdist.irecv, recv_prev, self.prev,
                                   self.group, _FWD_TAG))
        if recv_next is not None:
            ops.append(tdist.P2POp(tdist.irecv, recv_next, self.next,
                                   self.group, _BWD_TAG))
        self.reqs = tdist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> None:
        for req in self.reqs:
            req.wait()
        self.reqs = []


def _valid(j: int, m: int) -> bool:
    return 0 <= j < m


def _broadcast_from(x: torch.Tensor, ax: Axis, index: int) -> torch.Tensor:
    """``x`` as pipe index ``index`` holds it, on every stage."""
    if ax.size > 1:
        tdist.broadcast(x, ax.ranks[index], group=ax.group)
    return x


def _split_aux(result, with_aux: bool):
    """``(y, aux)`` of a stage function's result (``aux`` None without
    stage aux)."""
    return result if with_aux else (result, None)


def _gpipe_forward(stage_fn, micro, ax: Axis, graph: bool,
                   with_aux: bool = False):
    """The forward ticks: ``(out [m, ...] on the last stage, {j: (stage
    input leaf, stage output, stage aux)} of this stage's microbatches
    when ``graph``, this stage's aux summed over its microbatches (None
    without ``with_aux``))."""
    n, i, m = ax.size, ax.index, micro.shape[0]
    ticks = _Ticks(ax, micro) if n > 1 else None
    out = torch.zeros_like(micro)
    saved = {}
    aux_acc = None
    recv = None
    for t in range(m + n - 1):
        if ticks:
            ticks.wait()
        j = t - i
        y = None
        if _valid(j, m):
            x = micro[j] if i == 0 else recv
            if graph:
                x = x.detach().requires_grad_()
                with torch.enable_grad():
                    y, aux = _split_aux(stage_fn(x), with_aux)
                saved[j] = (x, y, aux)
            else:
                y, aux = _split_aux(stage_fn(x), with_aux)
            if aux is not None:
                aux_acc = (aux.detach() if aux_acc is None
                           else aux_acc + aux.detach())
            if i == n - 1:
                out[j] = y.detach()
        if ticks:
            recv = (torch.empty_like(micro[0])
                    if i > 0 and _valid(t + 1 - i, m) else None)
            ticks.post(send_next=(y.detach().contiguous()
                                  if y is not None and i < n - 1 else None),
                       recv_prev=recv)
    if ticks:
        ticks.wait()
    return _broadcast_from(out, ax, n - 1), saved, aux_acc


class _GPipe(torch.autograd.Function):
    """:func:`pipeline_apply` as one autograd node (see the module
    note); with stage aux, a second output: this stage's aux sum."""

    @staticmethod
    def forward(ctx, micro, stage_fn, ax, with_aux):
        out, saved, aux = _gpipe_forward(stage_fn, micro, ax, graph=True,
                                         with_aux=with_aux)
        ctx.ax, ctx.saved = ax, saved
        return (out, aux) if with_aux else out

    @staticmethod
    def backward(ctx, d_out, d_aux=None):
        ax, saved = ctx.ax, ctx.saved
        n, i, m = ax.size, ax.index, d_out.shape[0]
        ticks = _Ticks(ax, d_out) if n > 1 else None
        d_micro = torch.zeros_like(d_out)
        recv = None
        for t in reversed(range(m + n - 1)):
            if ticks:
                ticks.wait()
            j = t - i
            dx = None
            if _valid(j, m):
                g = d_out[j] if i == n - 1 else recv
                x, y, aux = saved.pop(j)
                if aux is None:
                    torch.autograd.backward(y, g)
                else:
                    torch.autograd.backward([y, aux], [g, d_aux])
                dx = x.grad
                if i == 0:
                    d_micro[j] = dx
            if ticks:
                recv = (torch.empty_like(d_out[0])
                        if i < n - 1 and _valid(t - 1 - i, m) else None)
                ticks.post(send_prev=(dx.contiguous() if dx is not None
                                      and i > 0 else None),
                           recv_next=recv)
        if ticks:
            ticks.wait()
        ctx.saved = None
        return _broadcast_from(d_micro, ax, 0), None, None, None


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   microbatches: torch.Tensor, *,
                   axis_name: str = PIPE_AXIS,
                   with_stage_aux: bool = False):
    """Run this stage of the GPipe schedule on ``microbatches`` ``[m,
    mb, ...]`` (the same tensor on every stage; stage 0 reads it).

    ``stage_fn(x) -> y`` is this stage's computation, ``y`` of ``x``'s
    shape and dtype (homogeneous stages). Returns the ``[m, mb, ...]``
    outputs of the last stage, replicated over the axis. Under autograd
    the result is differentiable: its cotangent must be the same on
    every stage (the cotangent of a replicated value), the gradients of
    ``stage_fn``'s parameters accumulate into their ``.grad`` on each
    stage, and the input's cotangent comes back replicated. Without
    autograd (``torch.no_grad``, or nothing requiring a gradient) no
    graph is kept.

    ``with_stage_aux``: ``stage_fn(x) -> (y, aux)``; returns ``(out,
    aux_sum)``, ``aux_sum`` this stage's aux summed over its
    microbatches (per stage: sum it over the axis for the total). Its
    cotangent is seeded beside the output's in each microbatch's
    backward.
    """
    ax = grid_axis(axis_name)
    if torch.is_grad_enabled():
        return _GPipe.apply(microbatches, stage_fn, ax, with_stage_aux)
    out, _, aux = _gpipe_forward(stage_fn, microbatches, ax, graph=False,
                                 with_aux=with_stage_aux)
    return (out, aux) if with_stage_aux else out


def pipeline_1f1b(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                  microbatches: torch.Tensor,
                  loss_fn: Callable[[torch.Tensor, int], torch.Tensor], *,
                  axis_name: str = PIPE_AXIS, with_stage_aux: bool = False,
                  stage_aux_cotangent: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The 1F1B pipelined training pass of this stage: loss and
    gradients in one schedule (see the module note).

    ``microbatches`` ``[m, mb, ...]``: the stage inputs, without a graph
    (stage 0 reads them). ``loss_fn(y, j)``: microbatch ``j``'s scalar
    loss from the last stage's output ``y``, run on the last stage only;
    the gradients of the parameters it reads accumulate there (the JAX
    ``dloss_params`` partials: the caller sums them over the axis).
    ``stage_fn``'s parameters take their gradients on each stage.

    Returns ``(loss_sum, d_microbatches)``: the loss summed over the
    microbatches and the cotangent of the inputs, both replicated over
    the axis. ``with_stage_aux``: ``stage_fn(x) -> (y, aux)``, the
    constant ``stage_aux_cotangent`` seeded beside the activation
    cotangent in every backward, and a third result: this stage's aux
    summed over its microbatches' forwards (per stage).
    """
    if with_stage_aux and stage_aux_cotangent is None:
        raise ValueError("with_stage_aux=True requires stage_aux_cotangent")
    ax = grid_axis(axis_name)
    n, i, m = ax.size, ax.index, microbatches.shape[0]
    ticks = _Ticks(ax, microbatches) if n > 1 else None
    resid: Dict[int, torch.Tensor] = {}
    d_micro = torch.zeros_like(microbatches)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    aux_acc = None
    act_in = cot_in = dy_buf = None
    for t in range(m + 2 * n - 1):
        if ticks:
            ticks.wait()
        # forward of microbatch t - i, no graph (rematerialized below)
        j_f = t - i
        y = new_dy = None
        if _valid(j_f, m):
            x_in = microbatches[j_f] if i == 0 else act_in
            with torch.no_grad():
                y, aux = _split_aux(stage_fn(x_in), with_stage_aux)
            if aux is not None:
                aux_acc = aux if aux_acc is None else aux_acc + aux
            if i == n - 1:
                y_leaf = y.detach().requires_grad_()
                with torch.enable_grad():
                    loss_j = loss_fn(y_leaf, j_f)
                    loss_j.backward()
                loss_acc += loss_j.detach()
                new_dy = y_leaf.grad
            resid[j_f] = x_in
        # backward of microbatch t - (2n - 1) + i, from its stored input
        j_b = t - (2 * n - 1) + i
        dx = None
        if _valid(j_b, m):
            x = resid.pop(j_b).detach().requires_grad_()
            g = dy_buf if i == n - 1 else cot_in
            with torch.enable_grad():
                y_b, aux_b = _split_aux(stage_fn(x), with_stage_aux)
            if aux_b is None:
                torch.autograd.backward(y_b, g)
            else:
                torch.autograd.backward([y_b, aux_b],
                                        [g, stage_aux_cotangent])
            dx = x.grad
            if i == 0:
                d_micro[j_b] = dx
        dy_buf = new_dy
        if ticks:
            act_in = (torch.empty_like(microbatches[0])
                      if i > 0 and _valid(t + 1 - i, m) else None)
            cot_in = (torch.empty_like(microbatches[0])
                      if i < n - 1 and _valid(t + 2 - 2 * n + i, m)
                      else None)
            ticks.post(
                send_next=(y.contiguous() if y is not None and i < n - 1
                           else None),
                send_prev=dx.contiguous() if dx is not None and i > 0
                else None,
                recv_prev=act_in, recv_next=cot_in)
    if ticks:
        ticks.wait()
        tdist.all_reduce(loss_acc, group=ax.group)  # the last stage's
    if with_stage_aux:
        return loss_acc, _broadcast_from(d_micro, ax, 0), aux_acc
    return loss_acc, _broadcast_from(d_micro, ax, 0)
