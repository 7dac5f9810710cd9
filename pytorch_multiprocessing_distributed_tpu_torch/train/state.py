"""Train state: the model's parameters, gradients and momenta as flat
buffers (the port of the JAX package's ``TrainState``).

JAX threads an immutable pytree through a compiled step. The port keeps
the same fields — params, batch stats, momentum, ``initialized``,
``count``, epoch — but in place: every parameter of the bound model is a
view of ONE flat f32 buffer, every ``.grad`` a view of another (autograd
accumulates into it), and the momenta a third. The optimizer then
updates whole buffers, the gradient all-reduce is one call, and the NaN
guard one ``where``. The model's floating buffers (the BatchNorm running
stats) are views of a fourth flat buffer, ``stats``: they are state, not
trained — outside the gradient all-reduce and the optimizer, but saved,
restored and guarded like the params. LAMB's state also carries the
second moment ``nu``; its first moment is the ``momentum`` buffer.
With ``--ema`` the state also carries ``ema``, a flat f32 exponential
moving average of the params (the JAX ``ema_params``), seeded from them.

The flat layout is the model's parameter order, end to end. Under
``--zero`` it is the bucket plan's instead (:mod:`..parallel.zero`:
the JAX tree's leaf order, each bucket padded with zeros to a multiple
of the world size), and :func:`..parallel.zero.zeroify_state` then
replaces the momenta by this rank's shards.

Checkpoints see flat path keys (``params/block_0/attn/wqkv/kernel``,
``batch_stats/bn1/running_mean``, ``opt_state/momentum/...``,
``opt_state/count``, ``opt_state/initialized``, ``epoch``; under LAMB
``opt_state/mu/...`` and ``opt_state/nu/...`` in the place of the
momenta; with an EMA ``ema_params/...``) through
:meth:`TrainState.to_dict` and :meth:`TrainState.load_dict`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    params: torch.Tensor       # flat f32 [n]; the model's params view it
    grads: torch.Tensor        # flat f32 [n + extra]; [:n] the params'
                               # .grad, [n:] the step's metric slots
                               # (they ride the gradient all-reduce)
    momentum: torch.Tensor     # flat f32 [n] (LAMB: the first moment)
    initialized: torch.Tensor  # bool scalar: False until the first update
    count: torch.Tensor        # int32 scalar: updates applied
    stats: torch.Tensor        # flat f32; the model's float buffers view it
    epoch: int = 1             # current epoch (drives the LR schedule)
    layout: List[Tuple[str, int, torch.Size]] = field(default_factory=list)
    stats_layout: List[Tuple[str, int, torch.Size]] = field(
        default_factory=list)
    nu: Optional[torch.Tensor] = None  # flat f32 [n]: LAMB's 2nd moment
    ema: Optional[torch.Tensor] = None  # flat f32 [n]: the params' EMA
    # under --zero: the bucket plan (parallel.zero.ZeroPlan); the momenta
    # (and nu) are then this rank's shards, and grad_shards receives the
    # reduce-scattered gradients
    zero: Optional[object] = None
    grad_shards: Optional[torch.Tensor] = None
    _segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, repr=False)

    @property
    def n(self) -> int:
        return self.params.numel()

    @classmethod
    def bind(cls, model: nn.Module, extra: int = 1,
             second_moment: bool = False, ema: bool = False,
             offsets: Optional[Dict[str, int]] = None,
             size: Optional[int] = None) -> "TrainState":
        """Move the bound model's parameters into one flat buffer on
        their device, make them trainable leaves whose ``.grad`` views a
        flat gradient buffer (with ``extra`` metric slots after the
        gradients), zero the momenta (and, with ``second_moment``, a
        zero ``nu``; with ``ema``, an EMA equal to the params), and move
        the model's float buffers into the flat ``stats``. ``offsets``
        (``{name: first element}``) and ``size`` lay the buffer out
        another way (a :class:`..parallel.zero.ZeroPlan`'s); the rest of
        it holds zeros."""
        named = list(model.named_parameters())
        device = named[0][1].device
        if offsets is None:
            offsets, off = {}, 0
            for name, p in named:
                offsets[name] = off
                off += p.numel()
            size = off
        params = torch.zeros(size, dtype=torch.float32, device=device)
        grads = torch.zeros(size + extra, dtype=torch.float32,
                            device=device)
        layout = []
        for name, p in named:
            off, numel = offsets[name], p.numel()
            params[off:off + numel].copy_(p.detach().reshape(-1))
            p.data = params[off:off + numel].view(p.shape)
            p.requires_grad_(True)
            p.grad = grads[off:off + numel].view(p.shape)
            layout.append((name, off, p.shape))
        bufs = [(name, b) for name, b in model.named_buffers()
                if b.is_floating_point()]
        stats = torch.empty(sum(b.numel() for _, b in bufs),
                            dtype=torch.float32, device=device)
        stats_layout, off = [], 0
        for name, b in bufs:
            size = b.numel()
            stats[off:off + size].copy_(b.reshape(-1))
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    stats[off:off + size].view(b.shape))
            stats_layout.append((name, off, b.shape))
            off += size
        return cls(model=model, params=params, grads=grads,
                   momentum=torch.zeros_like(params),
                   initialized=torch.zeros((), dtype=torch.bool,
                                           device=device),
                   count=torch.zeros((), dtype=torch.int32, device=device),
                   stats=stats, layout=layout, stats_layout=stats_layout,
                   nu=torch.zeros_like(params) if second_moment else None,
                   ema=params.clone() if ema else None)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{parameter name: view of flat}`` in the model's order."""
        return {name: flat[off:off + shape.numel()].view(shape)
                for name, off, shape in self.layout}

    def stat_views(self) -> Dict[str, torch.Tensor]:
        """``{buffer name: view of stats}`` in the model's order."""
        return {name: self.stats[off:off + shape.numel()].view(shape)
                for name, off, shape in self.stats_layout}

    def spread(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """A flat ``[n]`` tensor holding ``per_leaf[i]`` (one value per
        parameter, in the model's order) over the elements of leaf
        ``i``, and 0 in the layout's pads."""
        if self._segments is None:
            # the buffer's runs in order: each leaf, and a pad before it
            # or at the end (index len(layout): the zero appended below)
            sizes, index, end = [], [], 0
            for i, (_, off, shape) in sorted(
                    enumerate(self.layout), key=lambda e: e[1][1]):
                if off > end:
                    sizes.append(off - end)
                    index.append(len(self.layout))
                sizes.append(shape.numel())
                index.append(i)
                end = off + shape.numel()
            if self.n > end:
                sizes.append(self.n - end)
                index.append(len(self.layout))
            dev = self.params.device
            self._segments = (torch.tensor(sizes, device=dev),
                              torch.tensor(index, device=dev))
        sizes, index = self._segments
        values = torch.cat([per_leaf, per_leaf.new_zeros(1)])[index]
        return torch.repeat_interleave(values, sizes, output_size=self.n)

    def _groups(self, momentum=None, nu=None):
        momentum = self.momentum if momentum is None else momentum
        nu = self.nu if nu is None else nu
        moments = ((("opt_state/momentum", self.views(momentum)),)
                   if nu is None else
                   (("opt_state/mu", self.views(momentum)),
                    ("opt_state/nu", self.views(nu))))
        ema = (() if self.ema is None else
               (("ema_params", self.views(self.ema)),))
        return (("params", self.views(self.params)),
                ("batch_stats", self.stat_views())) + moments + ema

    def to_dict(self, momentum: Optional[torch.Tensor] = None,
                nu: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """CPU copies under flat path keys (each view copied alone,
        never the whole flat storage). A zero-sharded state passes its
        gathered moments (:func:`..parallel.zero.gather_opt_state`)."""
        if self.zero is not None and momentum is None:
            raise ValueError(
                "a zero-sharded state holds moment shards: pass the "
                "moments gathered by parallel.zero.gather_opt_state")
        out: Dict[str, object] = {}
        for prefix, views in self._groups(momentum, nu):
            for name, t in views.items():
                key = f"{prefix}/{name.replace('.', '/')}"
                out[key] = t.detach().to("cpu", copy=True)
        out["opt_state/count"] = self.count.detach().to("cpu", copy=True)
        out["opt_state/initialized"] = self.initialized.detach().to(
            "cpu", copy=True)
        out["epoch"] = int(self.epoch)
        return out

    @torch.no_grad()
    def load_dict(self, d: Dict[str, object]) -> None:
        """Copy a :meth:`to_dict` payload into the live buffers (a
        replicated state: load before :func:`..parallel.zero.
        zeroify_state`). A state with an EMA whose payload has none seeds
        it from the payload's params (the JAX resume rule: never from the
        fresh init)."""
        if self.zero is not None:
            raise ValueError("load a checkpoint before zeroify_state")
        has_ema = any(k.startswith("ema_params/") for k in d)
        for prefix, views in self._groups():
            if prefix == "ema_params" and not has_ema:
                continue
            for name, t in views.items():
                key = f"{prefix}/{name.replace('.', '/')}"
                src = d[key]
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {key} has shape {tuple(src.shape)}, "
                        f"the model {tuple(t.shape)}")
                t.copy_(src)
        if self.ema is not None and not has_ema:
            self.ema.copy_(self.params)
        self.count.copy_(d["opt_state/count"])
        self.initialized.copy_(d["opt_state/initialized"])
        self.epoch = int(d["epoch"])
