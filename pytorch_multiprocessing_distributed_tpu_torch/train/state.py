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

Checkpoints see flat path keys (``params/block_0/attn/wqkv/kernel``,
``batch_stats/bn1/running_mean``, ``opt_state/momentum/...``,
``opt_state/count``, ``opt_state/initialized``, ``epoch``; under LAMB
``opt_state/mu/...`` and ``opt_state/nu/...`` in the place of the
momenta) through
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

    @property
    def n(self) -> int:
        return self.params.numel()

    @classmethod
    def bind(cls, model: nn.Module, extra: int = 1,
             second_moment: bool = False) -> "TrainState":
        """Move the bound model's parameters into one flat buffer on
        their device, make them trainable leaves whose ``.grad`` views a
        flat gradient buffer (with ``extra`` metric slots after the
        gradients), zero the momenta (and, with ``second_moment``, a
        zero ``nu``), and move the model's float buffers into the flat
        ``stats``."""
        named = list(model.named_parameters())
        device = named[0][1].device
        n = sum(p.numel() for _, p in named)
        params = torch.empty(n, dtype=torch.float32, device=device)
        grads = torch.zeros(n + extra, dtype=torch.float32, device=device)
        layout, off = [], 0
        for name, p in named:
            size = p.numel()
            params[off:off + size].copy_(p.detach().reshape(-1))
            p.data = params[off:off + size].view(p.shape)
            p.requires_grad_(True)
            p.grad = grads[off:off + size].view(p.shape)
            layout.append((name, off, p.shape))
            off += size
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
                   nu=torch.zeros_like(params) if second_moment else None)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{parameter name: view of flat}`` in the model's order."""
        return {name: flat[off:off + shape.numel()].view(shape)
                for name, off, shape in self.layout}

    def stat_views(self) -> Dict[str, torch.Tensor]:
        """``{buffer name: view of stats}`` in the model's order."""
        return {name: self.stats[off:off + shape.numel()].view(shape)
                for name, off, shape in self.stats_layout}

    def _groups(self):
        moments = ((("opt_state/momentum", self.views(self.momentum)),)
                   if self.nu is None else
                   (("opt_state/mu", self.views(self.momentum)),
                    ("opt_state/nu", self.views(self.nu))))
        return (("params", self.views(self.params)),
                ("batch_stats", self.stat_views())) + moments

    def to_dict(self) -> Dict[str, object]:
        """CPU copies under flat path keys (each view copied alone,
        never the whole flat storage)."""
        out: Dict[str, object] = {}
        for prefix, views in self._groups():
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
        """Copy a :meth:`to_dict` payload into the live buffers."""
        for prefix, views in self._groups():
            for name, t in views.items():
                key = f"{prefix}/{name.replace('.', '/')}"
                src = d[key]
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {key} has shape {tuple(src.shape)}, "
                        f"the model {tuple(t.shape)}")
                t.copy_(src)
        self.count.copy_(d["opt_state/count"])
        self.initialized.copy_(d["opt_state/initialized"])
        self.epoch = int(d["epoch"])
