"""Epoch-level train and validate loops (the port of the JAX package's
``train/trainer.py``): the data-parallel step, or the GSPMD step for a
state placed on a grid (``--zero1``/``--fsdp``/``--model_parallel``,
:mod:`.gspmd`), as JAX's trainer chooses.

The reference trainer's observable behaviour: the same meters, the
``Epoch: [e][i/n]`` and ``test : [i/n]`` lines, ``Accuracy {:.2f}``,
``[epoch, loss.avg, acc]`` rows in ``train.log``/``test.log`` and the
plots, all on the primary rank. With the JAX package's two fixes of
record: eval accuracy divides the GLOBALLY summed correct count of real
(not padding) samples by the dataset size, and the LR schedule is a
function of the epoch on every rank. With an EMA (``--ema``) the evaluation
runs on the EMA params (JAX ``trainer.py:469-470``); checkpoints still
write the training params as ``params``, beside ``ema_params``.

The card runs ahead of the host: a step's metrics stay on the device
and the loop fetches them once per print window (one host sync per
window, as in JAX), so the window's wall clock over its steps is an
honest step time.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from ..data.pipeline import ShardedLoader, prefetch
from ..ops.losses import cross_entropy_loss
from ..parallel import dist
from ..utils import AverageMeter, Logger
from ..utils.plotting import draw_plot
from .checkpoint import prune_checkpoints, save_checkpoint
from .gspmd import make_eval_step_tp, make_train_step_tp
from .placement import PlacedState
from .state import TrainState
from .step import make_eval_step, make_train_step

_TRAIN_KEYS = ("loss", "prec1", "count", "skipped")
_EVAL_KEYS = ("loss", "count", "correct")


def _fetch(pending, keys):
    """The window's metric dicts as host rows: one device-to-host copy
    (the window's one sync)."""
    rows = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in pending])
    return [dict(zip(keys, row)) for row in rows.tolist()]


class Trainer:
    """Drives the steps over epochs for one rank (of the data-parallel
    group, or of the grid a :class:`.placement.PlacedState` is placed
    on)."""

    def __init__(self, *, model, optimizer, state: TrainState,
                 train_loader: ShardedLoader, test_loader: ShardedLoader,
                 save_path: str, epochs: int, device: torch.device,
                 print_freq: int = 10, start_epoch: int = 1,
                 loss_fn: Optional[Callable] = None, save_every: int = 0,
                 keep_checkpoints: int = 0, remat: bool = False,
                 grad_accum: int = 1,
                 clip_grad_norm: Optional[float] = None,
                 ema_decay: Optional[float] = None):
        loss_fn = loss_fn or cross_entropy_loss
        self.state = state
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.save_path = save_path
        self.epochs = epochs
        self.device = device
        self.print_freq = print_freq
        self.start_epoch = start_epoch
        self.save_every = save_every
        self.keep_checkpoints = keep_checkpoints
        self.ema_decay = ema_decay
        placed = isinstance(state, PlacedState)
        self.train_step = (make_train_step_tp if placed else make_train_step)(
            model, optimizer, loss_fn, remat=remat, grad_accum=grad_accum,
            clip_grad_norm=clip_grad_norm, ema_decay=ema_decay)
        self.eval_step = (make_eval_step_tp if placed else make_eval_step)(
            model, loss_fn)
        self.train_logger = Logger(os.path.join(save_path, "train.log"))
        self.test_logger = Logger(os.path.join(save_path, "test.log"))
        # what a caller reads after fit (the CLI's summary)
        self.summary = {"epoch_losses": [], "test_acc": [],
                        "first_loss": None, "last_loss": None,
                        "steps": 0, "skipped": 0,
                        "train_s": 0.0, "steady": []}

    def fit(self) -> TrainState:
        """The reference's epoch loop; the primary rank draws the plots
        at the end."""
        for epoch in range(self.start_epoch, self.epochs + 1):
            self.state.epoch = epoch
            self.train_epoch(epoch)
            self.validate(epoch, mode="test")
            periodic = self.save_every and epoch % self.save_every == 0
            if epoch == self.epochs or periodic:
                save_checkpoint(self.save_path, self.state, epoch)
                if dist.is_primary():
                    prune_checkpoints(self.save_path, self.keep_checkpoints)
        if dist.is_primary() and self.start_epoch <= self.epochs:
            draw_plot(self.save_path)
        return self.state

    def train_epoch(self, epoch: int) -> None:
        batch_time, data_time = AverageMeter(), AverageMeter()
        losses, top1 = AverageMeter(), AverageMeter()
        self.train_loader.set_epoch(epoch)
        n_batches = len(self.train_loader)
        skipped = 0
        pending = []
        t0 = window_start = end = time.time()
        first_window = None
        for i, (images, labels) in enumerate(
                prefetch(self.train_loader, self.device)):
            data_time.update(time.time() - end)
            self.state, metrics = self.train_step(self.state, images,
                                                  labels)
            self.summary["steps"] += 1
            pending.append(metrics)  # no host sync here
            if i % self.print_freq == 0 or i == n_batches - 1:
                for m in _fetch(pending, _TRAIN_KEYS):
                    # a skipped step's metrics stay out of every meter
                    if int(m["skipped"]):
                        skipped += 1
                        continue
                    losses.update(m["loss"], int(m["count"]))
                    top1.update(m["prec1"], int(m["count"]))
                    if self.summary["first_loss"] is None:
                        self.summary["first_loss"] = m["loss"]
                    self.summary["last_loss"] = m["loss"]
                now = time.time()
                batch_time.update((now - window_start) / len(pending),
                                  len(pending))
                if first_window is None:
                    first_window = (now, i)
                elif i == n_batches - 1:
                    self.summary["steady"].append(
                        (now - first_window[0], i - first_window[1]))
                window_start = now
                pending = []
                if dist.is_primary() and i % self.print_freq == 0:
                    print(
                        "Epoch: [{0}][{1}/{2}]\t"
                        "Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                        "Data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                        "Loss {loss.val:.4f} ({loss.avg:.4f})\t"
                        "Prec {top1.val:.3f}% ({top1.avg:.3f}%)".format(
                            epoch, i, n_batches, batch_time=batch_time,
                            data_time=data_time, loss=losses, top1=top1),
                        flush=True)
            end = time.time()
        self.summary["train_s"] += time.time() - t0
        self.summary["skipped"] += skipped
        self.summary["epoch_losses"].append(losses.avg)
        if dist.is_primary():
            if skipped:
                print(f"Epoch [{epoch}]: NaN/inf grad guard skipped "
                      f"{skipped}/{n_batches} step(s) (params carried "
                      "through unchanged)", flush=True)
            self.train_logger.write([epoch, losses.avg, top1.avg])

    def validate(self, epoch: int, mode: str = "test") -> float:
        """The eval loop, on the EMA params when the run tracks one (the
        training params are put back after)."""
        ema = self.state.ema if self.ema_decay else None
        if ema is None:
            return self._validate(epoch, mode)
        params = self.state.params
        with torch.no_grad():
            kept = params.clone()
            params.copy_(ema)
        try:
            return self._validate(epoch, mode)
        finally:
            with torch.no_grad():
                params.copy_(kept)

    def _validate(self, epoch: int, mode: str) -> float:
        batch_time, losses = AverageMeter(), AverageMeter()
        total_correct = 0
        self.test_loader.set_epoch(epoch)
        n_batches = len(self.test_loader)
        pending = []
        window_start = time.time()
        for i, (images, labels, valid) in enumerate(
                prefetch(self.test_loader, self.device)):
            pending.append(self.eval_step(self.state, images, labels,
                                          valid))
            if i % self.print_freq == 0 or i == n_batches - 1:
                for m in _fetch(pending, _EVAL_KEYS):
                    losses.update(m["loss"], int(m["count"]))
                    total_correct += int(m["correct"])  # global (summed)
                now = time.time()
                batch_time.update((now - window_start) / len(pending),
                                  len(pending))
                window_start = now
                pending = []
                if dist.is_primary() and i % self.print_freq == 0:
                    print(mode, ": [{0}/{1}]\t"
                          "Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                          "Loss {loss.val:.4f} ({loss.avg:.4f})".format(
                              i, n_batches, batch_time=batch_time,
                              loss=losses), flush=True)
        total_acc = 100.0 * total_correct / self.test_loader.dataset_size
        self.summary["test_acc"].append(total_acc)
        if dist.is_primary():
            print("Accuracy {:.2f}".format(total_acc), flush=True)
            self.test_logger.write([epoch, losses.avg, float(total_acc)])
        return total_acc
