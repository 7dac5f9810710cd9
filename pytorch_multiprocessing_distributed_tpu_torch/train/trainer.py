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

At each window boundary, before the fetch, the loop runs the liveness
gate (:func:`..parallel.dist.gate_collectives`: a lost peer is a named
``PeerLostError`` there, not a hang in NCCL) and the preemption check:
a SIGTERM received during the run is agreed across ranks (one
all-reduce of a max), a checkpoint that resumes at the interrupted
epoch is written (or the real end-of-epoch one of the epoch before is
kept), and the run exits 0 (JAX ``trainer.py:191-260``). Checkpoints go
through ``ckpt_backend``: ``msgpack``, the single-file payload, or
``orbax``, the sharded one (:mod:`.orbax_ckpt`; ``ckpt_async`` writes
the periodic ones in the background).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as tdist

from ..data.pipeline import ShardedLoader, prefetch
from ..ops.losses import cross_entropy_loss
from ..parallel import broadcast_int, dist
from ..utils import AverageMeter, Logger
from ..utils.plotting import draw_plot
from .checkpoint import prune_checkpoints, save_checkpoint
from .gspmd import make_eval_step_tp, make_train_step_tp
from .placement import PlacedState
from .state import TrainState
from .step import make_eval_step, make_train_step

_HANDLER_NOT_INSTALLED = object()  # signal handler sentinel (see fit)
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
                 ema_decay: Optional[float] = None,
                 ckpt_backend: str = "msgpack", ckpt_async: bool = False):
        loss_fn = loss_fn or cross_entropy_loss
        # JAX's backend choice and refusals, in its order
        self._orbax = None
        if ckpt_backend == "orbax":
            if state.zero is not None:
                raise ValueError(
                    "zero=True checkpoints via the msgpack gather-on-save "
                    "path (mode-portable artifacts); --ckpt_backend orbax "
                    "would persist the sharded layout and break --resume "
                    "round-trips — use msgpack with --zero")
            from .orbax_ckpt import OrbaxCheckpointer

            self._orbax = OrbaxCheckpointer(
                save_path, keep=keep_checkpoints or None, async_=ckpt_async)
        elif ckpt_async:
            raise ValueError(
                "ckpt_async requires ckpt_backend='orbax' (the msgpack "
                "writer is synchronous by design)")
        elif ckpt_backend != "msgpack":
            raise ValueError(
                f"ckpt_backend must be 'msgpack' or 'orbax', "
                f"got {ckpt_backend!r}")
        self.ckpt_backend = ckpt_backend
        self._preempted = False
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
        """The reference's epoch loop, under the SIGTERM handler; the
        primary rank draws the plots at the end."""
        prev_handler = self._install_preemption_handler()
        try:
            for epoch in range(self.start_epoch, self.epochs + 1):
                self.state.epoch = epoch
                self.train_epoch(epoch)
                self.validate(epoch, mode="test")
                periodic = self.save_every and epoch % self.save_every == 0
                if epoch == self.epochs or periodic:
                    # a periodic async save may overlap the next epochs;
                    # the final one is durable before fit returns
                    self._save_state(epoch, wait=epoch == self.epochs)
        finally:
            try:
                if self._orbax is not None:
                    # an async save in flight is made durable, even
                    # when an exception unwinds the loop
                    self._orbax.close()
            finally:
                # SIGTERM is not swallowed after training, even if the
                # wait above raised
                self._restore_handler(prev_handler)
        if dist.is_primary() and self.start_epoch <= self.epochs:
            draw_plot(self.save_path)
        return self.state

    def _save_state(self, epoch: int, wait: bool = True) -> None:
        """One checkpoint of the state as ``epoch`` through the
        configured backend. Every rank calls it (collectives)."""
        if self._orbax is not None:
            self._orbax.save(self.state, epoch)
            if wait:
                self._orbax.wait()
            return
        save_checkpoint(self.save_path, self.state, epoch)
        if dist.is_primary():
            prune_checkpoints(self.save_path, self.keep_checkpoints)

    # ------------------------------------------------------ preemption
    def _install_preemption_handler(self):
        """SIGTERM -> checkpoint and exit at the next window boundary.
        Installed only in the main thread; a prior Python handler is
        chained, and restored after the run."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return _HANDLER_NOT_INSTALLED
        self._preempted = False
        # None = a handler installed from C: still restored after
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True
            if callable(prev) and prev not in (
                    signal.SIG_IGN, signal.SIG_DFL, handler):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)
        return prev

    @staticmethod
    def _restore_handler(prev_handler) -> None:
        if prev_handler is not _HANDLER_NOT_INSTALLED:
            import signal

            signal.signal(signal.SIGTERM, signal.SIG_DFL
                          if prev_handler is None else prev_handler)

    def _agreed_preemption(self) -> bool:
        """Any rank's SIGTERM flag, on every rank: one all-reduce of a
        max (signal delivery skews across ranks; a rank branching into
        the save while another steps on would deadlock the group)."""
        flag = bool(self._preempted)
        if dist.get_world_size() > 1:
            t = torch.tensor([int(flag)], dtype=torch.int32,
                             device=self.device)
            tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
            flag = bool(t.item())
        return flag

    def _checkpoint_if_preempted(self, epoch: int) -> None:
        """At a window boundary: after an agreed SIGTERM, checkpoint so
        that resume redoes the interrupted epoch (keeping the real
        end-of-epoch checkpoint of ``epoch - 1`` where it exists: the
        primary's verdict, for every rank), then exit 0."""
        if not self._agreed_preemption():
            return
        if dist.is_primary():
            print(f"SIGTERM received: checkpointing at epoch {epoch} "
                  f"(resume redoes the interrupted epoch) and exiting",
                  flush=True)
        from .checkpoint import checkpoint_path

        if self._orbax is not None:
            target = self._orbax.epoch_path(epoch - 1)
            exists = self._orbax.has_epoch(epoch - 1)
        else:
            target = checkpoint_path(self.save_path, epoch - 1)
            exists = os.path.exists(target)
        if bool(broadcast_int(int(exists))):
            if dist.is_primary():
                print(f"keeping existing {target} (same resume point)",
                      flush=True)
        else:
            self.state.epoch = epoch - 1
            self._save_state(epoch - 1)
        raise SystemExit(0)

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
                # the liveness gate and the preemption check sit at the
                # window boundary, before the fetch waits on the card
                dist.gate_collectives(self.device)
                self._checkpoint_if_preempted(epoch)
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
