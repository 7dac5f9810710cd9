"""Training/eval metrics and serving metrics, ported from the JAX
package's ``utils/metrics.py``.

The classification half (:func:`topk_accuracy`, :func:`accuracy`,
:func:`correct_count`) are tensor functions of ``(logits, targets)`` that
stay on the logits' device, so the train step keeps them there until the
trainer's windowed fetch (no host sync per batch).

:class:`ServingMetrics` aggregates the serving engine's host meters.
The fields are the ones this slice's engine records; ``snapshot()``
reports them under the JAX snapshot's own key names, so a consumer of
either CLI's ``--metrics_out`` reads the same keys.

- ``ttft``: seconds from SUBMIT to first token (queue wait included);
- ``queue_wait``: seconds from submit to admission;
- ``decode_step``: wall seconds per engine decode iteration (dispatch
  to drained token block);
- ``decode_window`` / ``horizon``: attention window and fused steps of
  each decode dispatch; ``dispatches`` / ``host_syncs`` /
  ``overlapped_dispatches``: the dispatch-overhead counters;
- ``occupancy`` / ``queue_depth``: live slots and queued requests per
  decode iteration;
- token and request counters for tokens/sec;
- paged KV: ``prefix_hits`` / ``prefix_partial_hits`` /
  ``prefix_misses`` (each paged admission's prefix-cache outcome),
  ``page_holds`` (admissions deferred for pages, one per hold) and
  ``requests_failed`` (requests evicted as FAILED: faults, deadlines,
  the drain deadline, the page pool);
- fault domains: ``dispatch_retries`` (transient errors absorbed by
  the bounded retry, any site), ``requests_redelivered`` (journaled
  requests re-submitted after a restart), ``watchdog_trips`` (hung
  readbacks failed fast) and ``horizon_collapses`` (dispatches held at
  horizon 1 in a post-fault cooldown);
- speculative decode: ``tokens_drafted`` / ``tokens_accepted`` (draft
  tokens proposed by the active verify passes, and accepted by them)
  and ``accept_len`` (accepted drafts per (pass, slot); tokens per
  target step = 1 + its mean).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .meters import AverageMeter, PercentileMeter


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  topk: Sequence[int] = (1,)
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(precs, correct)``: ``precs[i]`` is precision@``topk[i]`` as a
    percentage (a scalar tensor), ``correct`` the ``[maxk, batch]`` bool
    matrix "prediction j matches the target" (the reference's layout)."""
    maxk = max(topk)
    batch_size = targets.shape[0]
    _, pred = torch.topk(logits, maxk, dim=-1)  # [batch, maxk]
    correct = pred.t() == targets[None, :]
    precs = [correct[:k].float().sum() * (100.0 / batch_size)
             for k in topk]
    return precs, correct


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             topk: Sequence[int] = (1,)
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(prec@topk[0] %, squeezed correctness mask)`` — the reference's
    ``accuracy``."""
    precs, correct = topk_accuracy(logits, targets, topk)
    return precs[0], correct.squeeze()


def correct_count(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Number of argmax-correct samples (an int32 scalar tensor)."""
    pred = torch.argmax(logits, dim=-1)
    return (pred == targets).sum().to(torch.int32)


class ServingMetrics:
    """Aggregates the serving engine's operational metrics."""

    def __init__(self) -> None:
        self.ttft = PercentileMeter()
        self.queue_wait = PercentileMeter()
        self.decode_step = PercentileMeter()
        self.request_tokens = PercentileMeter()
        self.decode_window = AverageMeter()
        self.horizon = AverageMeter()
        self.occupancy = AverageMeter()
        self.queue_depth = AverageMeter()
        self.tokens_generated = 0
        self.decode_tokens = 0
        self.requests_completed = 0
        self.dispatches = 0
        self.host_syncs = 0
        self.overlapped_dispatches = 0
        self.requests_shed = 0
        self.requests_failed = 0
        self.dispatch_retries = 0
        self.requests_redelivered = 0
        self.watchdog_trips = 0
        self.horizon_collapses = 0
        self.prefix_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_misses = 0
        self.page_holds = 0
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.accept_len = PercentileMeter()
        self._elapsed = 0.0
        self._occupancy_max = 0
        self._queue_wait_max = 0.0

    def record_first_token(self, ttft_seconds: float) -> None:
        self.ttft.update(ttft_seconds)
        self.tokens_generated += 1

    def record_admission(self, queue_wait_seconds: float) -> None:
        self.queue_wait.update(queue_wait_seconds)
        self._queue_wait_max = max(self._queue_wait_max,
                                   queue_wait_seconds)

    def record_dispatch(self, horizon: int,
                        overlapped: bool = False) -> None:
        self.dispatches += 1
        self.horizon.update(horizon)
        if overlapped:
            self.overlapped_dispatches += 1

    @property
    def decode_elapsed_s(self) -> float:
        """Accumulated decode wall seconds (the productive time of a
        fleet replica's ``goodput_frac``)."""
        return self._elapsed

    def record_decode_step(self, seconds: float, tokens: int,
                           occupancy: int, queue_depth: int,
                           window: int = 0) -> None:
        self.decode_step.update(seconds)
        self.host_syncs += 1
        if window:
            self.decode_window.update(window)
        self.occupancy.update(occupancy)
        self._occupancy_max = max(self._occupancy_max, occupancy)
        self.queue_depth.update(queue_depth)
        self.tokens_generated += tokens
        self.decode_tokens += tokens
        self._elapsed += seconds

    def record_completion(self, tokens: int = 0) -> None:
        self.requests_completed += 1
        if tokens:
            self.request_tokens.update(tokens)

    def record_shed(self) -> None:
        """One submission refused at the queue bound or at a closed
        (draining or dead) admission."""
        self.requests_shed += 1

    def record_failure(self) -> None:
        """One request evicted as FAILED; the engine kept serving."""
        self.requests_failed += 1

    def record_retry(self) -> None:
        """One transient error absorbed by the bounded retry, at any of
        the engine's sites."""
        self.dispatch_retries += 1

    def record_redelivery(self) -> None:
        """One journaled unfinished request re-submitted after a
        restart."""
        self.requests_redelivered += 1

    def record_watchdog_trip(self) -> None:
        """One hung horizon readback failed fast."""
        self.watchdog_trips += 1

    def record_horizon_collapse(self) -> None:
        """One dispatch held at horizon 1 in a post-fault cooldown."""
        self.horizon_collapses += 1

    def record_prefix_outcome(self, hit) -> None:
        """One paged admission's prefix-cache outcome: ``"full"`` (no
        prefill), ``"partial"`` (leading pages reused, suffix
        prefilled) or None (miss)."""
        if hit == "full":
            self.prefix_hits += 1
        elif hit == "partial":
            self.prefix_partial_hits += 1
        else:
            self.prefix_misses += 1

    def record_spec(self, drafted: int, accept_lens) -> None:
        """One drained speculative block: ``drafted`` draft tokens
        proposed across its active verify passes, ``accept_lens`` the
        accepted-draft count of each (pass, slot), each in ``[0,
        draft_k]`` (tokens emitted by the pass = accepted + 1)."""
        self.tokens_drafted += int(drafted)
        for a in accept_lens:
            self.tokens_accepted += int(a)
            self.accept_len.update(float(a))

    def record_page_hold(self) -> None:
        """One admission deferred because the page pool could not cover
        the FIFO head; counted at the transition into the hold."""
        self.page_holds += 1

    def snapshot(self) -> dict:
        decode_tokens = self.decode_tokens
        snap = {
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "decode_tokens": decode_tokens,
            "ttft_avg_s": self.ttft.avg,
            "ttft_last_s": self.ttft.val,
            "queue_wait_avg_s": self.queue_wait.avg,
            "queue_wait_max_s": self._queue_wait_max,
            "decode_step_avg_s": self.decode_step.avg,
            "decode_window_avg": self.decode_window.avg,
            "decode_horizon_avg": self.horizon.avg,
            "decode_dispatches": self.dispatches,
            "decode_host_syncs": self.host_syncs,
            "host_syncs_per_token": (0.0 if decode_tokens <= 0 else
                                     self.host_syncs / decode_tokens),
            "overlapped_dispatches": self.overlapped_dispatches,
            "decode_tokens_per_sec": (0.0 if self._elapsed == 0
                                      else decode_tokens / self._elapsed),
            "occupancy_avg": self.occupancy.avg,
            "occupancy_max": self._occupancy_max,
            "queue_depth_avg": self.queue_depth.avg,
            "decode_steps": self.decode_step.count,
            "dispatch_retries": self.dispatch_retries,
            "requests_failed": self.requests_failed,
            "requests_shed": self.requests_shed,
            "requests_redelivered": self.requests_redelivered,
            "watchdog_trips": self.watchdog_trips,
            "horizon_collapses": self.horizon_collapses,
            "prefix_hits": self.prefix_hits,
            "prefix_partial_hits": self.prefix_partial_hits,
            "prefix_misses": self.prefix_misses,
            "page_holds": self.page_holds,
            # verify passes = accept_len samples; tokens per target step
            # is the speculative headline (1.0 = non-speculative)
            "spec_tokens_drafted": self.tokens_drafted,
            "spec_tokens_accepted": self.tokens_accepted,
            "spec_verify_passes": self.accept_len.count,
            "spec_accept_rate": (
                0.0 if self.tokens_drafted == 0
                else self.tokens_accepted / self.tokens_drafted),
            "spec_accepted_per_target_step": (
                0.0 if self.accept_len.count == 0
                else 1.0 + self.accept_len.avg),
        }
        for name, meter in (("ttft", self.ttft),
                            ("queue_wait", self.queue_wait),
                            ("decode_step", self.decode_step)):
            for q, v in meter.percentiles((50, 90, 95, 99)).items():
                snap[f"{name}_{q}_s"] = v
        for q, v in self.request_tokens.percentiles((50, 95)).items():
            snap[f"tokens_per_request_{q}"] = v
        snap["tokens_per_request_avg"] = self.request_tokens.avg
        for q, v in self.accept_len.percentiles((50, 95, 99)).items():
            snap[f"accept_len_{q}"] = v
        return snap
