"""Checkpoint save/load (the port of the JAX package's
``train/checkpoint.py``, msgpack-free subset).

The artifact is the port's own: ``torch.save`` of the state's flat
path dict (:meth:`..train.state.TrainState.to_dict`: params, the BN
running stats under ``batch_stats/``, momenta, count, initialized and
epoch) under the JAX name ``model_{epoch}.pth``, written by the primary rank with the
same durability and integrity as JAX: tmp write -> fsync -> atomic
rename -> fsync of the directory, then a ``.sha256`` sidecar of the
exact payload bytes written AFTER the payload is durable. A ``--zero``
state's moment shards, and a placed state's slices (``--zero1``,
``--fsdp``, ``--model_parallel``, ``train_lm --parallel tp``), are
gathered first, on every rank (JAX's gather-on-save), so the payload
has the replicated format and ``--resume`` round-trips between sharded
and plain runs. A pipelined state (``train_lm --parallel pp``) gathers
its stages into JAX's stacked tree and each stage takes its slice back
on resume (:class:`..parallel.gpt_pipeline.PipelinedState`). Loads verify
the sidecar first (a torn or bit-flipped file raises
:class:`CheckpointCorruptError` naming both digests) and unpickle with
``weights_only=True``. Reading a JAX msgpack checkpoint is not in this
slice (ROADMAP.md).

The payload passes the ``train.checkpoint_write`` fault site after its
digest is taken, as in JAX: an injected ``corrupt`` fault is caught by
the digest check on load and :func:`load_with_fallback` resumes from
the previous valid epoch; an injected ``error`` is a named fatal that
``--max_restarts`` restarts from.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
from typing import Optional, Tuple

import torch

from ..parallel import broadcast_int, is_primary
from ..parallel.zero import gather_opt_state
from ..runtime.faults import GraftFaultError, maybe_fault, register_site
from .state import TrainState

# the torn-artifact hazard: fires on the payload right before it
# reaches the OS, so an injected corruption meets the digest check
_SITE_WRITE = register_site(
    "train.checkpoint_write",
    "msgpack checkpoint payload write + fsync + atomic rename")


class CheckpointCorruptError(GraftFaultError):
    """A checkpoint's bytes do not match its recorded sha256 digest."""


def checkpoint_path(save_path: str, epoch: int) -> str:
    """``{save_path}/model_{epoch}.pth``."""
    return os.path.join(save_path, "model_{0}.pth".format(epoch))


def digest_path(path: str) -> str:
    """Sidecar holding the checkpoint's sha256 (hex)."""
    return path + ".sha256"


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # filesystems whose dirfds reject fsync: rename-only
        pass
    finally:
        os.close(fd)


def write_atomic_durable(path: str, payload: bytes) -> None:
    """tmp-write -> fsync(file) -> atomic rename -> fsync(parent dir)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def save_checkpoint(save_path: str, state: TrainState,
                    epoch: int) -> Optional[str]:
    """Write the state on the primary rank; returns the path (None on
    the other ranks). A stale sidecar of the same epoch is removed
    before the payload is replaced, so a crash between the two writes
    leaves a valid checkpoint with no digest, never a wrong digest.
    Every rank calls it: a ``--zero`` state gathers its moments first,
    a placed state its slices (collectives)."""
    moments = {} if state.zero is None else gather_opt_state(state)
    gather = getattr(state, "gathered", None)
    if gather is not None:
        state = gather()  # a placed state's slices, on every rank
    if not is_primary():
        return None
    path = checkpoint_path(save_path, epoch)
    buf = io.BytesIO()
    torch.save(state.to_dict(**moments), buf)
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    written = maybe_fault(_SITE_WRITE, payload)
    dpath = digest_path(path)
    if os.path.exists(dpath):
        os.remove(dpath)
    write_atomic_durable(path, written)
    write_atomic_durable(dpath, digest.encode("ascii"))
    return path


def verify_checkpoint(path: str, payload: Optional[bytes] = None) -> bool:
    """True when ``path`` matches its sidecar or has none; raises
    :class:`CheckpointCorruptError` on a mismatch. ``payload``: the
    file's bytes when already read."""
    dpath = digest_path(path)
    if not os.path.exists(dpath):
        return True
    with open(dpath, "rb") as f:
        expected = f.read().decode("ascii").strip()
    if payload is None:
        with open(path, "rb") as f:
            payload = f.read()
    actual = hashlib.sha256(payload).hexdigest()
    if actual != expected:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is corrupt: sha256 {actual} does not "
            f"match the recorded digest {expected} ({dpath}) — torn write, "
            "truncation, or bit rot")
    return True


def load_checkpoint(path: str, state: TrainState,
                    verify: bool = True) -> TrainState:
    """Restore ``path`` into ``state`` (its live buffers, in place) and
    return it. The bytes are read once: the digest check and the loader
    share the buffer."""
    with open(path, "rb") as f:
        payload = f.read()
    if verify:
        verify_checkpoint(path, payload)
    state.load_dict(torch.load(io.BytesIO(payload), map_location="cpu",
                               weights_only=True))
    return state


def _checkpoint_epochs(save_path: str):
    """``[(epoch, filename), ...]`` for every parseable ``model_*.pth``."""
    found = []
    if not os.path.isdir(save_path):
        return found
    for name in os.listdir(save_path):
        if name.startswith("model_") and name.endswith(".pth"):
            try:
                found.append((int(name[len("model_"):-len(".pth")]), name))
            except ValueError:
                continue
    return found


def prune_checkpoints(save_path: str, keep: int) -> None:
    """Delete all but the ``keep`` highest-epoch checkpoints (and their
    sidecars); ``keep <= 0`` keeps all."""
    if keep <= 0:
        return
    for _, name in sorted(_checkpoint_epochs(save_path))[:-keep]:
        path = os.path.join(save_path, name)
        os.remove(path)
        if os.path.exists(digest_path(path)):
            os.remove(digest_path(path))


def checkpoint_epoch(path: str) -> Optional[int]:
    """Epoch parsed from a ``model_<epoch>.pth`` path, else None."""
    name = os.path.basename(path)
    if name.startswith("model_") and name.endswith(".pth"):
        try:
            return int(name[len("model_"):-len(".pth")])
        except ValueError:
            pass
    return None


def resolve_auto_resume(save_path: str) -> Optional[str]:
    """``--resume auto``: the primary rank's newest checkpoint decides
    for every rank (``save_path`` must be shared); None when there is
    none."""
    found = _checkpoint_epochs(save_path)
    epoch = broadcast_int(max(found)[0] if found else -1)
    if epoch < 0:
        return None
    match = [name for e, name in found if e == epoch]
    if not match:
        raise FileNotFoundError(
            f"--resume auto: the primary rank resolved epoch {epoch} but "
            f"this rank has no matching model_*.pth under {save_path} — "
            "auto-resume across ranks needs a shared save_path")
    return os.path.join(save_path, match[0])


def load_with_fallback(save_path: str, state: TrainState, *,
                       anchor: Optional[int] = None
                       ) -> Tuple[TrainState, str]:
    """Resume from the newest VALID checkpoint at or below ``anchor``:
    a corrupt one is reported on stderr (primary rank) and skipped.
    Raises the last :class:`CheckpointCorruptError` when every one is
    corrupt, ``FileNotFoundError`` when there is none."""
    found = _checkpoint_epochs(save_path)
    if anchor is not None:
        found = [(e, n) for e, n in found if e <= anchor]
    last_err: Optional[CheckpointCorruptError] = None
    for _, name in sorted(found, reverse=True):
        path = os.path.join(save_path, name)
        try:
            return load_checkpoint(path, state), path
        except CheckpointCorruptError as e:
            last_err = e
            if is_primary():
                print(f"[pmdt] {e}\n[pmdt] falling back to the previous "
                      "checkpoint", file=sys.stderr)
    if last_err is not None:
        raise last_err
    raise FileNotFoundError(f"no model_*.pth checkpoints under {save_path!r}")
