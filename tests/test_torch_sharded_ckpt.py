"""The port's sharded checkpoint backend (``--ckpt_backend orbax``,
``..._torch/train/orbax_ckpt.py`` over ``torch.distributed.checkpoint``),
the twin of the JAX package's ``train/orbax_ckpt.py``
(``tests/test_orbax_ckpt.py`` pins the same semantics there): the round
trip and the latest epoch, retention of the newest K, overwriting an
epoch, an async save durable after ``wait`` (and holding the state as it
was at the save), the trainer's refusals, and the elastic restore: a
``main --fsdp`` save by a (2, 2) grid of gloo ranks, each rank writing
only its slices, read into one plain rank (and a pipelined ``train_lm``
save resumed), equal to the gathered state.

The multi-rank CLI runs go through subprocesses (their ``PMDT_*`` env is
theirs alone), one intra-op thread a rank.
"""

import os

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.models import (
    get_model, init_model)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_train_state, sgd)
from pytorch_multiprocessing_distributed_tpu_torch.train.orbax_ckpt import (
    OrbaxCheckpointer)
from pytorch_multiprocessing_distributed_tpu_torch.train.trainer import (
    Trainer)

from cli_procs import run_cli



@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0, epoch=1):
    model = init_model(get_model("res"), seed)
    st = create_train_state(model, sgd(0.1, momentum=0.9, weight_decay=1e-4,
                                       nesterov=True))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        st.momentum.copy_(torch.randn(st.n, generator=gen))
    st.epoch = epoch
    st.count.fill_(3 * epoch)
    st.initialized.fill_(True)
    return st


def _equal(a, b):
    da, db = a.to_dict(), b.to_dict()
    assert set(da) == set(db)
    for k, v in da.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, db[k]), k
        else:
            assert v == db[k], k


def test_round_trip_and_latest(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path))
    assert ck.latest_epoch() is None and not ck.has_epoch(1)
    src = _state(0, epoch=2)
    path = ck.save(src, 2)
    assert path == str(tmp_path / "orbax" / "2") and ck.has_epoch(2)
    ck.save(_state(1, epoch=5), 5)
    assert ck.latest_epoch() == 5
    back = ck.restore(_state(7), 2)
    _equal(back, src)
    assert back.epoch == 2 and int(back.count) == 6
    assert ck.restore(_state(7)).epoch == 5  # default: the latest
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(7), 3)
    assert sorted(ck.bytes_by_rank(2)) == [0]
    ck.close()


def test_retention_keeps_newest(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path), keep=2)
    st = _state(0)
    for epoch in (1, 2, 3, 4):
        ck.save(st, epoch)
    assert sorted(os.listdir(tmp_path / "orbax")) == ["3", "4"]
    assert ck.latest_epoch() == 4


def test_save_overwrites_existing_epoch(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path))
    ck.save(_state(0), 1)
    newer = _state(1)
    ck.save(newer, 1)
    _equal(ck.restore(_state(2), 1), newer)


def test_async_save_durable_after_wait(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path), async_=True)
    st = _state(0, epoch=1)
    want = _state(0, epoch=1)
    ck.save(st, 1)
    with torch.no_grad():  # training goes on over the saved buffers
        st.params.add_(1.0)
        st.momentum.mul_(2.0)
    ck.wait()
    assert ck.has_epoch(1)
    _equal(ck.restore(_state(3), 1), want)
    # a second save of the same epoch settles the first, then replaces it
    ck.save(st, 1)
    ck.save(st, 1)
    ck.close()
    _equal(OrbaxCheckpointer(str(tmp_path)).restore(_state(3), 1), st)


def test_trainer_backend_refusals(tmp_path):
    kw = dict(model=None, optimizer=None, state=_state(0),
              train_loader=None, test_loader=None, save_path=str(tmp_path),
              epochs=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="ckpt_async requires"):
        Trainer(**kw, ckpt_async=True)
    with pytest.raises(ValueError, match="must be 'msgpack' or 'orbax'"):
        Trainer(**kw, ckpt_backend="pickle")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import zero

    model = init_model(get_model("res"), 0)
    plan = zero.plan_buckets(model, 1)
    zstate = create_train_state(model, plan=plan)
    zero.zeroify_state(zstate, plan, 0)
    with pytest.raises(ValueError, match="msgpack with --zero"):
        Trainer(**{**kw, "state": zstate}, ckpt_backend="orbax")


def test_elastic_restore_of_a_2x2_fsdp_save(tmp_path):
    """One epoch of ``main --fsdp`` on a (2, 2) grid of gloo ranks, saved
    sharded and async, with the weights the run gathers itself
    (``--torch_export``): read into ONE plain rank, the restored state
    holds them bit for bit."""
    run_cli("main", ["--device", "cpu", "--world_size", "2",
                  "--model_parallel", "2", "--fsdp", "--synthetic",
                  "--batch_size", "16", "--epochs", "1", "--seed", "0",
                  "--ckpt_backend", "orbax", "--ckpt_async",
                  "--torch_export", "--save_path", str(tmp_path)],
            PMDT_SMALL_SYNTH="32")
    ck = OrbaxCheckpointer(str(tmp_path))
    assert ck.latest_epoch() == 1
    plain = ck.restore(_state(9), 1)
    got = plain.to_dict()
    state_bytes = sum(t.numel() * t.element_size() for t in got.values()
                      if isinstance(t, torch.Tensor))
    by_rank = ck.bytes_by_rank(1)
    # every rank wrote its slices: a quarter of the state each, and the
    # replicated leaves once (DCP's framing is ~1.5 KB an item)
    assert sorted(by_rank) == [0, 1, 2, 3]
    assert sum(by_rank.values()) < 1.05 * state_bytes
    assert max(by_rank.values()) < 1.1 * state_bytes / 4
    assert plain.epoch == 1 and int(plain.count) == 2  # 32 / 16 steps
    assert bool(plain.initialized) and plain.momentum.abs().sum() > 0
    export = torch.load(tmp_path / "model_1.torch.pth", weights_only=True)
    mine = plain.model.state_dict()
    floats = [k for k, v in export.items() if v.is_floating_point()]
    assert floats and all(torch.equal(mine[k], export[k]) for k in floats)


def _rows(path):
    return [[float(x) for x in line.split()] for line in open(path)]


def test_pipelined_save_resumes(tmp_path):
    """``train_lm --parallel pp --degree 2`` with the sharded backend:
    each stage writes its rows of JAX's stacked tree. Two epochs straight
    (both saved), then epoch 2 again from the epoch-1 save: the resumed
    epoch's row and sharded save equal the straight run's."""
    flags = ["--device", "cpu", "--model", "gpt_tiny", "--seq_len", "32",
             "--batch_size", "8", "--corpus_tokens", "640", "--lr", "0.01",
             "--parallel", "pp", "--degree", "2", "--epochs", "2",
             "--ckpt_backend", "orbax", "--save_path", str(tmp_path)]
    run_cli("train_lm", flags + ["--save_every", "1"], ranks=2)
    ck = OrbaxCheckpointer(str(tmp_path))
    ref = ck.load_payload(2)
    assert "params/embed" in ref and ref["params/embed"].shape[0] == 2
    os.rename(ck.epoch_path(2), str(tmp_path / "straight-2"))
    straight = _rows(tmp_path / "train.log")
    out = run_cli("train_lm", flags + ["--ckpt_async", "--resume", "auto"],
                  ranks=2)
    assert "continuing at epoch 2" in out
    rows = _rows(tmp_path / "train.log")
    assert rows[:2] == straight and rows[2] == straight[1]
    payload = ck.load_payload(2)
    assert set(payload) == set(ref)
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(payload[k], v), k
