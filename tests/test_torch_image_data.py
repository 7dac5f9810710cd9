"""The port's image data path against the JAX package's on the same
inputs: sampler shards, the synthetic CIFAR set, the transforms and the
loader's batches. All of it is host-side numpy/torch with no arithmetic
that could round differently, so every comparison is exact (tolerance
0): the same indices, bytes and f32 values.
"""

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.data import cifar as jax_cifar
from pytorch_multiprocessing_distributed_tpu.data import (
    pipeline as jax_pipeline)
from pytorch_multiprocessing_distributed_tpu.data import (
    transforms as jax_transforms)
from pytorch_multiprocessing_distributed_tpu.parallel import (
    sampler as jax_sampler)
from pytorch_multiprocessing_distributed_tpu_torch.data import (
    ShardedLoader, get_loader, load_cifar10, normalize, prefetch,
    random_crop_flip, synthetic_cifar10)
from pytorch_multiprocessing_distributed_tpu_torch.data.pipeline import (
    synthetic_sizes)
from pytorch_multiprocessing_distributed_tpu_torch.parallel.sampler import (
    DistributedShardSampler, padded_epoch_indices)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("size", [10, 11, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_shards_index_identical(world, size, shuffle):
    """Every rank's shard and valid mask over two epochs, with the
    wraparound padding of sizes that do not divide by the world (and a
    set smaller than the world)."""
    for epoch in (0, 1):
        ref = jax_sampler.padded_epoch_indices(size, world, shuffle=shuffle,
                                               seed=3, epoch=epoch)
        assert padded_epoch_indices(size, world, shuffle=shuffle, seed=3,
                                    epoch=epoch) == ref
        for rank in range(world):
            ours = DistributedShardSampler(size, rank, world,
                                           shuffle=shuffle, seed=3)
            theirs = jax_sampler.DistributedShardSampler(
                size, rank, world, shuffle=shuffle, seed=3)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)
            assert len(ours) == len(theirs)
            np.testing.assert_array_equal(ours.valid_mask(),
                                          theirs.valid_mask())


def test_sampler_drop_last_and_rank_check():
    assert (padded_epoch_indices(11, 3, seed=1, epoch=2, drop_last=True)
            == jax_sampler.padded_epoch_indices(11, 3, seed=1, epoch=2,
                                                drop_last=True))
    with pytest.raises(ValueError, match="out of range"):
        DistributedShardSampler(10, 2, 2)


def test_synthetic_cifar_byte_identical():
    for seed in (0, 1):
        x, y = synthetic_cifar10(96, seed=seed)
        jx, jy = jax_cifar.synthetic_cifar10(96, seed=seed)
        assert x.dtype == np.uint8 and x.shape == (96, 32, 32, 3)
        assert x.tobytes() == jx.tobytes()
        np.testing.assert_array_equal(y, jy)


def test_load_cifar10_reads_the_pickle_archive(tmp_path):
    """The torchvision pickle layout (CHW rows) comes back NHWC, as the
    JAX reader returns it; a missing archive raises."""
    import pickle

    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (3, 3072)).astype(np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": [1, 2, 3]}, f)
    for train in (True, False):
        x, y = load_cifar10(str(tmp_path), train=train)
        jx, jy = jax_cifar.load_cifar10(str(tmp_path), train=train)
        assert x.tobytes() == jx.tobytes() and x.shape == jx.shape
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(FileNotFoundError):
        load_cifar10(str(tmp_path / "nowhere"))


def test_transforms_identical():
    images, _ = synthetic_cifar10(12, seed=2)
    np.testing.assert_array_equal(normalize(images),
                                  jax_transforms.normalize(images))
    ours = random_crop_flip(images, np.random.default_rng(7))
    theirs = jax_transforms.random_crop_flip(images,
                                             np.random.default_rng(7))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("world,train", [(1, True), (2, True), (2, False),
                                         (3, False)])
def test_loader_batches_identical(world, train):
    """Each rank's loader (the port assembles one rank per process)
    yields the rows the JAX loader assigns that rank, with the same
    augmentations and validity mask, over two epochs."""
    images, labels = synthetic_cifar10(50, seed=0)
    kw = dict(batch_size=12, world_size=world, train=train,
              with_valid=not train)
    ref = jax_pipeline.ShardedLoader(images, labels, **kw)
    ours = [ShardedLoader(images, labels, replica_ids=[r], **kw)
            for r in range(world)]
    for epoch in (1, 2):
        ref.set_epoch(epoch)
        for loader in ours:
            loader.set_epoch(epoch)
        ref_batches = list(ref)
        assert len(ref_batches) == len(ours[0])
        for r, loader in enumerate(ours):
            for got, want in zip(loader, ref_batches):
                assert len(got) == len(want)
                rows = len(got[1])  # the last batch is ragged
                assert rows * world == len(want[1])
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(
                        a, b[r * rows:(r + 1) * rows])


def test_prefetch_yields_every_batch_as_tensors():
    images, labels = synthetic_cifar10(20, seed=0)
    loader = ShardedLoader(images, labels, batch_size=8, world_size=1,
                           train=False, with_valid=True)
    host = list(loader)
    got = list(prefetch(loader, torch.device("cpu")))
    assert len(got) == len(host) == 3
    for batch, ref in zip(got, host):
        for t, a in zip(batch, ref):
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), a)
    assert list(prefetch([], torch.device("cpu"))) == []


def test_get_loader_small_synth_sizes(monkeypatch, capsys):
    """``PMDT_SMALL_SYNTH`` sizes the synthetic set as the JAX
    ``get_loader`` does, and the primary rank prints the banner."""
    for value, sizes in (("8192", (8192, 2048)), ("1", (2048, 512)),
                         ("x", (2048, 512))):
        monkeypatch.setenv("PMDT_SMALL_SYNTH", value)
        assert synthetic_sizes() == sizes
    monkeypatch.setenv("PMDT_SMALL_SYNTH", "64")

    class Args:
        batch_size = 8
        synthetic = True

    train, test = get_loader(Args(), world_size=2, rank=1)
    assert (train.dataset_size, test.dataset_size) == (64, 16)
    assert train.replica_ids == [1] and test.with_valid
    assert capsys.readouterr().out == ""  # rank 1 prints nothing
    get_loader(Args())
    assert "Train Dataset : 64    Test Dataset : 16" in (
        capsys.readouterr().out)
    monkeypatch.delenv("PMDT_SMALL_SYNTH")
    assert synthetic_sizes() == (50000, 10000)
