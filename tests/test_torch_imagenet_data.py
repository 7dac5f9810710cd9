"""The port's ImageNet input (``data/imagenet.py`` and the ImageNet route
of ``get_loader``) against the JAX package's: byte-equal images and
labels, the same augmentation draws under the same ``default_rng``, the
same shards per rank and epoch, the same folder tree reading."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pytorch_multiprocessing_distributed_tpu.data import imagenet as jax_in
from pytorch_multiprocessing_distributed_tpu_torch.data import (
    imagenet as port_in)
from pytorch_multiprocessing_distributed_tpu_torch.data import pipeline

PIL = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("size,classes,seed", [(224, 1000, 0), (64, 10, 1),
                                               (36, 21841, 3)])
def test_synthetic_get_is_byte_equal(size, classes, seed):
    idx = np.array([0, 1, 7, 1_281_166, 12345, 3])
    ours = port_in.SyntheticImageNet(1_281_167, image_size=size,
                                     num_classes=classes, seed=seed)
    ref = jax_in.SyntheticImageNet(1_281_167, image_size=size,
                                   num_classes=classes, seed=seed)
    got = ours.get(idx, np.random.default_rng(0), True)
    want = ref.get(idx, np.random.default_rng(0), True)
    assert got[0].dtype == np.uint8 and got[0].shape == (6, size, size, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(ours) == len(ref) and ours.num_classes == classes


def _image(seed, w=53, h=41):
    rng = np.random.default_rng(seed)
    return PIL.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transforms_match_jax_under_the_same_rng(seed):
    im = _image(seed, w=53 + 11 * seed, h=41 + 7 * seed)
    for size in (16, 32):
        np.testing.assert_array_equal(
            port_in._random_resized_crop(im, size,
                                         np.random.default_rng(seed)),
            jax_in._random_resized_crop(im, size,
                                        np.random.default_rng(seed)))
        np.testing.assert_array_equal(port_in._center_crop(im, size),
                                      jax_in._center_crop(im, size))
    batch = np.random.default_rng(seed).integers(0, 256, (6, 8, 8, 3),
                                                 dtype=np.uint8)
    np.testing.assert_array_equal(
        port_in._synthetic_train_aug(batch, np.random.default_rng(seed)),
        jax_in._synthetic_train_aug(batch, np.random.default_rng(seed)))
    np.testing.assert_array_equal(port_in.normalize_imagenet(batch),
                                  jax_in.normalize_imagenet(batch))


@pytest.fixture
def tree(tmp_path):
    """A tiny ``train``/``val`` tree: 3 wnids (listed out of order) with
    a few images each, plus a stray file and an empty class dir."""
    for split, per in (("train", 3), ("val", 2)):
        for k, wnid in enumerate(("n03", "n01", "n02")):
            d = tmp_path / split / wnid
            d.mkdir(parents=True)
            for i in range(per):
                _image(10 * k + i, w=30 + 3 * i, h=25 + 2 * k).save(
                    d / f"img_{i}.JPEG" if i % 2 == 0 else d / f"img_{i}.png")
            (d / "notes.txt").write_text("not an image")
        (tmp_path / split / "n04").mkdir()
    return tmp_path


@pytest.mark.parametrize("train", [True, False])
def test_folder_tree_matches_jax(tree, train):
    ours = port_in.FolderImageNet(str(tree), "train", image_size=16,
                                  num_workers=2)
    ref = jax_in.FolderImageNet(str(tree), "train", image_size=16,
                                num_workers=0)
    assert ours.num_classes == ref.num_classes == 4
    assert ours.wnid_to_label == ref.wnid_to_label
    assert [os.path.relpath(p, tree) for p in ours.paths] == \
        [os.path.relpath(p, tree) for p in ref.paths]
    assert len(ours) == 9
    idx = np.array([8, 0, 4, 4, 1])
    got = ours.get(idx, np.random.default_rng(5), train)
    want = ref.get(idx, np.random.default_rng(5), train)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(FileNotFoundError):
        port_in.FolderImageNet(str(tree), "test")


def test_folder_tree_names_an_undecodable_file(tree):
    (tree / "train" / "n01" / "img_9.jpeg").write_bytes(b"not a jpeg")
    ds = port_in.FolderImageNet(str(tree), "train", image_size=8,
                                num_workers=0)
    bad = [i for i, p in enumerate(ds.paths) if p.endswith("img_9.jpeg")]
    with pytest.raises(RuntimeError, match="img_9.jpeg"):
        ds.get(np.array(bad), np.random.default_rng(0), False)


def _batches(loader, epochs):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.extend(list(loader))
    return out


@pytest.mark.parametrize("source", ["synthetic", "folder"])
@pytest.mark.parametrize("train", [True, False])
def test_indexed_loader_shards_match_jax(tree, source, train):
    """World 2: each rank's loader (``replica_ids=[r]``, the port's one
    process a rank) yields the JAX loader's batches for that rank, over
    two epochs (the shuffle and the augmentation streams move with
    ``set_epoch``); the wraparound padding is marked invalid."""
    if source == "synthetic":
        make = {m: m.SyntheticImageNet(11, image_size=8, num_classes=5,
                                       seed=2) for m in (port_in, jax_in)}
    else:
        make = {m: m.FolderImageNet(str(tree), "train", image_size=8,
                                    num_workers=0)
                for m in (port_in, jax_in)}
    for rank in (0, 1):
        kw = dict(batch_size=4, world_size=2, replica_ids=[rank],
                  train=train, with_valid=True)
        ours = _batches(port_in.IndexedLoader(make[port_in], **kw), (0, 1))
        ref = _batches(jax_in.IndexedLoader(make[jax_in], **kw), (0, 1))
        assert len(ours) == len(ref) == 2 * len(
            port_in.IndexedLoader(make[port_in], **kw))
        for a, b in zip(ours, ref):
            assert len(a) == 3 and a[0].dtype == np.float32
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # rank 1's shard ends in the wraparound padding (11 and 9 images)
    assert not np.concatenate([b[2] for b in ours]).all()


def test_indexed_loader_inline_equals_threaded():
    ds = port_in.SyntheticImageNet(10, image_size=8, num_classes=3)
    kw = dict(batch_size=4, world_size=1, train=True)
    a = list(port_in.IndexedLoader(ds, prefetch_batches=0, **kw))
    b = list(port_in.IndexedLoader(ds, prefetch_batches=2, **kw))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])


def test_indexed_loader_raises_a_producer_failure():
    class Broken(port_in.IndexedDataset):
        def __len__(self):
            return 8

        def get(self, indices, rng, train):
            raise ValueError("broken source")

    with pytest.raises(ValueError, match="broken source"):
        list(port_in.IndexedLoader(Broken(), batch_size=4, world_size=1))


def test_imagenet_route_of_get_loader(tree):
    """``--dataset imagenet`` on a tree: FolderImageNet splits, the rank's
    shard, num_classes from the tree; on ``--synthetic`` the nominal
    sizes (1,281,167 / 50,000 without ``PMDT_SMALL_SYNTH``)."""
    class Args:
        dataset, synthetic, batch_size = "imagenet", False, 4
        data_root, image_size, num_classes = str(tree), 8, 0

    train, test = pipeline.get_loader(Args, world_size=2, rank=1)
    assert isinstance(train.dataset, port_in.FolderImageNet)
    assert train.dataset.num_classes == 4 and len(test.dataset) == 6
    assert train.replica_ids == [1] and test.with_valid
    Args.synthetic = True
    train, test = pipeline.get_loader(Args)
    assert (len(train.dataset), len(test.dataset)) == (1_281_167, 50_000)
    assert train.dataset.num_classes == 1000


def test_small_synth_sizes_in_a_child():
    """Under ``PMDT_SMALL_SYNTH`` (set in a child process only) the
    synthetic ImageNet set is 1024 / 256, the JAX rule for ImageNet,
    whatever the value (CIFAR's rule reads the value)."""
    code = ("from pytorch_multiprocessing_distributed_tpu_torch.data "
            "import pipeline; print(pipeline.imagenet_synthetic_sizes(), "
            "pipeline.synthetic_sizes())")
    env = dict(os.environ, PMDT_SMALL_SYNTH="32", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "(1024, 256) (32, 8)"
