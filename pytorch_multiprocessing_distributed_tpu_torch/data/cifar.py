"""CIFAR-10 without torchvision (the port of the JAX package's
``data/cifar.py``).

Reads the standard ``cifar-10-batches-py`` pickle archive (the bytes
torchvision's ``datasets.CIFAR10`` parses for the reference, which
assumes the data is on disk: no download). :func:`synthetic_cifar10` is
the deterministic, class-separable stand-in every test and smoke run
uses; from the same seed it gives the JAX package's bytes.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]  # uint8 [N,32,32,3], int32 [N]


def _read_batch(path: str) -> Arrays:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"labels"], np.int32)
    return np.ascontiguousarray(images), labels


def load_cifar10(root: str = "./cifar10_data", train: bool = True) -> Arrays:
    """A CIFAR-10 split from ``{root}/cifar-10-batches-py`` as NHWC
    uint8 images and int32 labels; FileNotFoundError when it is
    missing."""
    base = os.path.join(root, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    images, labels = [], []
    for name in names:
        x, y = _read_batch(os.path.join(base, name))
        images.append(x)
        labels.append(y)
    return np.concatenate(images), np.concatenate(labels)


def synthetic_cifar10(n: int = 50000, *, seed: int = 0,
                      num_classes: int = 10) -> Arrays:
    """Deterministic learnable fake CIFAR: a fixed low-frequency pattern
    per class plus Gaussian noise, so a model can fit it."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    protos = np.stack([
        127.5 + 80.0 * np.stack([
            np.sin(2 * np.pi * ((c + 1) * xx / 3 + c / num_classes)),
            np.cos(2 * np.pi * ((c + 2) * yy / 3)),
            np.sin(2 * np.pi * (xx + yy) * (c + 1) / 4),
        ], axis=-1)
        for c in range(num_classes)])  # [C, 32, 32, 3]
    noise = rng.normal(0.0, 24.0, size=(n, 32, 32, 3)).astype(np.float32)
    images = np.clip(protos[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels
