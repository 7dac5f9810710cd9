"""Host-side image augmentations, vectorised over the batch (the port of
the JAX package's ``data/transforms.py``).

The reference's transforms: train = RandomCrop(32, padding=8) ->
RandomHorizontalFlip -> ToTensor -> Normalize(0.5, 0.5); test =
ToTensor -> Normalize(0.5, 0.5). Images stay NHWC, as in the JAX
package; the model reads them as a channels-last view.
"""

from __future__ import annotations

import numpy as np

MEAN = 0.5
STD = 0.5


def normalize(images: np.ndarray) -> np.ndarray:
    """uint8 [N,H,W,C] -> f32 in [-1, 1]: ``(x / 255 - 0.5) / 0.5``."""
    x = images.astype(np.float32) / 255.0
    return (x - MEAN) / STD


def random_crop_flip(images: np.ndarray, rng: np.random.Generator, *,
                     padding: int = 8, flip_prob: float = 0.5
                     ) -> np.ndarray:
    """RandomCrop(32, padding) + RandomHorizontalFlip, batched: zero-pad,
    crop a random window per sample, then flip each sample with
    probability ``flip_prob``."""
    n, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (padding, padding),
                             (padding, padding), (0, 0)), mode="constant")
    ys = rng.integers(0, 2 * padding + 1, size=n)
    xs = rng.integers(0, 2 * padding + 1, size=n)
    row_idx = ys[:, None] + np.arange(h)[None, :]  # [N, H]
    col_idx = xs[:, None] + np.arange(w)[None, :]  # [N, W]
    out = padded[np.arange(n)[:, None, None], row_idx[:, :, None],
                 col_idx[:, None, :], :]
    flips = rng.random(n) < flip_prob
    out[flips] = out[flips, :, ::-1, :]
    return out
