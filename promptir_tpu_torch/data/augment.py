"""Host-side crop and augmentation primitives (numpy, uint8 domain).

A copy of promptir_tpu/data/augment.py, the reference's
utils/image_utils.py:
  * `crop_to_multiple`: `crop_img` (:58-64), a center crop to a multiple
    of `base`;
  * `dihedral`: `data_augmentation` (:134-165), one of 8 flipud / rot90
    combinations;
  * `random_augmentation`: (:177-182), a mode drawn in 1..7: the identity
    mode 0 is never drawn in the reference, and is not here;
  * `random_crop`: `crop_patch` (:49-55), the same random window from every
    image of a pair.
All randomness flows through an explicit numpy Generator, drawn in the
JAX package's order, so the same generator gives the same patches.
"""

from __future__ import annotations

import numpy as np


def crop_to_multiple(image: np.ndarray, base: int = 16) -> np.ndarray:
    """Center-crop HWC image so H and W are multiples of `base`."""
    h, w = image.shape[:2]
    ch, cw = h % base, w % base
    return image[ch // 2 : h - ch + ch // 2, cw // 2 : w - cw + cw // 2, :]


def dihedral(image: np.ndarray, mode: int) -> np.ndarray:
    """Apply dihedral transform `mode` in 0..7 (0 = identity)."""
    if mode == 0:
        return image
    if mode == 1:
        return np.flipud(image)
    if mode == 2:
        return np.rot90(image)
    if mode == 3:
        return np.flipud(np.rot90(image))
    if mode == 4:
        return np.rot90(image, k=2)
    if mode == 5:
        return np.flipud(np.rot90(image, k=2))
    if mode == 6:
        return np.rot90(image, k=3)
    if mode == 7:
        return np.flipud(np.rot90(image, k=3))
    raise ValueError(f"invalid augmentation mode {mode}")


def random_augmentation(
    rng: np.random.Generator, *images: np.ndarray
) -> list[np.ndarray]:
    """Apply one shared random mode in 1..7 to every image (never identity,
    matching the reference)."""
    mode = int(rng.integers(1, 8))
    return [np.ascontiguousarray(dihedral(im, mode)) for im in images]


def random_crop(
    rng: np.random.Generator, patch: int, *images: np.ndarray
) -> list[np.ndarray]:
    """Crop the same random patch window from every image."""
    h, w = images[0].shape[:2]
    i = int(rng.integers(0, h - patch + 1))
    j = int(rng.integers(0, w - patch + 1))
    return [im[i : i + patch, j : j + patch] for im in images]
