"""Patch slicing and splicing (numpy).

A copy of promptir_tpu/data/patches.py, the reference's
utils/image_utils.py:67-98: `slice_image2patches` (a grid slice with an
edge-padded overlap) and `splice_patches2image` (its inverse, the overlap
cropped).
"""

from __future__ import annotations

import numpy as np


def slice_image_to_patches(
    image: np.ndarray, patch_size: int = 64, overlap: int = 0
) -> np.ndarray:
    """HWC -> (N, patch+overlap, patch+overlap, C); H,W must be multiples
    of patch_size."""
    h, w = image.shape[:2]
    if h % patch_size or w % patch_size:
        raise ValueError(f"image {h}x{w} is not a grid of {patch_size} px patches")
    padded = np.pad(
        image, ((overlap, overlap), (overlap, overlap), (0, 0)), mode="edge"
    )
    patches = []
    for i in range(h // patch_size):
        for j in range(w // patch_size):
            patches.append(
                padded[
                    i * patch_size : (i + 1) * patch_size + overlap,
                    j * patch_size : (j + 1) * patch_size + overlap,
                ]
            )
    return np.stack(patches)


def splice_patches_to_image(
    patches: np.ndarray, image_size, overlap: int = 0
) -> np.ndarray:
    """(N, p+overlap, p+overlap, C) -> HWC, dropping the overlap margins."""
    h, w = image_size[:2]
    patch_size = patches.shape[-2] - overlap
    out = np.zeros((h, w) + patches.shape[3:], dtype=patches.dtype)
    idx = 0
    for i in range(h // patch_size):
        for j in range(w // patch_size):
            out[
                i * patch_size : (i + 1) * patch_size,
                j * patch_size : (j + 1) * patch_size,
            ] = patches[
                idx,
                overlap : patch_size + overlap,
                overlap : patch_size + overlap,
            ]
            idx += 1
    return out
