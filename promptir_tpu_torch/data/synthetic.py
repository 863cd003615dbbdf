"""Synthetic datasets for the training demo, smoke runs and tests.

A copy of promptir_tpu/data/synthetic.py (pure numpy): the same seeds give
bit-identical arrays. No image corpora ship with the repository, so these
generate deterministic pseudo-natural clean images (smooth gradients plus
filtered noise) and degrade them with the real degradation operators. The
interface matches the disk-backed datasets (get(idx, rng), set_sigma).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from promptir_tpu_torch.data.degradations import SIGMA_BY_TYPE, add_gaussian_noise


def synth_clean_image(seed: int, h: int = 128, w: int = 128) -> np.ndarray:
    """Deterministic smooth pseudo-image, HWC uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij"
    )
    phase = rng.uniform(0, 2 * np.pi, (3, 4))
    freq = rng.uniform(1, 6, (3, 4, 2))
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for k in range(4):
            img[..., c] += np.sin(
                2 * np.pi * (freq[c, k, 0] * xx + freq[c, k, 1] * yy)
                + phase[c, k]
            )
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    # low-amplitude texture
    img += rng.uniform(-0.05, 0.05, img.shape)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


@dataclass
class SyntheticTrainDataset:
    """Mixed-degradation training set over synthetic clean images."""

    n: int = 64
    patch_size: int = 128
    de_types: tuple = (0, 1, 2)  # noise tasks only (paired tasks need files)
    seed: int = 1234

    def __len__(self):
        return self.n

    def get(self, idx: int, rng: np.random.Generator):
        de = self.de_types[idx % len(self.de_types)]
        clean = synth_clean_image(self.seed + idx, self.patch_size, self.patch_size)
        degraded = add_gaussian_noise(rng, clean, SIGMA_BY_TYPE[de])
        return de, degraded.astype(np.float32) / 255.0, clean.astype(np.float32) / 255.0


@dataclass
class SyntheticDenoiseTestDataset:
    n: int = 4
    size: int = 128
    sigma: float = 15.0
    seed: int = 4321

    def set_sigma(self, sigma: float):
        self.sigma = sigma

    def __len__(self):
        return self.n

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng((self.seed, idx, int(self.sigma)))
        clean = synth_clean_image(self.seed + idx, self.size, self.size)
        noisy = add_gaussian_noise(rng, clean, self.sigma)
        return (
            f"synth{idx}",
            noisy.astype(np.float32) / 255.0,
            clean.astype(np.float32) / 255.0,
        )
