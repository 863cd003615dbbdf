"""The test sets: sample lists and per-sample loading on the host.

Counterpart of the test datasets of promptir_tpu/data/datasets.py
(reference utils/dataset_utils.py:178-341), read through the port's PNG
codec (utils/png.py) in place of PIL:
  * `DenoiseTestDataset`: a clean directory (BSD68, Urban100); Gaussian
    noise at `sigma` is added when a sample is fetched, from
    `np.random.default_rng(seed + idx)`, so the noisy inputs are the JAX
    package's bit for bit;
  * `DerainDehazeDataset`: input/ -> target/ pairs (Rain100L, SOTS
    outdoor); the dehaze target is the part of the name before '_', as PNG;
  * `TestSpecificDataset`: the demo's directory or single file.
Every image is center-cropped to a multiple of 16 first. Only PNG is read:
a JPEG (or any other format) raises a ValueError naming the file. The
training dataset waits for training on real corpora (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from promptir_tpu_torch.data.augment import crop_to_multiple
from promptir_tpu_torch.data.degradations import add_gaussian_noise
from promptir_tpu_torch.utils.png import read_png

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image file as HWC uint8 RGB (PNG only; others raise)."""
    return read_png(path)


@dataclass
class DenoiseTestDataset:
    """Clean test dir (BSD68/Urban100); noise added at fetch time."""

    denoise_path: str
    sigma: float = 15.0
    seed: int = 0

    def __post_init__(self):
        self.clean_ids = [
            os.path.join(self.denoise_path, n)
            for n in sorted(os.listdir(self.denoise_path))
            if n.lower().endswith(IMAGE_EXTENSIONS)
        ]
        # idx -> the cropped clean image: each is decoded once, not once a
        # sigma (mode 0 reads the set three times)
        self._clean = {}

    def set_sigma(self, sigma: float):
        self.sigma = sigma

    def __len__(self):
        return len(self.clean_ids)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self.seed + idx)
        if idx not in self._clean:
            self._clean[idx] = crop_to_multiple(
                load_image_rgb(self.clean_ids[idx]), 16)
        clean = self._clean[idx]
        noisy = add_gaussian_noise(rng, clean, self.sigma)
        name = os.path.basename(self.clean_ids[idx]).rsplit(".", 1)[0]
        return (
            name,
            noisy.astype(np.float32) / 255.0,
            clean.astype(np.float32) / 255.0,
        )


@dataclass
class DerainDehazeDataset:
    """Paired input/ -> target/ test sets (Rain100L, SOTS outdoor)."""

    derain_path: str = ""
    dehaze_path: str = ""
    task: str = "derain"
    addnoise: bool = False
    sigma: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        self.set_dataset(self.task)

    def set_dataset(self, task: str):
        self.task = task
        root = self.derain_path if task == "derain" else self.dehaze_path
        self.ids = [
            os.path.join(root, "input", n)
            for n in sorted(os.listdir(os.path.join(root, "input")))
        ]

    def _gt_path(self, degraded: str) -> str:
        if self.task == "derain":
            return degraded.replace("input", "target")
        dir_name = degraded.split("input")[0] + "target/"
        name = degraded.split("/")[-1].split("_")[0] + ".png"
        return dir_name + name

    def __len__(self):
        return len(self.ids)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        degraded = crop_to_multiple(load_image_rgb(self.ids[idx]), 16)
        if self.addnoise:
            rng = rng or np.random.default_rng(self.seed + idx)
            degraded = add_gaussian_noise(rng, degraded, self.sigma)
        clean = crop_to_multiple(load_image_rgb(self._gt_path(self.ids[idx])), 16)
        name = os.path.basename(self.ids[idx])[:-4]
        return (
            name,
            degraded.astype(np.float32) / 255.0,
            clean.astype(np.float32) / 255.0,
        )


@dataclass
class TestSpecificDataset:
    """Demo loader: a directory of images or a single image file."""

    test_path: str

    def __post_init__(self):
        if os.path.isdir(self.test_path):
            names = [
                n
                for n in sorted(os.listdir(self.test_path))
                if n.lower().endswith(IMAGE_EXTENSIONS)
            ]
            if not names:
                raise FileNotFoundError(
                    f"no image files in directory {self.test_path}"
                )
            self.ids = [os.path.join(self.test_path, n) for n in names]
        elif self.test_path.lower().endswith(IMAGE_EXTENSIONS):
            self.ids = [self.test_path]
        else:
            raise ValueError("test_path must be an image file or directory")

    def __len__(self):
        return len(self.ids)

    def get(self, idx: int):
        img = crop_to_multiple(load_image_rgb(self.ids[idx]), 16)
        name = os.path.basename(self.ids[idx]).rsplit(".", 1)[0]
        return name, img.astype(np.float32) / 255.0
