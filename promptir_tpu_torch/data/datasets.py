"""Dataset definitions: sample lists and per-sample loading on the host.

Counterpart of promptir_tpu/data/datasets.py (reference
utils/dataset_utils.py), read through the port's own codecs
(utils/image_io.py: PNG, JPEG and BMP, told apart by their magic bytes;
PNG and JPEG through C++ readers) in place of PIL:
  * `PromptTrainDataset` (:15-175): the all-in-one training mix. Denoise
    ids from data_dir/noisy/denoise.txt filtered against the denoise dir
    listing, x3 per sigma; derain ids from rainy/rainTrain.txt x120; haze
    ids from hazy/hazy_outside.txt. Ground-truth paths by the reference's
    string surgery (`derain_gt_name`, `dehaze_gt_name`). A denoise sample is
    center-crop-16, a random patch, a dihedral mode and uint8 noise; a
    paired sample a joint random patch and mode; by default in one C++
    pass (data/native.py), with `use_native=False` in numpy;
  * `DenoiseTestDataset`: a clean directory (BSD68, Urban100); Gaussian
    noise at `sigma` is added when a sample is fetched, from
    `np.random.default_rng(seed + idx)`;
  * `DerainDehazeDataset`: input/ -> target/ pairs (Rain100L, SOTS
    outdoor, whose hazy inputs are JPEG); the dehaze target is the part of
    the name before '_', as PNG;
  * `TestSpecificDataset`: the demo's directory or single file.
Every draw comes from the numpy Generator passed in, in the JAX package's
order, so the samples are the JAX package's bit for bit on either path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from promptir_tpu_torch.data import native
from promptir_tpu_torch.data.augment import (
    crop_to_multiple,
    random_augmentation,
    random_crop,
)
from promptir_tpu_torch.data.degradations import (
    DE_TYPES,
    SIGMA_BY_TYPE,
    add_gaussian_noise,
)
from promptir_tpu_torch.utils.image_io import read_image

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def load_image_rgb(path: str) -> np.ndarray:
    """Load a PNG, JPEG or BMP file as HWC uint8 RGB (by its magic bytes;
    any other format raises a ValueError naming the file)."""
    return read_image(path)


def derain_gt_name(rainy_name: str) -> str:
    """'<root>/rainy/rain-X.png' -> '<root>/gt/norain-X.png'."""
    return rainy_name.split("rainy")[0] + "gt/norain-" + rainy_name.split("rain-")[-1]


def dehaze_gt_name(hazy_name: str) -> str:
    """'.../synthetic/<n>_<params>.jpg' -> '.../original/<n>.jpg'."""
    dir_name = hazy_name.split("synthetic")[0] + "original/"
    name = hazy_name.split("/")[-1].split("_")[0]
    suffix = "." + hazy_name.split(".")[-1]
    return dir_name + name + suffix


@dataclass
class Sample:
    degraded_path: Optional[str]  # None => synthesize from clean
    clean_path: str
    de_type: int


@dataclass
class PromptTrainDataset:
    """Mixed all-in-one training set with the reference's replication.

    `use_native=None` (the default, as in the JAX package) or `True`
    prepares each sample in one C++ pass (data/native.py,
    native/fused_augment.cpp): crop, dihedral, uint8-domain noise and the
    float conversion, with the noise from the library's own seeded stream.
    The draws are the JAX native path's: a denoise sample draws its window,
    its mode in 1..7 and a noise seed, a paired sample its window and mode;
    so the samples equal the JAX package's `use_native=True` samples bit
    for bit. `False` is the JAX package's numpy path (noise from the numpy
    Generator), bit-equal to its `use_native=False`. The library is built
    at first use and a failed build raises: `None` never turns into the
    numpy path.
    """

    data_file_dir: str
    denoise_dir: str
    derain_dir: str
    dehaze_dir: str
    de_type: Sequence[str] = (
        "denoise_15",
        "denoise_25",
        "denoise_50",
        "derain",
        "dehaze",
    )
    patch_size: int = 128
    seed: int = 0
    use_native: Optional[bool] = None
    samples: List[Sample] = field(default_factory=list, init=False)

    def __post_init__(self):
        self.samples = []
        if any(t.startswith("denoise") for t in self.de_type):
            ref_file = os.path.join(self.data_file_dir, "noisy/denoise.txt")
            with open(ref_file) as f:
                wanted = {line.strip() for line in f}
            names = [n for n in sorted(os.listdir(self.denoise_dir))
                     if n in wanted]
            for task in ("denoise_15", "denoise_25", "denoise_50"):
                if task in self.de_type:
                    for _ in range(3):  # x3 replication per sigma
                        self.samples += [
                            Sample(None, os.path.join(self.denoise_dir, n),
                                   DE_TYPES[task])
                            for n in names
                        ]
        if "derain" in self.de_type:
            rel = self._list("rainy/rainTrain.txt")
            for _ in range(120):  # x120 replication
                self.samples += [
                    Sample(self.derain_dir + r,
                           derain_gt_name(self.derain_dir + r),
                           DE_TYPES["derain"])
                    for r in rel
                ]
        if "dehaze" in self.de_type:
            self.samples += [
                Sample(self.dehaze_dir + r, dehaze_gt_name(self.dehaze_dir + r),
                       DE_TYPES["dehaze"])
                for r in self._list("hazy/hazy_outside.txt")
            ]

    def _list(self, rel: str) -> List[str]:
        with open(os.path.join(self.data_file_dir, rel)) as f:
            return [line.strip() for line in f]

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int, rng: np.random.Generator):
        """Returns (de_type, degraded, clean) as float32 HWC in [0,1]."""
        s = self.samples[idx]
        p = self.patch_size
        use_native = self.use_native is not False
        if s.de_type in SIGMA_BY_TYPE:
            clean = crop_to_multiple(load_image_rgb(s.clean_path), 16)
            sigma = SIGMA_BY_TYPE[s.de_type]
            if use_native:
                h, w = clean.shape[:2]
                ci = int(rng.integers(0, h - p + 1))
                cj = int(rng.integers(0, w - p + 1))
                mode = int(rng.integers(1, 8))
                seed = int(rng.integers(0, 2**63 - 1))
                degraded, clean_patch = native.prepare_denoise_sample(
                    clean, ci, cj, p, mode, sigma, seed)
                return s.de_type, degraded, clean_patch
            (clean_patch,) = random_crop(rng, p, clean)
            clean_patch = random_augmentation(rng, clean_patch)[0]
            degraded = add_gaussian_noise(rng, clean_patch, sigma)
        else:
            degraded_img = crop_to_multiple(load_image_rgb(s.degraded_path), 16)
            clean_img = crop_to_multiple(load_image_rgb(s.clean_path), 16)
            if use_native:
                h, w = degraded_img.shape[:2]
                ci = int(rng.integers(0, h - p + 1))
                cj = int(rng.integers(0, w - p + 1))
                mode = int(rng.integers(1, 8))
                return (s.de_type, *native.prepare_paired_sample(
                    degraded_img, clean_img, ci, cj, p, mode))
            degraded, clean_patch = random_crop(rng, p, degraded_img, clean_img)
            degraded, clean_patch = random_augmentation(rng, degraded,
                                                        clean_patch)
        return (
            s.de_type,
            degraded.astype(np.float32) / 255.0,
            clean_patch.astype(np.float32) / 255.0,
        )


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
