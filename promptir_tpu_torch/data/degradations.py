"""On-the-fly degradation synthesis (host side, uint8 pixel domain).

A copy of promptir_tpu/data/degradations.py (pure numpy; the port imports
nothing of the JAX package). Gaussian noise is added in the uint8 pixel
domain, clip(img + N(0, 1) sigma, 0, 255) as uint8, as the reference does
(utils/degradation_utils.py:21-27). Degradation type ids follow the
reference's utils/dataset_utils.py:26:
  0: denoise sigma=15, 1: sigma=25, 2: sigma=50, 3: derain, 4: dehaze,
  5: deblur (reserved in the reference, never trained).
"""

from __future__ import annotations

import numpy as np

DE_TYPES = {
    "denoise_15": 0,
    "denoise_25": 1,
    "denoise_50": 2,
    "derain": 3,
    "dehaze": 4,
    "deblur": 5,
}
SIGMA_BY_TYPE = {0: 15.0, 1: 25.0, 2: 50.0}


def add_gaussian_noise(
    rng: np.random.Generator, clean_u8: np.ndarray, sigma: float
) -> np.ndarray:
    """clip(img + N(0,1)*sigma, 0, 255) as uint8; `clean_u8` is HWC uint8."""
    noise = rng.standard_normal(clean_u8.shape)
    return np.clip(clean_u8.astype(np.float64) + noise * sigma, 0, 255).astype(
        np.uint8
    )


def degrade_by_type(
    rng: np.random.Generator, clean_u8: np.ndarray, de_type: int
) -> np.ndarray:
    if de_type in SIGMA_BY_TYPE:
        return add_gaussian_noise(rng, clean_u8, SIGMA_BY_TYPE[de_type])
    raise ValueError(
        f"de_type {de_type} is a paired task (load degraded image from disk)"
    )


def to_float_chw_free(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] (torch ToTensor without the CHW
    transpose: the loader hands NHWC batches to the train step)."""
    return img_u8.astype(np.float32) / 255.0
