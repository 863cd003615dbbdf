"""On-the-fly degradation synthesis (host side, uint8 pixel domain).

A copy of the noise synthesis of promptir_tpu/data/degradations.py (pure
numpy; the port imports nothing of the JAX package). Gaussian noise is added in the uint8 pixel
domain, clip(img + N(0, 1) sigma, 0, 255) as uint8, as the reference does
(utils/degradation_utils.py:21-27). Degradation type ids follow the
reference's utils/dataset_utils.py:26:
  0: denoise sigma=15, 1: sigma=25, 2: sigma=50, 3: derain, 4: dehaze,
  5: deblur (reserved in the reference, never trained).
"""

from __future__ import annotations

import numpy as np

SIGMA_BY_TYPE = {0: 15.0, 1: 25.0, 2: 50.0}


def add_gaussian_noise(
    rng: np.random.Generator, clean_u8: np.ndarray, sigma: float
) -> np.ndarray:
    """clip(img + N(0,1)*sigma, 0, 255) as uint8; `clean_u8` is HWC uint8."""
    noise = rng.standard_normal(clean_u8.shape)
    return np.clip(clean_u8.astype(np.float64) + noise * sigma, 0, 255).astype(
        np.uint8
    )
