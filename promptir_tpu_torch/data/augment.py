"""Host-side crops (numpy, uint8 domain).

Counterpart of promptir_tpu/data/augment.py, of which only the test sets'
crop is ported: `crop_to_multiple`, the reference's `crop_img`
(utils/image_utils.py:58-64). The dihedral and random crops of training
wait for training on real corpora (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import numpy as np


def crop_to_multiple(image: np.ndarray, base: int = 16) -> np.ndarray:
    """Center-crop HWC image so H and W are multiples of `base`."""
    h, w = image.shape[:2]
    ch, cw = h % base, w % base
    return image[ch // 2 : h - ch + ch // 2, cw // 2 : w - cw + cw // 2, :]
