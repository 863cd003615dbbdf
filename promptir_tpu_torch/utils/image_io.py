"""Image saving and loading on the host, through the port's PNG codec.

Counterpart of promptir_tpu/utils/image_io.py, with utils/png.py in place
of PIL. The save path is the reference's (`save_image_tensor`,
utils/image_io.py:157; `np_to_pil`, utils/image_utils.py:287-302): clip to
[0, 1], scale by 255 and cast to uint8, which truncates (no rounding).
"""

from __future__ import annotations

import numpy as np

from promptir_tpu_torch.utils.png import read_png, write_png


def to_uint8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def save_image(path: str, img01_hwc: np.ndarray) -> None:
    """Write an HWC RGB image in [0, 1] to `path` as PNG."""
    write_png(path, to_uint8(img01_hwc))


def load_image01(path: str) -> np.ndarray:
    """The PNG at `path` as HWC float32 RGB in [0, 1]."""
    return read_png(path).astype(np.float32) / 255.0
