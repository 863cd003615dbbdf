"""Image saving and loading on the host, through the port's own codecs.

Counterpart of promptir_tpu/utils/image_io.py, with utils/png.py,
utils/jpeg.py and utils/bmp.py in place of PIL. A file is read by what its
first bytes say it is (PNG, JPEG or BMP), not by its extension. The save
path is the reference's (`save_image_tensor`, utils/image_io.py:157;
`np_to_pil`, utils/image_utils.py:287-302): clip to [0, 1], scale by 255
and cast to uint8, which truncates (no rounding), written as PNG.
"""

from __future__ import annotations

import numpy as np

from promptir_tpu_torch.utils.bmp import decode_bmp
from promptir_tpu_torch.utils.jpeg import decode_jpeg
from promptir_tpu_torch.utils.png import SIGNATURE, decode_png, write_png


def to_uint8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def save_image(path: str, img01_hwc: np.ndarray) -> None:
    """Write an HWC RGB image in [0, 1] to `path` as PNG."""
    write_png(path, to_uint8(img01_hwc))


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG, JPEG or BMP bytes, told apart by their magic bytes, as HWC
    uint8 RGB; any other format raises a ValueError naming `name`."""
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, name)
    if data[:2] == b"BM":
        return decode_bmp(data, name)
    if data[:len(SIGNATURE)] == SIGNATURE:
        return decode_png(data, name)
    raise ValueError(f"{name}: not a PNG, JPEG or BMP file")


def read_image(path: str) -> np.ndarray:
    """The image file at `path` as HWC uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def load_image01(path: str) -> np.ndarray:
    """The image at `path` as HWC float32 RGB in [0, 1]."""
    return read_image(path).astype(np.float32) / 255.0
