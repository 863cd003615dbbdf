"""BMP read with numpy.

The port's own reader (the machine with the card has no PIL), for the
uncompressed (`BI_RGB`) bitmaps that image corpora hold: 24-bit BGR, 32-bit
BGRX (the fourth byte ignored, as PIL reads it), and 8-bit with a palette
of BGRX entries; rows bottom-up or top-down (a negative height), each
padded to 4 bytes. The image reads back as HWC uint8 RGB, as PIL's
`convert("RGB")` gives it. Anything else (RLE or bitfield compression, 1,
4 or 16 bits a pixel, the OS/2 core header) raises a ValueError that names
the file and what it does not support.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"
INFO_HEADERS = (40, 52, 56, 64, 108, 124)  # BITMAPINFOHEADER and later
MAX_SIDE = 1 << 20


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes as HWC uint8 RGB."""
    if data[:2] != SIGNATURE or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize not in INFO_HEADERS or len(data) < 14 + hsize:
        raise ValueError(f"{name}: BMP header of {hsize} bytes is not supported")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    (colors,) = struct.unpack_from("<I", data, 46)
    if compression != 0:
        raise ValueError(f"{name}: compressed BMP (compression {compression}) "
                         "is not supported: only BI_RGB")
    if bits not in (8, 24, 32):
        raise ValueError(f"{name}: {bits}-bit BMP is not supported "
                         "(8-bit palette, 24 and 32 bits only)")
    top_down = h < 0
    h = abs(h)
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE):
        raise ValueError(f"{name}: BMP size {w}x{h} out of range")
    stride = (w * bits + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: BMP pixel data truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        n = min(colors or 256, 256)
        if 14 + hsize + 4 * n > len(data):
            raise ValueError(f"{name}: BMP palette truncated")
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + hsize).reshape(n, 4)
        lut = np.zeros((256, 3), np.uint8)  # indices past the palette: black
        lut[:n] = pal[:, 2::-1]
        return lut[rows[:, :w]]
    px = bits // 8
    return np.ascontiguousarray(
        rows[:, : w * px].reshape(h, w, px)[:, :, 2::-1])


def read_bmp(path: str) -> np.ndarray:
    """The BMP at `path` as HWC uint8 RGB."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)
