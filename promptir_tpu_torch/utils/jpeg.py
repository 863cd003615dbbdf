"""Baseline JPEG read, through the port's own C++ decoder.

The machine with the card has no PIL, and the all-in-one corpora hold JPEG:
the dehaze training pairs (`synthetic/*.jpg`, `original/*.jpg`) and SOTS'
hazy inputs. `native/jpeg_decode.cpp` decodes baseline sequential Huffman
JPEG the way libjpeg (PIL's libjpeg-turbo) does with its defaults: the
ISLOW integer IDCT, fancy (triangle) chroma upsampling at 4:2:2 and 4:2:0,
the fixed-point YCbCr -> RGB, gray replicated; so `read_jpeg` equals
`np.asarray(Image.open(path).convert("RGB"))` bit for bit. No EXIF
rotation is applied, as `Image.open` applies none. Progressive,
arithmetic-coded, lossless, 12-bit and CMYK/YCCK files raise a ValueError
naming the file and the feature; so do a Huffman table that libjpeg
refuses and a frame of more pixels than PIL opens (twice
`Image.MAX_IMAGE_PIXELS`), which is refused before any buffer is made.

The decoder is C++ and not Python because the training loader decodes
every JPEG sample each time it is drawn: Huffman decoding in a Python loop
would cost far more than a training step. It is built at first use with
the host's `g++` and loaded with ctypes, which releases the GIL during the
call, so the loader's threads decode side by side (utils/cxx.py). A
missing `g++` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from promptir_tpu_torch.utils import cxx

ERR_LEN = 256


def _declare(cdll: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cdll.jpeg_header.argtypes = [
        u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    cdll.jpeg_header.restype = ctypes.c_int
    cdll.jpeg_decode_rgb.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_char_p, ctypes.c_int]
    cdll.jpeg_decode_rgb.restype = ctypes.c_int


LIBRARY = cxx.Library("jpeg_decode", ["jpeg_decode.cpp"],
                      ("-O2", "-fPIC", "-shared", "-std=c++17"),
                      declare=_declare)


def lib() -> ctypes.CDLL:
    return LIBRARY.load()


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes as HWC uint8 RGB."""
    cdll = lib()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(ERR_LEN)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if cdll.jpeg_header(src, len(data), ctypes.byref(w), ctypes.byref(h),
                        err, ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if cdll.jpeg_decode_rgb(src, len(data),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            err, ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The JPEG at `path` as HWC uint8 RGB."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
