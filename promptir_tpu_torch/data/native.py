"""ctypes bindings of the port's native (C++) loader library.

Counterpart of promptir_tpu/data/native.py. One library from two sources
in promptir_tpu_torch/native/, built with the JAX package's Makefile flags
and linked against the host's zlib (utils/cxx.py):
  * `decode_png_rgb`: the PNG reader (png_decode.cpp), inflate, unfilter
    and RGB expansion in one call, bit-equal to utils/png.py's plain
    decoder and refusing what it refuses with its messages;
  * `prepare_denoise_sample`, `prepare_paired_sample`: crop, dihedral,
    noise and float conversion in one pass (fused_augment.cpp), bit-equal
    to the JAX package's native path, which is the JAX loader's default.
The argument types are the JAX bindings'. `CDLL` calls release the GIL,
so the loader's threads run them side by side. Unlike the JAX module this
one never returns None and never runs `make`: the library is built at
first use and a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from promptir_tpu_torch.utils import cxx

ERR_LEN = 256


def _declare(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.prepare_denoise_sample.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
        f32p, f32p,
    ]
    lib.prepare_denoise_sample.restype = None
    lib.prepare_paired_sample.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p,
    ]
    lib.prepare_paired_sample.restype = None
    lib.png_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.png_open.restype = ctypes.c_int
    lib.png_finish.argtypes = [ctypes.c_void_p, u8p]
    lib.png_finish.restype = None
    lib.png_free.argtypes = [ctypes.c_void_p]
    lib.png_free.restype = None


# native/Makefile's CXXFLAGS and link line
LIBRARY = cxx.Library(
    "promptir_native", ["png_decode.cpp", "fused_augment.cpp"],
    ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"),
    link=("-lz",), declare=_declare)


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    (the JAX module's False, on which it falls back, has no counterpart)."""
    return LIBRARY.load() is not None


def _check_window(images, ci, cj, patch, mode):
    """The C++ reads the window unchecked: hold it inside the images."""
    h, w = images[0].shape[:2]
    for im in images:
        if im.dtype != np.uint8 or im.shape != (h, w, 3):
            raise ValueError(f"HWC uint8 RGB images of one size expected, got "
                             f"{[(i.dtype, i.shape) for i in images]}")
    if not (0 <= ci <= h - patch and 0 <= cj <= w - patch and patch > 0
            and 0 <= mode < 8):
        raise ValueError(f"patch {patch} at ({ci}, {cj}) with mode {mode} "
                         f"does not fit a {h}x{w} image")


def decode_png_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes as HWC uint8 RGB; what the reader does not read raises a
    ValueError naming `name`, as utils/png.py:decode_png_plain does."""
    lib = LIBRARY.load()
    ctx = ctypes.c_void_p()
    h, w = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(ERR_LEN)
    if lib.png_open(data, len(data), ctypes.byref(ctx), ctypes.byref(w),
                    ctypes.byref(h), err, ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    try:
        out = np.empty((h.value, w.value, 3), np.uint8)
        lib.png_finish(ctx, out)
    finally:
        lib.png_free(ctx)
    return out


def prepare_denoise_sample(
    img_u8: np.ndarray,
    ci: int,
    cj: int,
    patch: int,
    mode: int,
    sigma: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(degraded, clean) float32 (patch, patch, 3) in [0, 1]: the window at
    (ci, cj) of HWC uint8 `img_u8` under dihedral `mode`, and that window
    with uint8-domain noise of `sigma` drawn from `seed`."""
    lib = LIBRARY.load()
    img = np.ascontiguousarray(img_u8)
    _check_window([img], ci, cj, patch, mode)
    h, w = img.shape[:2]
    degraded = np.empty((patch, patch, 3), np.float32)
    clean = np.empty((patch, patch, 3), np.float32)
    lib.prepare_denoise_sample(
        img, h, w, ci, cj, patch, mode, float(sigma),
        np.uint64(seed), degraded, clean,
    )
    return degraded, clean


def prepare_paired_sample(
    degraded_u8: np.ndarray,
    clean_u8: np.ndarray,
    ci: int,
    cj: int,
    patch: int,
    mode: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(degraded, clean) float32 (patch, patch, 3) in [0, 1]: the same
    window of both HWC uint8 images under the same dihedral `mode`."""
    lib = LIBRARY.load()
    d = np.ascontiguousarray(degraded_u8)
    c = np.ascontiguousarray(clean_u8)
    _check_window([d, c], ci, cj, patch, mode)
    h, w = d.shape[:2]
    degraded = np.empty((patch, patch, 3), np.float32)
    clean = np.empty((patch, patch, 3), np.float32)
    lib.prepare_paired_sample(
        d, c, h, w, ci, cj, patch, mode, degraded, clean
    )
    return degraded, clean
