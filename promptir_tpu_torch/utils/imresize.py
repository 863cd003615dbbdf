"""MATLAB-compatible image resize (cubic/linear, antialiased).

A numpy copy of promptir_tpu/utils/imresize.py, itself after the
reference's utils/imresize.py (a numpy port of MATLAB imresize, unused in
the reference main path): the standard MATLAB contributions algorithm,
kernel-weighted gathers with the kernel widened by the scale factor when
shrinking (antialiasing), and replicated edges. It runs on the host.
"""

from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


def _linear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return (1.0 - ax) * (ax <= 1)


_KERNELS = {"cubic": (_cubic, 4.0), "bicubic": (_cubic, 4.0),
            "linear": (_linear, 2.0), "bilinear": (_linear, 2.0)}


def _contributions(in_len, out_len, scale, kernel, kwidth, antialias):
    if scale < 1 and antialias:
        def k(x):
            return scale * kernel(scale * x)

        width = kwidth / scale
    else:
        k = kernel
        width = kwidth
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - width / 2)
    p = int(np.ceil(width)) + 2
    fov = left[:, None] + np.arange(p)[None, :] - 1
    # the reference casts the field of view to uint64 BEFORE computing
    # weights (imresize.py:113-118): negative (left-edge) taps wrap to huge
    # values and get kernel weight 0; right-edge taps mirror-reflect.
    fov_u = fov.astype(np.uint64)
    weights = k(u[:, None] - fov_u.astype(np.float64) - 1)
    s = np.sum(weights, axis=1, keepdims=True)
    s[s == 0] = 1.0
    weights = weights / s
    mirror = np.concatenate(
        [np.arange(in_len), np.arange(in_len - 1, -1, -1)]
    ).astype(np.uint64)
    idx = mirror[np.mod(fov_u, np.uint64(mirror.shape[0]))].astype(np.int64)
    keep = np.any(weights != 0, axis=0)
    return weights[:, keep], idx[:, keep]


def imresize(
    img: np.ndarray,
    scale: float | None = None,
    output_shape: tuple | None = None,
    method: str = "cubic",
    antialias: bool = True,
) -> np.ndarray:
    """Resize HxW or HxWxC image with MATLAB semantics (double precision)."""
    kernel, kwidth = _KERNELS[method]
    h, w = img.shape[:2]
    if output_shape is not None:
        oh, ow = output_shape[:2]
        scale_h, scale_w = oh / h, ow / w
    else:
        scale_h = scale_w = float(scale)
        oh, ow = int(np.ceil(h * scale_h)), int(np.ceil(w * scale_w))

    wts_h, idx_h = _contributions(h, oh, scale_h, kernel, kwidth, antialias)
    wts_w, idx_w = _contributions(w, ow, scale_w, kernel, kwidth, antialias)
    out = _resize_axis(img.astype(np.float64), wts_h, idx_h, 0)
    out = _resize_axis(out, wts_w, idx_w, 1)
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def _resize_axis(x: np.ndarray, weights: np.ndarray, idx: np.ndarray, axis: int):
    xm = np.moveaxis(x, axis, 0)
    gathered = xm[idx]  # (out, p, ...)
    res = np.einsum("op,op...->o...", weights, gathered)
    return np.moveaxis(res, 0, axis)
