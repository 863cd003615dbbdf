"""Decoder level-1 entry seam (kernel 3).

`seam` replaces promptir_tpu/ops/pallas/seam.py:222 shuffle_concat_pad:
pixel-shuffle x2 of the `up2_1` conv output (torch's channel order
cc * 4 + 2 i + j) placed beside the `enc1` skip, NHWC in and out. Pure data
movement: the kernel (csrc/seam.cu) and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from promptir_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def seam(y, skip):
    """y: (B, Hc, Wc, 4c) conv output; skip: (B, 2Hc, 2Wc, c).
    Returns (B, 2Hc, 2Wc, 2c): [pixel_shuffle(y) | skip] along channels."""
    b, hc, wc, c4 = y.shape
    c = c4 // 4
    if c4 % 4 or skip.shape != (b, 2 * hc, 2 * wc, c):
        raise ValueError(f"seam: y {tuple(y.shape)} and skip "
                         f"{tuple(skip.shape)} do not fit")
    if y.device.type == "cpu":
        return seam_plain(y, skip)
    if skip.device != y.device or skip.dtype != y.dtype:
        raise TypeError("seam: skip must match y's device and dtype")
    y, skip = y.contiguous(), skip.contiguous()
    per_piece = 16 // y.element_size()  # values of one 16-byte copy
    if c % per_piece or y.data_ptr() % 16 or skip.data_ptr() % 16:
        raise ValueError(f"seam: the kernel moves 16-byte pieces: c ({c}) "
                         f"must be a multiple of {per_piece} and y and skip "
                         "16-byte aligned")
    out = torch.empty((b, 2 * hc, 2 * wc, 2 * c), device=y.device,
                      dtype=y.dtype)
    fn = build.function("seam_launch", [_I, _P, _P, _P] + [_I] * 4 + [_P])
    with build.on_card_of(y):
        code = fn(build.dtype_code(y), y.data_ptr(), skip.data_ptr(),
                  out.data_ptr(), b, 2 * hc, 2 * wc, c, build.stream_of(y))
    build.check(code, "seam")
    seam.launches += 1
    return out


seam.launches = 0


def seam_plain(y, skip):
    """The same function in plain PyTorch."""
    b, hc, wc, c4 = y.shape
    c = c4 // 4
    up = y.reshape(b, hc, wc, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return torch.cat([up.reshape(b, 2 * hc, 2 * wc, c), skip], dim=-1)
