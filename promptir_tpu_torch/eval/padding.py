"""Padding helpers for whole-image inference, on tensors or numpy arrays.

Counterpart of promptir_tpu/eval/padding.py (target_size,
pad_to_multiple_flip, pad_to_multiple_reflect, crop) and of the one-chip case of
promptir_tpu/parallel/spatial.py:pad_bases, kept as the port's own copies:
the JAX modules import JAX. The flip pad is the reference's test-time pad
(test.py:100-104): the flipped image appended, then cropped to the target
size. Reflect padding is the reference demo's (demo.py:17-24, torch
`F.pad(mode="reflect")`).
"""

from __future__ import annotations

import numpy as np
import torch


# (base_h, base_w) of each model: the X-Restormer families run 8x8 windows
# (OCAB or CAMixer) at all four levels, so both sides must be multiples of
# 8 * 2^3 = 64; the window-free families (PromptIR, Easy, NAFNet) need only
# even sizes through three downsamples (NAFNet pads to its own multiple of
# 16 inside the model); the Uformer family downsamples four times to H/16
# and runs 8x8 windows there, so both sides must be multiples of 128.
_PAD_BASES = {
    "promptir": (8, 8),
    "xrestormerir": (64, 64),
    "promptxrestormerir": (64, 64),
    "promptxrestormereffir": (64, 64),
    "capromptxrestormereff": (64, 64),
    "capromptxrestormereffv2": (64, 64),
    "catapromptxrestormer": (64, 64),
    "easypromptxrestormer": (8, 8),
    "nafnet": (8, 8),
    "nafnetlocal": (8, 8),
    "promptuformerir": (128, 128),
    "capromptuformerir": (128, 128),
}


def pad_bases(model_name: str) -> tuple[int, int]:
    """(base_h, base_w) to pad an image to before a whole-image forward of
    `model_name` on one card."""
    if model_name not in _PAD_BASES:
        raise KeyError(f"unknown model {model_name!r}; available: "
                       f"{sorted(_PAD_BASES)}")
    return _PAD_BASES[model_name]


def target_size(h: int, w: int, base) -> tuple[int, int]:
    """Next (H, W) multiples of `base`: one int for both, or (base_h, base_w)."""
    bh, bw = (base, base) if isinstance(base, int) else base
    return (h + bh - 1) // bh * bh, (w + bw - 1) // bw * bw


def pad_to_multiple_flip(x, base: int = 64):
    """Flip-concat pad NHWC `x` (tensor or array) at the bottom and right to
    multiples of `base`."""
    _, h, w, _ = x.shape
    th, tw = target_size(h, w, base)
    if isinstance(x, np.ndarray):
        cat, flip = np.concatenate, np.flip
    else:
        cat, flip = torch.cat, torch.flip
    if th != h:
        x = cat([x, flip(x, (1,))], 1)[:, :th]
    if tw != w:
        x = cat([x, flip(x, (2,))], 2)[:, :, :tw]
    return x


def _reflect_index(n: int, size: int) -> np.ndarray:
    """Source rows of a reflect pad of n rows to `size`, reflected again
    where the pad is longer than the side, as np.pad and jnp.pad do."""
    if n == 1:
        return np.zeros(size, np.int64)
    period = 2 * (n - 1)
    j = np.arange(size) % period
    return np.where(j >= n, period - j, j)


def pad_to_multiple_reflect(x, base: int = 8):
    """Reflect-pad NHWC `x` (tensor or array) at the bottom and right to
    multiples of `base` (the pad may be longer than the image)."""
    _, h, w, _ = x.shape
    th, tw = target_size(h, w, base)
    if isinstance(x, np.ndarray):
        return np.pad(x, ((0, 0), (0, th - h), (0, tw - w), (0, 0)),
                      mode="reflect")
    if (th, tw) == (h, w):
        return x
    rows = torch.from_numpy(_reflect_index(h, th)).to(x.device)
    cols = torch.from_numpy(_reflect_index(w, tw)).to(x.device)
    return x.index_select(1, rows).index_select(2, cols)


def crop(x, h: int, w: int):
    return x[:, :h, :w, :]
