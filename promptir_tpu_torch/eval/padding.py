"""Padding helpers for whole-image inference, on tensors or numpy arrays.

Counterpart of promptir_tpu/eval/padding.py (target_size,
pad_to_multiple_flip, pad_to_multiple_reflect, crop) and of
promptir_tpu/parallel/spatial.py:pad_bases, kept as the port's own copies:
the JAX modules import JAX. The flip pad is the reference's test-time pad
(test.py:100-104): the flipped image appended, then cropped to the target
size. Reflect padding is the reference demo's (demo.py:17-24, torch
`F.pad(mode="reflect")`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# the pad bases' families (promptir_tpu/parallel/spatial.py:229-238)
_OCAB_FAMILIES = frozenset(
    {"xrestormerir", "promptxrestormerir", "promptxrestormereffir"})
_CAMIXER_XR_FAMILIES = frozenset(
    {"capromptxrestormereff", "capromptxrestormereffv2",
     "catapromptxrestormer"})
_UFORMER_FAMILIES = frozenset({"promptuformerir", "capromptuformerir"})
_WINDOW_FREE = frozenset(
    {"promptir", "easypromptxrestormer", "nafnet", "nafnetlocal"})


def pad_bases(model_name: str, n_shards: int = 1) -> tuple[int, int]:
    """(base_h, base_w) to pad an image to before a whole-image forward of
    `model_name` over `n_shards` H-stripes (1: one card), the JAX
    package's formula (promptir_tpu/parallel/spatial.py:241-263):
      * the X-Restormer skeletons run 8x8 windows (OCAB or CAMixer) at all
        four levels, so both sides are multiples of 8 * 2^3 = 64; sharded
        OCAB windows each stripe, so H is a multiple of 64 n; CAMixer routes
        through a gather, so only even stripes (8 n) join the global 64;
      * the Uformer skeletons downsample four times to H/16 and window
        there: 128, and H also a multiple of 16 n for even stripes;
      * the window-free families (PromptIR, Easy, NAFNet) need only even
        stripes through three downsamples: 8 n, and 8 on W (NAFNet pads to
        its own multiple of 16 inside the model).
    """
    n = int(n_shards)
    if model_name in _UFORMER_FAMILIES:
        return math.lcm(128, 16 * n), 128
    if model_name in _OCAB_FAMILIES:
        return 64 * n, 64
    if model_name in _CAMIXER_XR_FAMILIES:
        return math.lcm(64, 8 * n), 64
    if model_name in _WINDOW_FREE:
        return 8 * n, 8
    known = (_OCAB_FAMILIES | _CAMIXER_XR_FAMILIES | _UFORMER_FAMILIES
             | _WINDOW_FREE)
    raise KeyError(f"unknown model {model_name!r}; available: {sorted(known)}")


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
