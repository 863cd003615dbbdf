"""Padding helpers for whole-image inference, on tensors or numpy arrays.

Counterpart of promptir_tpu/eval/padding.py (target_size,
pad_to_multiple_reflect, crop) and of the one-chip case of
promptir_tpu/parallel/spatial.py:pad_bases, kept as the port's own copies:
the JAX modules import JAX. Reflect padding is the reference demo's
(demo.py:17-24, torch `F.pad(mode="reflect")`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# (base_h, base_w) of each ported model: the X-Restormer families run 8x8
# OCAB windows at all four levels, so both sides must be multiples of
# 8 * 2^3 = 64; window-free PromptIR needs only even sizes through three
# downsamples.
_PAD_BASES = {
    "promptir": (8, 8),
    "xrestormerir": (64, 64),
    "promptxrestormerir": (64, 64),
}


def pad_bases(model_name: str) -> tuple[int, int]:
    """(base_h, base_w) to pad an image to before a whole-image forward of
    `model_name` on one card."""
    if model_name not in _PAD_BASES:
        raise KeyError(f"no pad base for {model_name!r}: it is not ported "
                       "(see ROADMAP.md)")
    return _PAD_BASES[model_name]


def target_size(h: int, w: int, base) -> tuple[int, int]:
    """Next (H, W) multiples of `base`: one int for both, or (base_h, base_w)."""
    bh, bw = (base, base) if isinstance(base, int) else base
    return (h + bh - 1) // bh * bh, (w + bw - 1) // bw * bw


def pad_to_multiple_reflect(x, base: int = 8):
    """Reflect-pad NHWC `x` (tensor or array) at the bottom and right to
    multiples of `base`."""
    _, h, w, _ = x.shape
    th, tw = target_size(h, w, base)
    if isinstance(x, np.ndarray):
        return np.pad(x, ((0, 0), (0, th - h), (0, tw - w), (0, 0)),
                      mode="reflect")
    y = F.pad(x.permute(0, 3, 1, 2), (0, tw - w, 0, th - h), mode="reflect")
    return y.permute(0, 2, 3, 1)


def crop(x, h: int, w: int):
    return x[:, :h, :w, :]
