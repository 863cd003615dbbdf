"""Bilinear resize with `F.interpolate` semantics.

Counterpart of promptir_tpu/ops/resize.py, which imitates this op:
align_corners=False in the canonical PromptIR (reference
net/model.py:232).
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, out_hw, align_corners: bool = False):
    """Resize NCHW `x` to `out_hw`; returns x itself when the size matches."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)
