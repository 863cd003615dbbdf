"""Restoration metrics.

Counterpart of promptir_tpu/eval/metrics.py. Only PSNR is ported so far,
which the training demo needs; SSIM and the rest wait for the evaluation
runner (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import torch


def psnr(clean: torch.Tensor, restored: torch.Tensor) -> torch.Tensor:
    """skimage-compatible PSNR of each batch element (B,) of NHWC inputs in
    [0, 1] (data range 1), computed in float32; the caller clips, as
    metrics.py:psnr expects."""
    err = (clean.float() - restored.float()).square().mean(dim=(1, 2, 3))
    return -10.0 * torch.log10(err)
