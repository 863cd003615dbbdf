"""Losses of the training path.

Counterpart of promptir_tpu/train/losses.py: the L1 restoration loss,
`nn.L1Loss` in the reference (train.py:32,43), taken in float32, and the
CAMixer ratio loss, which keeps the mean routing decision near 0.5 (the
reference's camixer_prompt_xrestormer_effv2.py:932, added to L1 as
train_capromptxrestormer.py:58-60 does). The GAN loss is not ported:
nothing in the JAX package's training path calls it.
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def ratio_loss(decision: torch.Tensor, ratio: float) -> torch.Tensor:
    """2 * ratio * (decision - 0.5)^2 of the mean routing decision."""
    return 2.0 * ratio * (decision.float() - 0.5).square()
