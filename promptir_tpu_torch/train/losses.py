"""Losses of the training path.

Counterpart of promptir_tpu/train/losses.py: the L1 restoration loss,
`nn.L1Loss` in the reference (train.py:32,43), taken in float32. The
CAMixer ratio loss and the GAN loss wait for the models that use them.
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()
