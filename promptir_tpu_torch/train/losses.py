"""Losses of the training path.

Counterpart of promptir_tpu/train/losses.py: the L1 restoration loss,
`nn.L1Loss` in the reference (train.py:32,43), taken in float32, and the
CAMixer ratio loss, which keeps the mean routing decision near 0.5 (the
reference's camixer_prompt_xrestormer_effv2.py:932, added to L1 as
train_capromptxrestormer.py:58-60 does), and the GAN loss, LSGAN (MSE) or
vanilla (BCE with logits) as the reference's GANLoss
(utils/loss_utils.py:6-45) computes it; nothing in either training path
calls the GAN loss, it is the JAX package's public API.
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def ratio_loss(decision: torch.Tensor, ratio: float) -> torch.Tensor:
    """2 * ratio * (decision - 0.5)^2 of the mean routing decision."""
    return 2.0 * ratio * (decision.float() - 0.5).square()


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             gan_type: str = "lsgan") -> torch.Tensor:
    """LSGAN (mse) or vanilla (bce-with-logits) GAN objective."""
    target = torch.full_like(logits, 1.0 if target_is_real else 0.0)
    if gan_type == "lsgan":
        return (logits - target).square().mean()
    if gan_type in ("vanilla", "bce"):
        return (logits.clamp_min(0) - logits * target
                + torch.log1p(torch.exp(-logits.abs()))).mean()
    raise ValueError(f"unknown gan_type {gan_type}")
