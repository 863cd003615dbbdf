"""Learning-rate schedules.

A pure-Python copy of promptir_tpu/train/schedules.py:warmup_cosine, the
schedule of the training recipe: stepped per epoch with warmup 15 / max 150
(the reference's train.py:52-56) in its closed form (schedulers.py:345-358).
The JAX module's other schedules wait for a caller.

Note: because Lightning steps the torch scheduler at epoch end with
`scheduler.step(current_epoch)`, the reference effectively trains epoch e
at closed_form(e-1) (and epoch 0 at warmup_start_lr). Both packages apply
closed_form(e) during epoch e: the intended schedule, one epoch ahead of
the reference's off-by-one quirk.
"""

from __future__ import annotations

import math


def warmup_cosine(
    base_lr: float,
    warmup_epochs: int = 15,
    max_epochs: int = 150,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
):
    """LinearWarmupCosineAnnealingLR closed form (epoch-indexed)."""

    def lr(epoch: int) -> float:
        if epoch < warmup_epochs:
            if warmup_epochs <= 1:  # degenerate warmup: straight to base
                return base_lr
            return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / (
                warmup_epochs - 1
            )
        denom = max(max_epochs - warmup_epochs, 1)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (epoch - warmup_epochs) / denom)
        )

    return lr
