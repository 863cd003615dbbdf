"""Train state and optimizer construction.

Counterpart of promptir_tpu/train/state.py. Optimizer parity with the
reference's `optim.AdamW(params, lr=2e-4)` with torch's defaults: betas
(0.9, 0.999), eps 1e-8 and weight decay 0.01 on all params (train.py:52-53);
the JAX package builds the same with optax (`make_optimizer`, state.py:24).
The learning rate lives in the optimizer's param group, so the per-epoch
schedule sets it in place (`set_learning_rate`).

`TrainState` holds what a checkpoint restores: the model (its float32
weights are the master weights, whatever dtype the forward computes in),
the optimizer, the epoch and the step count. The step updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 2e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm when their global norm is
    above max_norm, as optax.clip_by_global_norm does; returns the norm
    before clipping."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0  # the last finished epoch, once one is
    step: int = 0
    grad_clip: Optional[float] = None  # global-norm clip before the update
