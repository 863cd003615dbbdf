"""Learning-rate schedules.

A pure-Python copy of promptir_tpu/train/schedules.py, each schedule a
`f(step_or_epoch) -> lr` closed form of the reference's scheduler library
(utils/schedulers.py). The training recipe's is `warmup_cosine`, stepped per
epoch with warmup 15 / max 150 (the reference's train.py:52-56) in its
closed form (schedulers.py:345-358). The others are the JAX package's public
API: nothing in either training path calls them.

Note: because Lightning steps the torch scheduler at epoch end with
`scheduler.step(current_epoch)`, the reference effectively trains epoch e
at closed_form(e-1) (and epoch 0 at warmup_start_lr). Both packages apply
closed_form(e) during epoch e: the intended schedule, one epoch ahead of
the reference's off-by-one quirk.
"""

from __future__ import annotations

import math
from typing import Sequence


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


def multistep_restart(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    restarts: Sequence[int] = (0,),
    restart_weights: Sequence[float] = (1.0,),
):
    """MultiStepRestartLR (schedulers.py:11-51), stateless closed form."""
    assert len(restarts) == len(restart_weights)

    def lr(epoch: int) -> float:
        weight = 1.0
        for r, w in zip(restarts, restart_weights):
            if epoch >= r:
                weight = w
        last_restart = max((r for r in restarts if r <= epoch), default=0)
        decays = sum(1 for m in milestones if last_restart < m <= epoch)
        return base_lr * weight * (gamma**decays)

    return lr


def linear(base_lr: float, total_iter: int):
    """LinearLR decay to 0 (schedulers.py:53-74)."""

    def lr(step: int) -> float:
        return base_lr * (1.0 - step / total_iter)

    return lr


def vibrate(base_lr: float, total_iter: int):
    """VibrateLR triangular-wave schedule (schedulers.py:76-119)."""

    def lr(step: int) -> float:
        process = step / total_iter
        f = 0.1
        if process < 3 / 8:
            f = 1 - process * 8 / 3
        elif process < 5 / 8:
            f = 0.2
        t_period = total_iter // 80
        t_half = t_period // 2
        t = step % t_period
        f2 = t / t_half
        if t >= t_half:
            f2 = 2 - f2
        weight = f * f2
        if step < t_half:
            weight = max(0.1, weight)
        return base_lr * weight

    return lr


def _position_from_periods(iteration: int, cumulative: Sequence[int]) -> int:
    for i, period in enumerate(cumulative):
        if iteration <= period:
            return i
    return len(cumulative) - 1


def cosine_restart(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1.0,),
    eta_min: float = 0.0,
):
    """CosineAnnealingRestartLR (schedulers.py:140-188)."""
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def lr(step: int) -> float:
        idx = _position_from_periods(step, cumulative)
        weight = restart_weights[idx]
        nearest = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        return eta_min + weight * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - nearest) / period))
        )

    return lr


def cosine_restart_cyclic(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1.0,),
    eta_mins: Sequence[float] = (0.0,),
):
    """CosineAnnealingRestartCyclicLR (schedulers.py:190-237)."""
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def lr(step: int) -> float:
        idx = _position_from_periods(step, cumulative)
        weight = restart_weights[idx]
        nearest = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        eta_min = eta_mins[idx]
        return eta_min + weight * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - nearest) / period))
        )

    return lr


def linear_warmup_decay(
    warmup_steps: int, total_steps: int, cosine: bool = True, linear_: bool = False
):
    """Step-indexed warmup + decay multiplier (schedulers.py:360-370)."""
    assert not (cosine and linear_)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return step / max(1, warmup_steps)
        if not (cosine or linear_):
            return 1.0
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        if cosine:
            return 0.5 * (1.0 + math.cos(math.pi * progress))
        return 1.0 - progress

    return fn
