"""Structured configuration of the trainer.

Counterpart of promptir_tpu/config.py, which covers the reference's
options.py field for field. This copy holds the fields the port's trainer
reads; the dataset directories, the evaluation options and the mesh,
remat and tiling knobs wait for the modules that read them (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataConfig:
    num_workers: int = 4  # loader threads


@dataclass
class TrainConfig:
    model: str = "promptir"
    epochs: int = 120
    batch_size: int = 6  # the reference's per-GPU batch
    grad_accum: int = 1  # equal microbatches per optimizer step
    lr: float = 2e-4
    warmup_epochs: int = 15
    cosine_max_epochs: int = 150
    weight_decay: float = 0.01
    grad_clip: Optional[float] = None  # global-norm clip; None: none
    seed: int = 0
    ckpt_dir: str = "ckpt/train_all"
    log_dir: str = "logs/"
    eval_every_epochs: int = 1


@dataclass
class SystemConfig:
    device: str = "cuda"  # "cpu" runs the kernels' plain versions
    compute_dtype: str = "float32"  # or "bfloat16" (float32 master weights)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    system: SystemConfig = field(default_factory=SystemConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
