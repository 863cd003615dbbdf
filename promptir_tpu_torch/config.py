"""Structured configuration of the trainer.

Counterpart of promptir_tpu/config.py, which covers the reference's
options.py field for field. This copy holds the fields the port's trainer
and cli/train.py read, with the JAX package's defaults; the evaluation
options and the tiling knobs wait for the modules that read them
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataConfig:
    data_file_dir: str = "data_dir/"
    denoise_dir: str = "data/Train/Denoise/"
    derain_dir: str = "data/Train/Derain/"
    dehaze_dir: str = "data/Train/Dehaze/"
    de_type: List[str] = field(
        default_factory=lambda: [
            "denoise_15",
            "denoise_25",
            "denoise_50",
            "derain",
            "dehaze",
        ]
    )
    patch_size: int = 128
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
    wandb_project: Optional[str] = None  # JSONL only when wandb is missing
    log_dir: str = "logs/"
    eval_every_epochs: int = 1


@dataclass
class SystemConfig:
    device: str = "cuda"  # "cpu" runs the kernels' plain versions
    compute_dtype: str = "float32"  # or "bfloat16" (float32 master weights)
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 2-7
    remat: bool = False  # checkpoint the transformer blocks (PromptIR)
    remat_levels: Optional[tuple] = None  # restrict remat to these levels
    n_data: Optional[int] = None  # data-parallel ranks (None: the world's)
    n_model: int = 1  # model-parallel ranks (parallel/tp.py)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    system: SystemConfig = field(default_factory=SystemConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
