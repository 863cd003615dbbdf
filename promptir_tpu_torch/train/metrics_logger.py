"""Training metric logging: JSONL always; wandb when asked and installed.

Counterpart of promptir_tpu/train/metrics_logger.py, the reference's
per-step `self.log("train_loss", ...)` (train.py:45) and its `--wblogger`
(train.py:328-331): one JSON record a line, flushed at once, and the same
metrics to a wandb run when `wandb_project` is given and `wandb` imports;
otherwise the JSONL file alone, as in the JAX package. Its
TensorBoard backend is not ported (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str, wandb_project: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(project=wandb_project, dir=log_dir)

    def log(self, metrics: dict, step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
