"""Training metric logging: JSONL always; wandb and TensorBoard when asked
and installed.

Counterpart of promptir_tpu/train/metrics_logger.py, the reference's
per-step `self.log("train_loss", ...)` (train.py:45) and its `--wblogger`
(train.py:328-331): one JSON record a line, flushed at once, and the same
metrics to a wandb run when `wandb_project` is given and `wandb` imports;
otherwise the JSONL file alone, as in the JAX package. With
`use_tensorboard` the metrics also go to `torch.utils.tensorboard`'s
SummaryWriter in `log_dir`, when it imports (it needs the `tensorboard`
package); any failure to open it leaves the JSONL file alone, as the JAX
module does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str, wandb_project: Optional[str] = None,
                 use_tensorboard: bool = False):
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
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, metrics: dict, step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
