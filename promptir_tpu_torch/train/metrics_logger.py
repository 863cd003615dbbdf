"""Training metric logging to a JSONL file.

Counterpart of promptir_tpu/train/metrics_logger.py, the reference's
per-step `self.log("train_loss", ...)` (train.py:45): one JSON record a
line, flushed at once. The JAX logger's wandb and TensorBoard backends are
not ported: no caller asks for them.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
