"""Every-epoch checkpoints with resume.

Counterpart of promptir_tpu/train/checkpoints.py (orbax), with the
capability of the reference's `ModelCheckpoint(every_n_epochs=1,
save_top_k=-1)` and `fit(..., ckpt_path=...)` resume (train.py:334,341):
every epoch is kept, and a restore brings back the model, the optimizer,
the epoch, the step count and the random state. The format is the port's
own: one `torch.save` file a epoch, `epoch_NNNN.pt`. A save writes a
temporary file and renames it over the target, so a crash mid-save never
leaves a torn checkpoint, and a replayed epoch simply replaces its file.
Saves are synchronous.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from promptir_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:04d}.pt")

    def all_epochs(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState) -> None:
        device = next(state.model.parameters()).device
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "epoch": state.epoch,
            "step": state.step,
            "rng_cpu": torch.get_rng_state(),
        }
        if device.type == "cuda":
            payload["rng_cuda"] = torch.cuda.get_rng_state(device)
        target = self.path(epoch)
        tmp = f"{target}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)

    def restore(self, state: TrainState, epoch: Optional[int] = None) -> TrainState:
        """Load epoch `epoch` (default the latest) into `state` in place."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self.path(epoch), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.epoch = int(payload["epoch"])
        state.step = int(payload["step"])
        torch.set_rng_state(payload["rng_cpu"].cpu())
        if device.type == "cuda":
            torch.cuda.set_rng_state(payload["rng_cuda"].cpu(), device)
        return state
