"""The training harness: epochs on one card, or on each rank of a mesh.

Counterpart of promptir_tpu/train/trainer.py, the reference's Lightning
setup (train.py:303-341): the train step of step.py, the
per-epoch warmup-cosine learning rate, a checkpoint every epoch, an
epoch-end evaluation hook (train.py:134-172), JSONL (and wandb) metric
logging, a SIGTERM/SIGINT guard that checkpoints and returns, and the
profiler window: with `cfg.system.profile_dir` set, a torch.profiler trace
of the global steps [2, 7) of the first epoch run, written there as a
Chrome trace.

Inside a rank of a distributed run (parallel/mesh.py:launch) the trainer
builds its mesh from `cfg.system.n_data` and `n_model`
(promptir_tpu/train/trainer.py:45-47): the global batch is `batch_size *
n_data`, each rank loads its rows of it and the step averages the gradient
over the data group. At start rank 0's weights and buffers are broadcast to
every rank. Rank 0 alone writes checkpoints, logs, the profiler trace and
runs the epoch-end evaluation; every rank resumes from the same checkpoint;
the ranks agree at every step whether one was preempted (one all_reduce of
a flag, which waits for the step), and rank 0 saves once. A stochastic
model (train/step.py:STOCHASTIC) with more than one data rank raises.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from promptir_tpu_torch.config import Config
from promptir_tpu_torch.data.loader import TrainLoader
from promptir_tpu_torch.models import create_model
from promptir_tpu_torch.parallel.mesh import all_reduce_sum, broadcast, create_mesh
from promptir_tpu_torch.train.checkpoints import CheckpointManager
from promptir_tpu_torch.train.metrics_logger import MetricLogger
from promptir_tpu_torch.train.preemption import PreemptionGuard
from promptir_tpu_torch.train.schedules import warmup_cosine
from promptir_tpu_torch.train.state import TrainState, make_optimizer, set_learning_rate
from promptir_tpu_torch.train.step import make_eval_step, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PROFILE_STEPS = (2, 7)  # the profiler window, global steps [start, stop)


class ProfilerWindow:
    """torch.profiler over the train steps whose global step lies in
    PROFILE_STEPS (the JAX trainer's jax.profiler window), CPU activity and,
    on the card, CUDA kernels. The trace goes to `out_dir` as
    `train_steps_2-7.pt.trace.json` when the window closes: at its last
    step, or at the end of a run too short to reach it."""

    def __init__(self, out_dir: Optional[str], device: torch.device):
        self.out_dir, self.device = out_dir, device
        self.prof = None
        self.done = not out_dir

    def before_step(self, step: int) -> None:
        if self.done or self.prof is not None or step < PROFILE_STEPS[0]:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def after_step(self, step: int) -> None:
        if self.prof is not None and step >= PROFILE_STEPS[1]:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "train_steps_{}-{}.pt.trace.json"
                            .format(*PROFILE_STEPS))
        self.prof.export_chrome_trace(path)
        self.prof, self.done = None, True
        print(f"profiler trace written to {path}")


class NullLogger:
    """The logger of a rank other than 0: logs nothing."""

    def log(self, metrics: dict, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(
        self,
        cfg: Config,
        dataset,
        model=None,
        eval_hook: Optional[Callable] = None,
        preemption_guard: Optional[PreemptionGuard] = None,
    ):
        """`model`: a model built with `create_model(..., train=True)`; by
        default `cfg.train.model` on `cfg.system.device`, computing in
        `cfg.system.compute_dtype`, its weights drawn from `cfg.train.seed`.
        `eval_hook(eval_step, model) -> dict` runs every
        `cfg.train.eval_every_epochs` epochs and its metrics are logged.
        `cfg.system.remat` (and `remat_levels`) go to the default model as
        the JAX trainer passes them (trainer.py:51-54); a model without
        those options raises its TypeError. Inside a distributed run the
        mesh is `cfg.system.n_data` x `n_model` ranks."""
        self.cfg = cfg
        self.mesh = create_mesh(cfg.system.n_data, cfg.system.n_model,
                                cfg.system.device)
        self.lead = self.mesh.rank == 0
        self.global_batch = cfg.train.batch_size * self.mesh.n_data
        if model is None:
            model_kw = {}
            if cfg.system.remat:
                model_kw["remat"] = True
                if cfg.system.remat_levels:
                    model_kw["remat_levels"] = tuple(cfg.system.remat_levels)
            torch.manual_seed(cfg.train.seed)
            model = create_model(cfg.train.model, device=cfg.system.device,
                                 dtype=DTYPES[cfg.system.compute_dtype],
                                 train=True, **model_kw)
        self.model = model
        self.device = next(model.parameters()).device
        self.world = dist.group.WORLD if dist.is_initialized() else None
        broadcast(list(model.parameters()) + list(model.buffers()), self.world)
        self.dataset = dataset
        self.eval_hook = eval_hook
        self.loader = TrainLoader(
            dataset,
            batch_size=cfg.train.batch_size,
            seed=cfg.train.seed,
            num_workers=cfg.data.num_workers,
            pin_memory=self.device.type == "cuda",
            rank=self.mesh.data_rank,
            world=self.mesh.n_data,
            microbatches=cfg.train.grad_accum,
        )
        self.state = TrainState(
            model, make_optimizer(model.parameters(), cfg.train.lr,
                                  cfg.train.weight_decay),
            grad_clip=cfg.train.grad_clip)
        self.step_fn = make_train_step(model, cfg.train.grad_accum,
                                       cfg.train.seed, self.mesh.data_group)
        self.eval_step = make_eval_step(model)
        self.schedule = warmup_cosine(
            cfg.train.lr, cfg.train.warmup_epochs, cfg.train.cosine_max_epochs
        )
        self.ckpt = CheckpointManager(cfg.train.ckpt_dir)
        self.logger = (MetricLogger(cfg.train.log_dir, cfg.train.wandb_project)
                       if self.lead else NullLogger())
        self.profiler = ProfilerWindow(
            cfg.system.profile_dir if self.lead else None, self.device)
        self.start_epoch = 0
        # pass a guard to share it (cooperative shutdown, tests); by default
        # fit() installs one for its own duration
        self.preemption = preemption_guard

    @property
    def global_step(self) -> int:
        return self.state.step

    def resume(self, epoch: Optional[int] = None) -> None:
        self.ckpt.restore(self.state, epoch)
        self.start_epoch = self.state.epoch + 1
        if self.lead:
            print(f"resumed from epoch {self.state.epoch}")

    def _save_preempted(self, epoch: int) -> None:
        """Checkpoint so that `resume()` replays the interrupted epoch: the
        state is saved mid-epoch but tagged epoch - 1. The partial progress
        of the interrupted epoch is kept in the weights."""
        self.state.epoch = epoch - 1
        if self.lead:
            self.ckpt.save(epoch, self.state)
        self.logger.log({"preempted_in_epoch": epoch}, self.global_step)
        self.logger.close()
        if self.lead:
            print(f"preempted in epoch {epoch}: checkpoint saved "
                  "(resume replays the epoch)")

    def _preempted(self, guard) -> bool:
        """Whether any rank was preempted (this process's guard alone
        outside a distributed run)."""
        if self.world is None:
            return guard.preempted()
        flag = torch.tensor([float(guard.preempted())], device=self.device)
        return bool(all_reduce_sum(flag, self.world).item())

    def fit(self) -> None:
        guard = self.preemption
        own_guard = guard is None
        if own_guard:
            guard = PreemptionGuard()
        try:
            self._fit_epochs(guard)
        finally:
            self.profiler.close()
            # an installed but orphaned handler would swallow SIGTERM and
            # Ctrl-C for the rest of the process
            if own_guard:
                guard.restore()

    def _fit_epochs(self, guard) -> None:
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.train.epochs):
            lr = self.schedule(epoch)
            set_learning_rate(self.state.optimizer, lr)
            t0 = time.time()
            losses = []
            for batch in self.loader.epoch(epoch):
                self.profiler.before_step(self.global_step)
                metrics = self.step_fn(self.state, batch)
                self.profiler.after_step(self.global_step)
                losses.append(metrics["train_loss"])
                if self._preempted(guard):
                    self._save_preempted(epoch)
                    return
                if self.global_step % 50 == 0:
                    self.logger.log({"train_loss": float(metrics["train_loss"]),
                                     "lr": lr, "epoch": epoch},
                                    self.global_step)
            epoch_loss = (float(torch.stack(losses).mean()) if losses
                          else float("nan"))
            self.profiler.close()  # a first epoch shorter than the window
            dt = time.time() - t0
            imgs = len(self.loader) * self.global_batch
            if self.lead:
                print(f"epoch {epoch}: loss {epoch_loss:.4f} lr {lr:.2e} "
                      f"{imgs / max(dt, 1e-9):.1f} img/s")
            # an epoch-level record always: the per-step one is every 50
            # steps, so a short run would leave metrics.jsonl empty
            self.logger.log({"train_loss": epoch_loss, "lr": lr, "epoch": epoch,
                             "imgs_per_sec": imgs / max(dt, 1e-9)},
                            self.global_step)
            self.state.epoch = epoch
            if self.lead:
                self.ckpt.save(epoch, self.state)
            if (self.lead and self.eval_hook is not None
                    and (epoch + 1) % cfg.train.eval_every_epochs == 0):
                self.logger.log(self.eval_hook(self.eval_step, self.model),
                                self.global_step)
        self.logger.close()
