"""The training and evaluation steps.

Counterpart of promptir_tpu/train/step.py: forward, L1 loss, backward and
one AdamW update (the reference's train.py:37-56). The JAX step is one
jitted function over a data-parallel mesh (step.py:130-138); this one runs
eagerly in each rank of a data group, on its rank's rows of the global
batch. It updates the state in place and returns its metrics as tensors on
the card, so that the loop does not wait for the card at every step.

With a `group` of n ranks, after the microbatches come, in this order: the
dead convs' zero gradients, one all_reduce of the flat gradient over the
group divided by n (its mean: equal rank batches make it the global
batch's gradient), then the global-norm clip and AdamW, as the JAX step
sums its gradient over the mesh before `clip_by_global_norm`. The logged
loss is the group's mean. The all_reduce is explicit, not
DistributedDataParallel: that keeps `grad_accum`'s single update, the zero
gradients of the never-read dead convs (DDP refuses unused parameters) and
the clip of the averaged gradient. Overlapping it with the backward is
later speed work (ROADMAP.md).

`grad_accum > 1` splits the batch into that many equal microbatches, runs
them one after the other and averages their gradients before the single
update, as the JAX step does with a `lax.scan`: equal microbatches make the
mean of the microbatch L1 losses the full batch's. A float32 model runs
with TF32 off (precision.py).

While a torch.profiler session runs, the step records spans
(utils/tracing.py), each also a profiler range: `train.step` around the
whole call (its step number and the weight copies made in it, the
"weight_copies" counter's growth), holding "forward" (the forward with
its loss), "backward" (autograd's backward) and "optimizer" (the norm,
the clip, AdamW), so that a trace of the step splits into them
(tools/profile_train.py); without a profiler a span costs one check. The
step's first call runs inside a `setup.first_call` span, recorded always.

A stochastic model (the CAMixer family, told by its `variant`, as the JAX
trainer tells them) is called with `deterministic=False` and a torch.Generator
seeded from (seed, step * grad_accum + microbatch), the fold of the JAX
step, so that a resumed run draws what an unbroken run draws; its mean
routing decision (v1) adds the ratio loss to L1.

Over a data group the microbatches run under `data_sharding(group)`
(parallel/data.py), so that a stochastic model's step is the one-process
step on the global batch, as the JAX step under its mesh is: every rank
draws the global microbatch's uniforms from the same generator and keeps
its rows, the squared batch means of the training terms are the global
batch's (a differentiable all_reduce), and CATA's selector chooses over
the global batch. With `grad_accum > 1` the global microbatch i is every
rank's microbatch i, in rank order, which is the global batch's i-th
slice, the JAX step's, when the ranks' rows are dealt by microbatch
(data/loader.py:rank_rows, as the trainer's loader deals them).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from promptir_tpu_torch.parallel.data import data_sharding
from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_size
from promptir_tpu_torch.precision import compute_dtype, exact_float32
from promptir_tpu_torch.train.losses import l1_loss, ratio_loss
from promptir_tpu_torch.train.state import TrainState, clip_by_global_norm, global_norm
from promptir_tpu_torch.utils import tracing


def to_nchw(x: torch.Tensor, device) -> torch.Tensor:
    """A (B, H, W, 3) batch on `device` as the models' (B, 3, H, W)."""
    return x.to(device, non_blocking=True).permute(0, 3, 1, 2)


# the CAMixer variants, whose training forward samples (the JAX trainer's
# list); v1 returns its mean decision, the others their losses
STOCHASTIC = ("v1", "v2", "cata")


def average_gradients(grads, group) -> None:
    """Replace each of `grads` with its mean over `group`: one all_reduce
    of their concatenation (none in a lone process, group None)."""
    if group is None:
        return
    n = group_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum(flat, group).div_(n)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def draw_generator(device, seed: int, index: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, index): the draws of
    microbatch `index` (step * grad_accum + microbatch) of a run."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def make_train_step(model, grad_accum: int = 1, seed: int = 0, group=None):
    """Build `step(state, batch) -> metrics` for `model`; `seed` seeds a
    stochastic model's draws; `group` is the data group whose ranks each
    step on their rows of the global batch (None: one process).

    `batch`: {"degraded", "clean"} (B, H, W, 3) float tensors (from
    data/loader.py), B a multiple of grad_accum. Returns {"train_loss",
    "grad_norm"}, the norm of the averaged gradient before any clip.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    stochastic = getattr(model, "variant", None) in STOCHASTIC
    n_ranks = group_size(group)

    def loss_of(x, y, index):
        if not stochastic:
            return l1_loss(model(x), y)
        out, *aux = model(x, deterministic=False,
                          generator=draw_generator(device, seed, index))
        if model.variant == "v1":
            aux = [ratio_loss(aux[0], model.ratio)]
        return l1_loss(out, y) + sum(aux)

    first = [True]

    def step(state: TrainState, batch: dict) -> dict:
        setup = (tracing.setup_span("setup.first_call", step=state.step)
                 if first[0] else contextlib.nullcontext())
        first[0] = False
        with setup, tracing.span("train.step", step=state.step) as s:
            before = tracing.total("weight_copies") if s is not None else 0
            out = run(state, batch)
            if s is not None:
                s.attrs["weight_copies"] = tracing.total("weight_copies") - before
        return out

    def run(state: TrainState, batch: dict) -> dict:
        n = batch["degraded"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} is not divisible by grad_accum "
                             f"{grad_accum}")
        m = n // grad_accum
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=device)
        with exact_float32(compute_dtype(model)), data_sharding(group):
            for i in range(grad_accum):
                sl = slice(i * m, (i + 1) * m)
                with tracing.span("forward"):
                    mloss = loss_of(to_nchw(batch["degraded"][sl], device),
                                    to_nchw(batch["clean"][sl], device),
                                    state.step * grad_accum + i)
                with tracing.span("backward"):
                    (mloss / grad_accum).backward()
                loss = loss + mloss.detach()
        with tracing.span("optimizer"):
            # a parameter the forward never reads (the reference's dead
            # convs) gets a zero gradient, so that AdamW still decays it, as
            # optax does
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            average_gradients(grads, group)
            if group is not None:
                loss = all_reduce_sum(loss.reshape(1), group)[0] / n_ranks
            if state.grad_clip is not None:
                norm = clip_by_global_norm(grads, state.grad_clip)
            else:
                norm = global_norm(grads)
            state.optimizer.step()
        state.step += 1
        return {"train_loss": loss / grad_accum, "grad_norm": norm}

    return step


def make_eval_step(model):
    """`eval_step(degraded) -> restored`: (B, H, W, 3) in, the restored
    (B, H, W, 3) float32 clipped to [0, 1] out, on the model's device."""
    device = next(model.parameters()).device

    def eval_step(degraded: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), exact_float32(compute_dtype(model)):
            out = model(to_nchw(degraded, device))
        return out.clamp(0.0, 1.0).permute(0, 2, 3, 1)

    return eval_step
