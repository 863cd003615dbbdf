"""The data-parallel forward: one global batch split over a group's ranks.

The JAX trainer's step is one program over the global batch, its rows
sharded over the mesh's data axis: whatever couples the rows of a batch
sees the whole batch. Here each rank of a data group runs its own rows
(data/loader.py: rank r holds rows [r b, (r + 1) b) of the global batch),
so what couples them is made global under a context that train/step.py
and eval/tiling.py enter with their group (`data_sharding(group)`) and the
ops read through `current_data_group()`, as parallel/spatial.py's context
is read:

  * a random draw for the batch (`gumbel_uniform`'s, DropPath's) is the
    global batch's, from the same generator state on every rank, in the
    shape and order one process draws it (`global_batch_shape`), and each
    rank keeps its rows (`keep_rows`);
  * a batch mean that a loss squares (the CAMixer decisions, CATA's mean
    label) is the group's (`batch_mean`), summed by a differentiable
    all_reduce whose backward all-reduces the gradient: with the ranks'
    gradients averaged by the train step, that is the one-process
    gradient;
  * a choice over the batch (CATA's branch selector) is made on the
    global batch (`gather_batch`, a differentiable all-gather whose
    backward sums the gradient over the ranks and keeps this rank's rows)
    and this rank's rows kept.

Every rank's batch has the same number of rows. Outside the context (a
lone process) each helper is the identity; a group of one still makes its
collectives (the smoke's NCCL world of one). The collectives are
`all_reduce`s (mesh.all_reduce_sum), as every collective of the port.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_rank, group_size

_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group",
                                                        default=None)


def current_data_group():
    """The group the batch is split over, or None."""
    return _GROUP.get()


@contextlib.contextmanager
def data_sharding(group):
    """Run the forwards inside on this rank's rows of a batch split over
    `group` (None: the whole batch)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def global_batch_shape(shape) -> tuple:
    """`shape` (this rank's rows first) with the global batch's rows."""
    return (shape[0] * group_size(current_data_group()),) + tuple(shape[1:])


def keep_rows(t):
    """This rank's rows of a global batch tensor `t` (rows first)."""
    group = current_data_group()
    b = t.shape[0] // group_size(group)
    return t.narrow(0, group_rank(group) * b, b)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        n, r = group_size(group), group_rank(group)
        ctx.group, ctx.rank = group, r
        buf = t.new_zeros((n,) + tuple(t.shape))
        buf[r] = t
        all_reduce_sum(buf, group)
        return buf.reshape((n * t.shape[0],) + tuple(t.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce_sum(grad.contiguous().clone(), ctx.group)
        b = g.shape[0] // group_size(ctx.group)
        return g[ctx.rank * b:(ctx.rank + 1) * b], None


def batch_mean(t):
    """The global batch's mean from this rank's mean `t` over its rows:
    the mean of the ranks' (equal batches), differentiable."""
    group = current_data_group()
    if group is None:
        return t
    return _SumOverGroup.apply(t, group) / group_size(group)


def gather_batch(t):
    """The global batch from this rank's rows `t`, in rank order,
    differentiable."""
    group = current_data_group()
    if group is None:
        return t
    return _GatherBatch.apply(t.contiguous(), group)
