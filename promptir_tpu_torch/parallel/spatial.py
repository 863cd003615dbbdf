"""The exact H-sharded forward: collectives inside the ops.

Counterpart of promptir_tpu/parallel/spatial.py. `parallel/halo.py`'s
fixed input halo is exact only for local models; PromptIR is not local:
MDTA's q and k L2 norms and its channel Gram sum over every pixel, and the
prompt block starts from a global average pool. So the model runs
unmodified on each rank's stripe of the image, under a context
(`spatial_sharding(group)`) that the ops read through
`current_spatial_group()`:

  * a stride-1 conv with an odd kernel exchanges `k // 2` rows with its
    neighbours and crops the rows it recomputed (ops/conv.py; a strided
    conv with k == s + 2p exchanges s rows, a stride == kernel conv stays
    local, anything else gathers the rows);
  * MDTA sums its L2-norm sums and its Gram over the local rows, then over
    the group, before the softmax (ops/attention.py);
  * the prompt's GAP is `global_mean_hw`, and its bank mix is resized at
    global rows and sliced to the stripe (ops/prompt.py);
  * pixel-(un)shuffle and the seam kernel (pixel-shuffle and concat) are
    row-local on even stripes, hence H % (8 n) for three downsamples;
  * a TransformerBlock runs its modules' plain composition and PromptIR's
    stacks never chain (models/blocks.py): the block kernels sum their
    Gram over their whole input and zero-pad its top and bottom rows, which
    on a stripe would be wrong. JAX's sharded forward also runs its unfused
    ops (spatial.py:37-38);
  * OCAB's key and value windows take their overlap rows from the
    neighbours (ops/ocab.py); a LeWin block rolls its shifted windows
    across the seams (`sharded_roll_h`) under its rows of the global Swin
    mask, or, on a stripe thinner than a window, gathers the level and runs
    whole (ops/window_attention.py);
  * a CAMixer gathers the level's rows and its condition and runs whole
    (its top-k routing and deformable offsets are global), the branch
    selector's pool and the Easy and NAF channel attention's are
    `global_mean_hw`, NAFNetLocal's TLC pool gathers the rows
    (ops/camixer.py, ops/easy.py); the X-Restormer SR input is resized at
    global rows (`upscale_input`), as is the CAMixer condition pyramid
    (models/camixer_models.py).

Each collective is an `all_reduce` (mesh.all_reduce_sum): the exchanges
write into zeroed buffers, so that NCCL, gloo on the CPU and gloo on CUDA
tensors run the same code. Row helpers take the row axis `dim` (1 for NHWC,
as the JAX functions; the ops pass 2 for their NCHW stripes).

Every registered model has its hooks (`SPATIAL_MODELS` is the registry;
a model class says so with `spatial_hooks = True`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from promptir_tpu_torch.parallel.halo import exchange_edges, exchange_halo
from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_rank, group_size

_GROUP: contextvars.ContextVar = contextvars.ContextVar("spatial_group",
                                                        default=None)


def __getattr__(name):
    """`SPATIAL_MODELS`, the models whose ops all have their spatial hooks:
    the registry's (models/__init__.py), read when asked, since the models
    import this module."""
    if name == "SPATIAL_MODELS":
        from promptir_tpu_torch.models import available_models

        return frozenset(available_models())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def current_spatial_group():
    """The group the forward runs sharded over, or None."""
    return _GROUP.get()


@contextlib.contextmanager
def spatial_sharding(group):
    """Run the ops inside sharded over `group` (None: unsharded)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def local_rows(h_global: int, group) -> tuple[int, int]:
    """(start_row, rows_per_rank) of this rank's stripe."""
    hl = h_global // group_size(group)
    return group_rank(group) * hl, hl


def local_stripe(x, group, dim: int = 1):
    """This rank's stripe of a global tensor (= slice_local_rows)."""
    start, hl = local_rows(x.shape[dim], group)
    return x.narrow(dim, start, hl)


def exchange_rows(x, halo: int, group, dim: int = 1):
    """`halo` rows of each neighbour's stripe around the local stripe,
    zeros at the global borders (a zero-padded conv's)."""
    return exchange_halo(x, halo, group, "zeros", dim)


def sharded_roll_h(x, shift: int, group, dim: int = 1):
    """torch.roll(x_global, shift, dim) on the local stripe: the rows that
    leave one stripe enter the next, the last rank's wrapping to the
    first."""
    if shift == 0:
        return x
    n = group_size(group)
    if n == 1:
        return torch.roll(x, shift, dim)
    s = abs(shift)
    h = x.shape[dim]
    if s > h:
        raise ValueError(f"a roll of {shift} is larger than the stripe ({h})")
    buf, n, r = exchange_edges(x, s, group, dim)
    if shift < 0:  # rows move up: the next stripe's first rows come in below
        return torch.cat([x.narrow(dim, s, h - s), buf[(r + 1) % n, 0]], dim)
    return torch.cat([buf[(r - 1) % n, 1], x.narrow(dim, 0, h - s)], dim)


def gather_rows(x, group, dim: int = 1):
    """The global tensor from the equal local stripes (an all-gather, as a
    sum into a zeroed (n, ...) buffer)."""
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return x
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[r] = x
    all_reduce_sum(buf, group)
    return torch.cat(list(buf.unbind(0)), dim)


def slice_local_rows(xg, group, dim: int = 1):
    """Inverse of gather_rows: this rank's stripe of a global tensor."""
    return local_stripe(xg, group, dim)


def sharded_resize_bilinear(x, out_hw_global, group,
                            align_corners: bool = False):
    """Bilinear resize of an H-sharded NCHW stripe (ops/resize.py's layout)
    at global coordinates: gather the rows (cheap for the few-channel maps
    it is used on), resize the whole, keep this rank's output stripe."""
    from promptir_tpu_torch.ops.resize import resize_bilinear

    n = group_size(group)
    if out_hw_global[0] % n:
        raise NotImplementedError(
            f"sharded resize: output rows {out_hw_global[0]} do not partition "
            f"{n} ranks")
    yg = resize_bilinear(gather_rows(x, group, 2), out_hw_global, align_corners)
    return slice_local_rows(yg, group, 2)


def upscale_input(x, scale: int):
    """Bilinear x`scale` upscaling of an NCHW input (align_corners=False),
    the X-Restormer SR entry (promptir_tpu/parallel/spatial.py:146-166);
    under the context at global rows, since its samples cross the seams.
    The input itself at scale 1."""
    from promptir_tpu_torch.ops.resize import resize_bilinear

    if scale <= 1:
        return x
    h, w = x.shape[-2:]
    group = current_spatial_group()
    if group is not None:
        return sharded_resize_bilinear(
            x, (h * group_size(group) * scale, w * scale), group)
    return resize_bilinear(x, (h * scale, w * scale))


def global_rows(h: int) -> int:
    """The whole image's rows of a tensor `h` rows tall: its own outside
    the context, times the group's size inside."""
    return h * group_size(current_spatial_group())


def run_gathered(fn, x, *others, dim: int = 1):
    """`fn(x, *others)` on the whole level: every tensor of (x, *others)
    (None passes) gathered along the row axis `dim`, `fn` run unsharded
    (`spatial_sharding(None)`), and the rows of this rank's stripe kept of
    its first output (of the output itself when it is a tensor; the rest
    of a tuple as it is). Outside the context, or in a group of one,
    `fn(x, *others)` as it is. The exact fallback of an op whose local
    stripe cannot hold its spatial structure."""
    group = current_spatial_group()
    if group is None or group_size(group) == 1:
        return fn(x, *others)
    args = [None if t is None else gather_rows(t.contiguous(), group, dim)
            for t in (x, *others)]
    with spatial_sharding(None):
        out = fn(*args)
    if isinstance(out, tuple):
        return (slice_local_rows(out[0], group, dim),) + out[1:]
    return slice_local_rows(out, group, dim)


def global_mean_hw(x, dims=(1, 2), keepdim: bool = True):
    """Mean of `x` over its spatial `dims` (NHWC's by default), over the
    whole image under the context: equal stripes make it the mean of the
    ranks' means. In float32."""
    m = x.float().mean(dim=dims, keepdim=keepdim)
    group = current_spatial_group()
    if group is not None:
        m = all_reduce_sum(m, group) / group_size(group)
    return m


def spatial_sharded_apply(model, x, group):
    """A model's exact forward of a global NHWC batch `x`, sharded on H.

    Every rank of `group` passes the same global (B, H, W, 3) input, H a
    multiple of 8 n (even stripes through three downsamples) and of the
    model's own pad base (eval/padding.py:pad_bases(name, n)), runs its
    stripe of it under `spatial_sharding(group)` without autograd, and
    returns the global float32 output (`scale` times taller and wider for
    an SR X-Restormer). The model must not be built with `fused_ffn=True`
    (the kernels' chain is single-card) and must have its hooks
    (`spatial_hooks`)."""
    n = group_size(group)
    h = x.shape[1]
    if h % (8 * n):
        raise ValueError(
            f"H={h} must be divisible by 8 * the group size {n} (even stripes "
            "through 3 downsample levels)")
    if getattr(model, "fused_ffn", False):
        raise ValueError("the sharded forward needs the unfused op path (drop "
                         "--fused / fused_ffn): the kernels are single-card")
    if not getattr(model, "spatial_hooks", False):
        raise NotImplementedError(
            f"{type(model).__name__} has no spatial hooks (spatial_hooks = "
            "True): the sharded forward runs the registered models")
    xs = local_stripe(x, group).permute(0, 3, 1, 2)
    with spatial_sharding(group), torch.no_grad():
        y = model(xs).permute(0, 2, 3, 1)
        return gather_rows(y.contiguous(), group)
