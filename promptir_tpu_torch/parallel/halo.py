"""Row halos of an H-sharded image, and the fixed-halo engine.

Counterpart of promptir_tpu/parallel/halo.py. The image's H axis is split
into equal stripes, one a rank of a group; `exchange_halo` pads a stripe
with `halo` rows of each neighbour's, and `spatial_sharded_forward` runs a
model on every stripe plus its halo and crops the halo off. That engine is
exact only for a purely local (conv) model whose receptive field the halo
covers; parallel/spatial.py is the exact sharded forward of PromptIR.

The JAX exchange is two ring `ppermute`s. Here it is one `all_reduce` of a
zeroed (n, 2, halo)-row buffer in which each rank writes its top and bottom
rows: a sum of one value and zeros is exact, and all_reduce runs unchanged
on NCCL, on gloo on the CPU and on gloo on CUDA tensors. It moves n times
the bytes of a point-to-point exchange (ROADMAP.md lists that as speed
work).
"""

from __future__ import annotations

import torch

from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_rank, group_size


def exchange_edges(x, rows: int, group, dim: int = 1):
    """(buf, n, r): every rank's first and last `rows` rows along `dim`,
    buf[k, 0] rank k's first and buf[k, 1] its last."""
    n, r = group_size(group), group_rank(group)
    h = x.shape[dim]
    buf = x.new_zeros((n, 2) + tuple(x.narrow(dim, 0, rows).shape))
    buf[r, 0] = x.narrow(dim, 0, rows)
    buf[r, 1] = x.narrow(dim, h - rows, rows)
    return all_reduce_sum(buf, group), n, r


def exchange_halo(x, halo: int, group, border: str = "zeros", dim: int = 1):
    """Pad a local stripe (B, h, W, C) with `halo` rows from the previous
    and next rank's stripes; returns (B, h + 2 halo, W, C). `border` fills
    the global top and bottom: "zeros" reproduces a zero-padded conv of the
    whole image bit for bit, "reflect" mirrors the stripe (the demo-style
    reflect pad). `dim` is the row axis (2 for an NCHW stripe)."""
    if border not in ("zeros", "reflect"):
        raise ValueError(f"border must be 'zeros' or 'reflect', got {border!r}")
    h = x.shape[dim]
    if halo > h or (border == "reflect" and halo >= h):
        raise ValueError(f"a halo of {halo} rows needs a taller stripe than {h}")
    buf, n, r = exchange_edges(x, halo, group, dim)
    if border == "reflect":
        top = x.narrow(dim, 1, halo).flip(dim)
        bot = x.narrow(dim, h - halo - 1, halo).flip(dim)
    else:
        top = bot = torch.zeros_like(x.narrow(dim, 0, halo))
    top = buf[r - 1, 1] if r > 0 else top
    bot = buf[r + 1, 0] if r < n - 1 else bot
    return torch.cat([top, x, bot], dim)


def spatial_sharded_forward(model, x, group, halo: int = 32,
                            border: str = "zeros"):
    """Run `model` (an NCHW module) over an H-sharded NHWC image.

    Every rank passes the global (B, H, W, C) `x`, H a multiple of the
    group's size; each runs its stripe plus `halo` rows of each neighbour's
    and crops them off, and all ranks return the global (B, H, W, C')
    output. Exact at the seams for a local model whose receptive field
    `halo` covers; at the image's top and bottom a model of more than one
    spatial layer reads its inner layers' outputs on the halo where the
    whole-image model reads zero padding, so pre-pad the image by the
    receptive field and crop after (halo.py:14-18 of the JAX package)."""
    from promptir_tpu_torch.parallel.spatial import gather_rows, local_stripe

    if x.shape[1] % group_size(group):
        raise ValueError(f"H={x.shape[1]} must divide the group size "
                         f"{group_size(group)}")
    xs = exchange_halo(local_stripe(x, group), halo, group, border)
    y = model(xs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return gather_rows(y[:, halo:y.shape[1] - halo], group)
