"""Tiled inference of images larger than the serving buckets.

Counterpart of promptir_tpu/eval/tiling.py (reference demo.py:26-48): a
`tile`-sized window slides with stride `tile - overlap`, the last row and
column snapped to the image edge; the model's unclipped outputs and a count
map are summed into float32 accumulators, and clamp(sum / count, 0, 1) is
taken once at the end, so that the overlaps blend raw outputs.

As in the JAX tiler, the image is first reflect-padded to a multiple of
`bucket`, and the tiles run in chunks of exactly `chunk` (the last chunk is
filled with copies of the first tile, which are not blended), so the model
sees one shape however large the image. Everything runs on the model's
device.

With a `group` of n ranks (the JAX tiler's `mesh`, eval/tiling.py:125-149)
the chunk is rounded up to a multiple of n and each rank forwards its n-th
of every chunk; each blends its tiles' outputs and counts into its own
accumulators, the accumulators are summed over the group (two
all_reduces), and every rank returns the same image. Sums in another order
than one process's, so within float32 rounding of it. The forwards run
under `data_sharding(group)` (parallel/data.py): a chunk is one batch to
the models that couple its images (CATA's selector keeps the chunk's top
images), as the JAX tiler's jitted chunk is.
"""

from __future__ import annotations

import torch

from promptir_tpu_torch.eval.padding import pad_to_multiple_reflect
from promptir_tpu_torch.parallel.data import data_sharding
from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_rank, group_size


def tile_positions(size: int, tile: int, stride: int) -> list[int]:
    """Reference position list: range(0, size - tile, stride) + [size - tile]."""
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return pos


def forward_nhwc(model, x):
    """NHWC in, NHWC float32 out, through the NCHW module."""
    return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()


def _tiled_forward(model, x, tile: int, overlap: int, chunk: int, group=None):
    b, h, w, c = x.shape
    n_ranks, rank = group_size(group), group_rank(group)
    stride = tile - overlap
    coords = [(i, j) for i in tile_positions(h, tile, stride)
              for j in tile_positions(w, tile, stride)]
    n = len(coords)
    n_pad = -(-n // chunk) * chunk
    coords += [(0, 0)] * (n_pad - n)
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((b, h, w, 1), dtype=torch.float32, device=x.device)
    per_rank = chunk // n_ranks
    for s in range(rank * per_rank, n_pad, chunk):
        part = coords[s:s + per_rank]
        tiles = torch.cat([x[:, i:i + tile, j:j + tile] for i, j in part])
        with data_sharding(group):
            out = forward_nhwc(model, tiles)
        out = out.reshape(len(part), b, tile, tile, c)
        for k, (i, j) in enumerate(part):
            if s + k < n:
                acc[:, i:i + tile, j:j + tile] += out[k]
                cnt[:, i:i + tile, j:j + tile] += 1.0
    all_reduce_sum(acc, group)
    all_reduce_sum(cnt, group)
    return (acc / cnt).clamp(0.0, 1.0)


def tiled_inference(model: torch.nn.Module, x, tile: int = 128,
                    overlap: int = 32, chunk: int = 8, bucket: int = 64,
                    group=None):
    """Run `model` (an NCHW module) over overlapping tiles of NHWC `x`.

    `chunk` tiles are batched per forward; `x` is reflect-padded to a
    multiple of `bucket` first. An image no larger than one tile takes one
    padded forward. Returns the restored NHWC image in float32 on the
    model's device, clipped to [0, 1]. With `group`, every rank passes the
    same image and model, runs its share of the tiles, and returns the
    whole image (an image of one tile runs on every rank).
    """
    device = next(model.parameters()).device
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    _, h, w, _ = x.shape
    with torch.inference_mode():
        xp = pad_to_multiple_reflect(x, bucket)
        if h <= tile and w <= tile:
            y = forward_nhwc(model, xp).clamp(0.0, 1.0)
        else:
            n_ranks = group_size(group)
            chunk = -(-chunk // n_ranks) * n_ranks
            y = _tiled_forward(model, xp, tile, overlap, chunk, group)
        return y[:, :h, :w]
