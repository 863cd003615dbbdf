"""Optical-flow bilinear warp (basicsr's `flow_warp`), channels-last.

Counterpart of promptir_tpu/ops/flow_warp.py, used by CAMixer v1's
deformable keys (k = x + flow_warp(x, offsets)). The semantics are torch
`grid_sample(align_corners=True, padding_mode="border")`, computed by the
JAX module's formula rather than by grid_sample, whose normalisation round
trip moves the sample points by float rounding: each position plus its
offset (`sample_points`), clipped to the image, floored, four gathers and
two lerps in float32 (`bilinear`), the result in x's dtype.
"""

from __future__ import annotations

import torch


def sample_points(flow, h: int, w: int):
    """(px, py): each pixel's column and row plus its offset, float32,
    before clipping; flow: (B, H, W, 2), (dx, dy)."""
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device), indexing="ij")
    return gx + flow[..., 0].float(), gy + flow[..., 1].float()


def bilinear(x, px, py, x0, y0):
    """x: (B, H, W, C) sampled at the clipped points (px, py), in the cells
    whose top-left pixels are (x0, y0) (their floors)."""
    b, h, w, c = x.shape
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    flat = x.float().reshape(b, h * w, c)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, h * w, 1).expand(b, h * w, c)
        return flat.gather(1, idx).reshape(b, h, w, c)

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return (top + (bot - top) * wy).to(x.dtype)


def flow_warp(x, flow):
    """x: (B, H, W, C); flow: (B, H, W, 2), (dx, dy) pixel offsets."""
    _, h, w, _ = x.shape
    px, py = sample_points(flow, h, w)
    px, py = px.clamp(0.0, w - 1.0), py.clamp(0.0, h - 1.0)
    return bilinear(x, px, py, px.floor().long(), py.floor().long())
