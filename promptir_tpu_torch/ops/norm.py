"""Restormer channel LayerNorm, WithBias and BiasFree, eps 1e-5.

Counterpart of promptir_tpu/ops/norm.py. The reference normalizes each pixel
over its channels with the biased variance and eps inside the square root
(reference net/model.py:27-76):
  * BiasFree: x / sqrt(var + eps) * weight   (the mean is not subtracted)
  * WithBias: (x - mean) / sqrt(var + eps) * weight + bias
Statistics are computed in float32 whatever the storage type.
"""

from __future__ import annotations

import torch
from torch import nn


def layernorm_nhwc(x, weight, bias, *, bias_free: bool, eps: float = 1e-5):
    """Normalize the last (channel) axis of `x`; returns x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if bias_free:
        y = xf * inv * weight.float()
    else:
        y = (xf - mu) * inv * weight.float() + bias.float()
    return y.to(x.dtype)


class _LNBody(nn.Module):
    """Holds `weight` (and `bias`) under the reference's `body.` prefix."""

    def __init__(self, dim: int, bias_free: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if bias_free else nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """Channel LayerNorm of an NCHW tensor; `bias_free=True` is 'BiasFree'."""

    def __init__(self, dim: int, bias_free: bool = False, eps: float = 1e-5):
        super().__init__()
        self.body = _LNBody(dim, bias_free)
        self.bias_free = bias_free
        self.eps = eps

    def forward(self, x):
        y = layernorm_nhwc(
            x.permute(0, 2, 3, 1), self.body.weight, self.body.bias,
            bias_free=self.bias_free, eps=self.eps,
        )
        return y.permute(0, 3, 1, 2)
