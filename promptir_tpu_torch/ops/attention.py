"""MDTA: multi-Dconv-head transposed (channel) attention.

Counterpart of promptir_tpu/ops/attention.py (reference
net/model.py:105-138). qkv = 1x1 conv to 3C, then a depthwise
3x3; q and k are L2-normalized over the whole image; each head's attention
is a d x d channel matrix scaled by its temperature and softmaxed over
channels; out = attn v, then a 1x1 projection.

`MDTA.forward` is the plain composition. Inside a TransformerBlock the
module only holds the weights: the block runs them through the stats and
tail kernels (models/blocks.py).

Under the H-sharded forward (parallel/spatial.py) each rank holds a stripe
of rows: the q and k sums of squares and the Gram are taken over the local
rows and summed over the group before the softmax, so that every rank's
attention matrix is the whole image's (promptir_tpu/ops/attention.py:
40-60).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.parallel.mesh import all_reduce_sum
from promptir_tpu_torch.parallel.spatial import current_spatial_group


def channel_attention(q, k, v, temperature, num_heads: int):
    """q, k, v: (B, C, H, W); temperature: (heads, 1, 1). Returns (B, C, H, W).

    Head h covers channels [h d, (h+1) d) (the reference's `(head c)`)."""
    b, c, h, w = q.shape
    d = c // num_heads
    dt = q.dtype
    q, k, v = (t.reshape(b, num_heads, d, h * w).float() for t in (q, k, v))
    group = current_spatial_group()
    if group is None:
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = q @ k.transpose(-2, -1)
    else:  # the norms and the Gram over the whole image's rows
        sq = all_reduce_sum(torch.stack([q.square().sum(-1, keepdim=True),
                                         k.square().sum(-1, keepdim=True)]),
                            group)
        q, k = (t / s.sqrt().clamp_min(1e-12) for t, s in zip((q, k), sq))
        attn = all_reduce_sum(q @ k.transpose(-2, -1), group)
    attn = attn * temperature.float()
    attn = attn.softmax(dim=-1).to(dt).float()  # as the JAX composition rounds it
    return (attn @ v).to(dt).reshape(b, c, h, w)


class MDTA(nn.Module):
    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, bias=bias, groups=dim * 3)
        self.project_out = Conv(dim, dim, 1, bias=bias)

    def forward(self, x):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = channel_attention(q, k, v, self.temperature, self.num_heads)
        return self.project_out(out)
