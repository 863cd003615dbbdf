"""Overlapped patch embedding: a stride-1 3x3 conv from RGB to `dim`.

Counterpart of promptir_tpu/ops/embed.py (reference
net/model.py:202-211).
"""

from __future__ import annotations

from torch import nn

from promptir_tpu_torch.ops.conv import Conv


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int = 3, embed_dim: int = 48, bias: bool = False):
        super().__init__()
        self.proj = Conv(in_c, embed_dim, 3, bias=bias)

    def forward(self, x):
        return self.proj(x)
