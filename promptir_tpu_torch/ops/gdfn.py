"""GDFN: gated depthwise-conv feed-forward network.

Counterpart of promptir_tpu/ops/gdfn.py (reference
net/model.py:82-99): 1x1 conv to 2F = 2 int(C expansion),
depthwise 3x3, gelu(x1) * x2 with the exact erf GELU, 1x1 conv back to C.
Inside a TransformerBlock the module only holds the weights (see MDTA).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv


class GDFN(nn.Module):
    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv(dim, hidden * 2, 1, bias=bias)
        self.dwconv = Conv(hidden * 2, hidden * 2, 3, bias=bias,
                           groups=hidden * 2)
        self.project_out = Conv(hidden, dim, 1, bias=bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)
