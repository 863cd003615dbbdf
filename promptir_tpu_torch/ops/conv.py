"""Convolutions with the reference's parameter names.

Counterpart of promptir_tpu/ops/conv.py. `Conv` is `nn.Conv2d` with
"same" padding for odd kernels (`k // 2`, unless `padding` is given) and no
bias by default, so its `weight` (and `bias`) load the reference's keys
verbatim; torch's default initialization is the reference's. NAFNet's 2x2
stride-2 downsampling is `Conv(c, 2 * c, 2, stride=2, padding=0,
bias=True)`. The plain convolutions of the model stay `F.conv2d`.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int = 1, *, bias: bool = False,
                 groups: int = 1, stride: int = 1, padding: int | None = None):
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if padding is None else padding,
                         bias=bias, groups=groups)

    def forward(self, x):
        """The convolution in x's dtype: the float32 weights of a model that
        computes in bfloat16 are cast at use, as a flax module with
        `dtype=bfloat16` casts its float32 params (a no-op when they match)."""
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


def dwconv3x3_nhwc(h, taps):
    """Depthwise 3x3 with zero padding of NHWC `h`; taps: (F, 9) or (F,1,3,3)."""
    f = h.shape[-1]
    y = F.conv2d(h.permute(0, 3, 1, 2), taps.reshape(f, 1, 3, 3), padding=1,
                 groups=f)
    return y.permute(0, 2, 3, 1)
