"""Convolutions with the reference's parameter names.

Counterpart of promptir_tpu/ops/conv.py. `Conv` is `nn.Conv2d` with
"same" padding for odd kernels (`k // 2`, unless `padding` is given) and no
bias by default, so its `weight` (and `bias`) load the reference's keys
verbatim; torch's default initialization is the reference's. NAFNet's 2x2
stride-2 downsampling is `Conv(c, 2 * c, 2, stride=2, padding=0,
bias=True)`; CAMixer v1's dilated depthwise 3x3 is `Conv(c, c, 3,
padding=2, dilation=2, groups=c, bias=True)`. Every convolution of the
models is a `Conv` called as a module (channels-last ones through
ops/window_attention.py:conv_nhwc), so each takes the sharded plans below.

`Conv` is also the hook of the exact H-sharded forward
(parallel/spatial.py): under `spatial_sharding(group)` each conv takes the
first plan that applies, as the JAX Conv does (promptir_tpu/ops/conv.py:
66-162):
  * stride 1, odd kernel height kh > 1, dilation d, row padding
    d (kh // 2): exchange that many rows with the neighbours and crop the
    rows recomputed at each end (zeros at the global borders: the
    unsharded conv's padding). The JAX Conv gathers a dilated conv's rows
    instead; both are exact;
  * stride == kernel, no padding, the stripe a multiple of the stride:
    every window lies inside one stripe, so the conv is local;
  * kh == s + 2 p with 0 < p <= s (a strided overlap, the Uformer 4x4/s2/p1
    downsample), the stripe a multiple of s: exchange s rows, conv, crop
    one output row at each end;
  * kh == 1 otherwise: local;
  * anything else: gather the rows, convolve the whole, keep the local
    output rows (NotImplementedError when they do not partition).
The transposed 2x2/s2 convolutions of the Uformer (a `ConvTranspose2d`)
are row-local and are not hooked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.parallel.mesh import group_size
from promptir_tpu_torch.parallel.spatial import (
    current_spatial_group,
    exchange_rows,
    gather_rows,
    slice_local_rows,
    spatial_sharding,
)
from promptir_tpu_torch.precision import weight_as


class Conv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int = 1, *, bias: bool = False,
                 groups: int = 1, stride: int = 1, padding: int | None = None,
                 dilation: int = 1):
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if padding is None else padding,
                         dilation=dilation, bias=bias, groups=groups)

    def forward(self, x):
        """The convolution in x's dtype: the float32 weights of a model that
        computes in bfloat16 are cast at use, as a flax module with
        `dtype=bfloat16` casts its float32 params (a no-op when they match)."""
        group = current_spatial_group()
        if group is not None:
            return self._sharded(x, group)
        return self._plain(x)

    def _plain(self, x):
        b = weight_as(self.bias, x.dtype, "conv")
        if (x.device.type == "cpu" and x.dtype == torch.bfloat16
                and self.dilation != (1, 1) and self.groups == self.in_channels):
            # PyTorch's CPU bf16 weight gradient of a dilated depthwise conv
            # of channels-last memory (conv_nhwc's NCHW view) is wrong by
            # more than its largest element (1.3-1.5 of max |fp32 grad| at
            # B6 32x32 C 48 and 64x64 C 96, torch 2.13): convolve a
            # contiguous copy, whose gradient is right
            x = x.contiguous()
        return self._conv_forward(x, weight_as(self.weight, x.dtype, "conv"), b)

    def _sharded(self, x, group):
        """The conv of an NCHW stripe under the sharded forward's plan."""
        kh, sh, h = self.kernel_size[0], self.stride[0], x.shape[2]
        dh = self.dilation[0]
        explicit = not isinstance(self.padding, str)
        ph = self.padding[0] if explicit else -1
        if explicit and sh == 1 and kh > 1 and kh % 2 and ph == dh * (kh // 2):
            y = self._plain(exchange_rows(x, ph, group, dim=2))
            return y[:, :, ph:y.shape[2] - ph]
        plain_rows = explicit and dh == 1
        if plain_rows and sh == kh and ph == 0 and h % sh == 0:
            return self._plain(x)
        if plain_rows and kh == sh + 2 * ph and 0 < ph <= sh and h % sh == 0:
            # a halo of s rows keeps the conv's own zero padding in phase
            # with the global conv: output row q of the haloed stripe reads
            # global rows i hl + (q - 1) s - p ..., the unsharded output for
            # q in [1, hl / s]
            y = self._plain(exchange_rows(x, sh, group, dim=2))
            return y[:, :, 1:y.shape[2] - 1]
        if kh == 1:
            return self._plain(x)
        with spatial_sharding(None):
            yg = self._plain(gather_rows(x, group, dim=2))
        if yg.shape[2] % group_size(group):
            raise NotImplementedError(
                "spatial sharding: gathered conv output rows do not "
                f"partition the group (H_out={yg.shape[2]})")
        return slice_local_rows(yg, group, dim=2)


def dwconv3x3_nhwc(h, taps):
    """Depthwise 3x3 with zero padding of NHWC `h`; taps: (F, 9) or (F,1,3,3)."""
    f = h.shape[-1]
    y = F.conv2d(h.permute(0, 3, 1, 2), taps.reshape(f, 1, 3, 3), padding=1,
                 groups=f)
    return y.permute(0, 2, 3, 1)
