"""Pixel-(un)shuffle resampling and the 3-channel output conv.

Counterpart of promptir_tpu/ops/resample.py (reference
net/model.py:160-178). torch's own PixelShuffle and
PixelUnshuffle give the channel order c r^2 + i r + j that the checkpoints
use. The TPU-layout variants of the JAX module (folded stride-2 kernels,
ij-major lanes, padded inputs) have no counterpart here. `SRUpsample` is
the reference's `SR_Upsample`, which no model of it instantiates.
"""

from __future__ import annotations

from torch import nn

from promptir_tpu_torch.ops.conv import Conv


class Downsample(nn.Module):
    """3x3 conv C -> C/2, then pixel-unshuffle 2: 2C channels at H/2."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(Conv(n_feat, n_feat // 2, 3),
                                  nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    """3x3 conv C -> 2C, then pixel-shuffle 2: C/2 channels at 2H."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(Conv(n_feat, n_feat * 2, 3),
                                  nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class FewChannelConv3(Conv):
    """The models' 3x3 output conv to a few (RGB) channels."""

    def __init__(self, cin: int, features: int, bias: bool = False):
        super().__init__(cin, features, 3, bias=bias)


class SRUpsample(nn.Sequential):
    """Super-resolution upsampler (reference SR_Upsample,
    net/camixer_prompt_xrestormer_eff.py:561-580; promptir_tpu/ops/
    resample.py:155): log2(scale) stages of a 3x3 conv C -> 4C and
    pixel-shuffle 2 for a power of two, one 3x3 conv C -> 9C and
    pixel-shuffle 3 for 3. The Sequential's indices are the reference's
    keys (`0.weight`, `2.weight`, ...); torch's default conv bias."""

    def __init__(self, scale: int, num_feat: int, bias: bool = True):
        if scale > 0 and scale & (scale - 1) == 0:
            layers = [m for _ in range(scale.bit_length() - 1)
                      for m in (Conv(num_feat, 4 * num_feat, 3, bias=bias),
                                nn.PixelShuffle(2))]
        elif scale == 3:
            layers = [Conv(num_feat, 9 * num_feat, 3, bias=bias),
                      nn.PixelShuffle(3)]
        else:
            raise ValueError(f"scale {scale} is not supported. Supported "
                             "scales: 2^n and 3.")
        super().__init__(*layers)
