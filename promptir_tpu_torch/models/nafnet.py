"""NAFNet, the Simple Baselines U-Net, and NAFNetLocal.

Counterpart of promptir_tpu/models/nafnet.py (reference
net/nafnet.py:85-174): a plain convolutional U-Net of NAFBlocks with 2x2
stride-2 convolutions down and a 1x1 convolution (no bias) with a pixel
shuffle up, the skips *added*; the input is zero-padded at the bottom and
right to a multiple of 2^len(enc_blk_nums) and the output cropped back.
Registered as `nafnet` (width 32, middle 12, encoders 2/2/4/8, decoders
2/2/2/2) and `nafnetlocal`, NAFNet with TLC: each SCA's global mean
becomes a local mean over a window fixed per level, `tlc_base / 2^level`
(`tlc_base` defaults to 1.5x `tlc_train_size`, 256). NAFNetLocal has
NAFNet's parameters, so NAFNet weights load into it unchanged; at 256 the
level-0 window is 384 px, so on an input of at most 384 px a side every
level takes the global mean and the two models agree bit for bit.

No kernel of the port runs on this path (ops/easy.py). In bfloat16 the
residual stream is float32 from the first block on, as in the JAX model,
and every convolution computes in the model's compute dtype: the blocks
are handed that dtype, and the downs, ups and ending cast their input to
it. The forward returns float32.

Under the H-sharded forward (`spatial_hooks`, parallel/spatial.py) the
2x2/s2 downs and the 1x1 + pixel-shuffle ups are row-local, the 3x3s take
their halo, the SCA pool is the whole image's and the TLC pool gathers its
level (ops/easy.py). The model's zero pad to a multiple of
2^len(enc_blk_nums) is at the image's bottom, so a stripe that is not such
a multiple (whose pad would land inside the image) runs the model whole:
the input's rows gathered, the unsharded forward, the stripe's output rows
kept; exact, and as slow as one card.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.easy import NAFBlock
from promptir_tpu_torch.parallel.spatial import current_spatial_group, run_gathered
from promptir_tpu_torch.precision import compute_dtype


class NAFNet(nn.Module):
    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, img_channel: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (),
                 tlc_base: "tuple | None" = None):
        super().__init__()
        self.pad_multiple = 2 ** len(enc_blk_nums)

        def stack(n, chan, level):
            kernel = None
            if tlc_base is not None:
                kernel = (max(1, tlc_base[0] // 2**level),
                          max(1, tlc_base[1] // 2**level))
            return nn.Sequential(*[NAFBlock(chan, tlc_kernel=kernel)
                                   for _ in range(n)])

        self.intro = Conv(img_channel, width, 3, bias=True)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        chan = width
        for level, num in enumerate(enc_blk_nums):
            self.encoders.append(stack(num, chan, level))
            self.downs.append(Conv(chan, 2 * chan, 2, stride=2, padding=0,
                                   bias=True))
            chan *= 2
        mid = len(enc_blk_nums)
        self.middle_blks = stack(middle_blk_num, chan, mid)
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for i, num in enumerate(dec_blk_nums):
            self.ups.append(nn.Sequential(Conv(chan, 2 * chan),
                                          nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(stack(num, chan, mid - 1 - i))
        self.ending = Conv(width, img_channel, 3, bias=True)

    def forward(self, inp_img):
        """inp_img: (B, C, H, W) float, any H and W. Returns the restored
        image in float32."""
        dt = compute_dtype(self)
        h, w = inp_img.shape[-2:]
        m = self.pad_multiple
        if current_spatial_group() is not None and h % m:
            return run_gathered(self.forward, inp_img, dim=2)
        inp = F.pad(inp_img, (0, (m - w % m) % m, 0, (m - h % m) % m))
        inp = inp.to(dt).contiguous(memory_format=torch.channels_last)

        def run(blocks, x):
            for blk in blocks:
                x = blk(x, dt)
            return x

        x = self.intro(inp)
        encs = []
        for blocks, down in zip(self.encoders, self.downs):
            x = run(blocks, x)
            encs.append(x)
            x = down(x.to(dt))
        x = run(self.middle_blks, x)
        for up, blocks, enc in zip(self.ups, self.decoders, encs[::-1]):
            x = run(blocks, up(x.to(dt)) + enc)
        # the global residual in float32, as the JAX package's jitted forward
        # computes it (XLA keeps the bf16 sum in f32 before the final cast)
        x = self.ending(x.to(dt)).float() + inp.float()
        return x[:, :, :h, :w]


@register_model("nafnet")
def _nafnet(**kwargs) -> NAFNet:
    kwargs.setdefault("width", 32)
    kwargs.setdefault("middle_blk_num", 12)
    kwargs.setdefault("enc_blk_nums", (2, 2, 4, 8))
    kwargs.setdefault("dec_blk_nums", (2, 2, 2, 2))
    return NAFNet(**kwargs)


@register_model("nafnetlocal")
def _nafnet_local(**kwargs) -> NAFNet:
    """NAFNet with TLC's local-pool SCA (reference net/nafnet.py:156-174):
    train size 256, base 1.5x the train size."""
    train = kwargs.pop("tlc_train_size", (256, 256))
    kwargs.setdefault("tlc_base", (int(train[0] * 1.5), int(train[1] * 1.5)))
    return _nafnet(**kwargs)
