"""EasyPromptXRestormer: the attention-free prompt model.

Counterpart of promptir_tpu/models/easy_promptxrestormer.py (reference
net/easy_promptxrestormer.py:369-490): EasyTransformerBlocks everywhere
(inner_dim 16/32/64/128 a level) in `EasyLayer` stacks (torch key
`<stage>.layer.<i>`), PromptGenBlock with an EasyChannelTransformerBlock
and a 1x1 reduce as the prompt interaction after the latent and decoder
levels 3 and 2, and PromptIR's asymmetric decoder (`up4_3 =
Upsample(4d)`, `reduce_chan_level3: 6d -> 4d`). The prompt blocks' widths
come from the concatenation (8d + 320, 4d + 128, 2d + 64), as in the JAX
class: the reference's literals equal them only at d = 48. Registered as
`easypromptxrestormer`; the reference's state-dict names load verbatim.

No kernel of the port runs on this path (ops/easy.py). The forward
computes in the model's compute dtype (precision.py) and returns float32.
Not ported: the JAX class's `use_bias` (the reference's all-in-one config
has no conv biases there), as for `xrestormerir`. It runs under the
H-sharded forward (`spatial_hooks`; ops/easy.py's hooks and the prompts').
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.easy import (
    EasyChannelTransformerBlock,
    EasyTransformerBlock,
)
from promptir_tpu_torch.ops.embed import OverlapPatchEmbed
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.resample import Downsample, FewChannelConv3, Upsample
from promptir_tpu_torch.precision import compute_dtype


class EasyLayer(nn.Module):
    """A stack of EasyTransformerBlocks (the reference's XRestormerLayer)."""

    def __init__(self, dim: int, depth: int, inner_dim: int,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 bias: bool = False):
        super().__init__()
        self.layer = nn.Sequential(*[
            EasyTransformerBlock(dim, inner_dim, expansion, bias_free_norm,
                                 bias)
            for _ in range(depth)
        ])

    def forward(self, x):
        return self.layer(x)


class EasyPromptXRestormer(nn.Module):
    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 inner_dim: Sequence[int] = (16, 32, 64, 128),
                 expansion: float = 2.66, use_bias: bool = False,
                 bias_free_norm: bool = False, prompt: bool = True):
        super().__init__()
        d, nb = dim, num_blocks
        self.use_prompt = prompt

        def layer(c, depth, level):
            return EasyLayer(c, depth, inner_dim[level], expansion,
                             bias_free_norm, use_bias)

        def conv1(cin, cout):
            return Conv(cin, cout, bias=use_bias)

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, use_bias)
        self.encoder_level1 = layer(d, nb[0], 0)
        self.down1_2 = Downsample(d)
        self.encoder_level2 = layer(2 * d, nb[1], 1)
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = layer(4 * d, nb[2], 2)
        self.down3_4 = Downsample(4 * d)
        self.latent = layer(8 * d, nb[3], 3)

        if prompt:
            for level, (pdim, size, lin) in {3: (320, 16, 8 * d),
                                             2: (128, 32, 4 * d),
                                             1: (64, 64, 2 * d)}.items():
                setattr(self, f"prompt{level}",
                        PromptGenBlock(pdim, 5, size, lin))
                setattr(self, f"noise_level{level}",
                        EasyChannelTransformerBlock(lin + pdim, expansion,
                                                    bias_free_norm, use_bias))
                out = 4 * d if level > 1 else 2 * d
                setattr(self, f"reduce_noise_level{level}",
                        conv1(lin + pdim, out))

        self.up4_3 = Upsample(4 * d)
        if not prompt:  # the latent's 8d channels reach up4_3's conv
            self.up4_3.body[0] = Conv(8 * d, 8 * d, 3)
        self.reduce_chan_level3 = conv1(2 * d + 4 * d, 4 * d)
        self.decoder_level3 = layer(4 * d, nb[2], 2)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = conv1(2 * d + 2 * d, 2 * d)
        self.decoder_level2 = layer(2 * d, nb[1], 1)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = layer(2 * d, nb[0], 0)
        self.refinement = layer(2 * d, num_refinement_blocks, 0)
        self.output = FewChannelConv3(2 * d, out_channels, use_bias)

    def prompt(self, level: int, x):
        if not self.use_prompt:
            return x
        p = getattr(self, f"prompt{level}")(x)
        x = getattr(self, f"noise_level{level}")(torch.cat([x, p], 1))
        return getattr(self, f"reduce_noise_level{level}")(x)

    def forward(self, inp_img):
        """inp_img: (B, 3, H, W) float, H and W multiples of 8. Returns the
        restored image in float32."""
        dt = compute_dtype(self)
        inp = inp_img.to(dt).contiguous(memory_format=torch.channels_last)
        cat = torch.cat

        enc1 = self.encoder_level1(self.patch_embed(inp))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        x = self.prompt(3, self.latent(self.down3_4(enc3)))

        x = self.reduce_chan_level3(cat([self.up4_3(x), enc3], 1))
        x = self.prompt(2, self.decoder_level3(x))
        x = self.reduce_chan_level2(cat([self.up3_2(x), enc2], 1))
        x = self.prompt(1, self.decoder_level2(x))
        x = self.decoder_level1(cat([self.up2_1(x), enc1], 1))
        x = self.refinement(x)
        # the global residual in float32, as the JAX package's jitted forward
        # computes it (XLA keeps the bf16 sum in f32 before the final cast)
        return self.output(x).float() + inp.float()


@register_model("easypromptxrestormer")
def _easy(**kwargs) -> EasyPromptXRestormer:
    return EasyPromptXRestormer(**kwargs)
