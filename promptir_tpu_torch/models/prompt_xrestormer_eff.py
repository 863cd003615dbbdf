"""PromptXRestormerEff: the X-Restormer U-Net with PromptIR's cheap prompt
interaction.

Counterpart of promptir_tpu/models/prompt_xrestormer_eff.py (reference
net/prompt_xrestormer_eff.py). Its prompt interaction after the latent and
decoder levels 3 and 2 is canonical PromptIR's: PromptGenBlock (bilinear
resize with align_corners=False), a `ChannelTransformerBlock` (channel
attention and GDFN only, one head) at lin_dim + prompt_dim channels, and a
1x1 reduce; its decoder is PromptIR's asymmetric one (`up4_3 =
Upsample(4d)`, `reduce_chan_level3: 6d -> 4d`). Registered as
`promptxrestormereffir`; the reference's state-dict names load verbatim.

A ChannelTransformerBlock is a TransformerBlock under the names
norm1/channel_attn/norm2/channel_ffn, so it runs through
`blocks.block_forward`: mdta_stats and block_tail served, LnMdta and
LnGdfn under autograd, or one LnBlock with `fused_ffn` (as every channel
half of the model then trains). The widened blocks are as wide as
8d + 320, 4d + 128 and 2d + 64 channels (704, 320 and 160 at d = 48).
`use_bias` and `scale` are the X-Restormer's (models/xrestormer.py).
"""

from __future__ import annotations

import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.blocks import block_forward, nchw, nhwc
from promptir_tpu_torch.models.xrestormer import XRestormer
from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.resample import Upsample


class ChannelTransformerBlock(nn.Module):
    """x2 = x + MDTA(LN1(x)); x2 + GDFN(LN2(x2)), bias-free convs unless
    `bias`."""

    def __init__(self, dim: int, num_channel_heads: int = 1,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 fused_ffn: bool = False, bias: bool = False):
        super().__init__()
        self.fused_ffn = fused_ffn
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.channel_attn = MDTA(dim, num_channel_heads, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.channel_ffn = GDFN(dim, expansion, bias)

    def forward(self, x):
        return nchw(block_forward(self.norm1, self.channel_attn, self.norm2,
                                  self.channel_ffn, nhwc(x),
                                  whole=self.fused_ffn))


class PromptXRestormerEff(XRestormer):
    """X-Restormer levels with PromptIR's prompt interaction and decoder.
    With `prompt=False` the latent joins decoder level 3 without a prompt,
    as in the JAX class (its up4_3 then reads the latent's 8d channels)."""

    def __init__(self, dim: int = 48, expansion: float = 2.66,
                 bias_free_norm: bool = False, prompt: bool = True,
                 **kwargs):
        super().__init__(dim=dim, expansion=expansion,
                         bias_free_norm=bias_free_norm, **kwargs)
        d = dim
        self.use_prompt = prompt
        self.up4_3 = Upsample(4 * d)
        if not prompt:
            self.up4_3.body[0] = Conv(8 * d, 8 * d, 3)
        self.reduce_chan_level3 = Conv(6 * d, 4 * d, bias=self.use_bias)
        if not prompt:
            return
        for level, (pdim, size, lin) in {3: (320, 16, 8 * d),
                                         2: (128, 32, 4 * d),
                                         1: (64, 64, 2 * d)}.items():
            setattr(self, f"prompt{level}", PromptGenBlock(pdim, 5, size, lin))
            setattr(self, f"noise_level{level}", ChannelTransformerBlock(
                lin + pdim, 1, expansion, bias_free_norm, self.fused_ffn,
                self.use_bias))
            out = 4 * d if level > 1 else 2 * d
            setattr(self, f"reduce_noise_level{level}",
                    Conv(lin + pdim, out, bias=self.use_bias))

    def prompt(self, level: int, x):
        if not self.use_prompt:
            return x
        p = getattr(self, f"prompt{level}")(x)
        x = getattr(self, f"noise_level{level}")(torch.cat([x, p], 1))
        return getattr(self, f"reduce_noise_level{level}")(x)


@register_model("promptxrestormereffir")
def _promptxrestormereff(**kwargs) -> PromptXRestormerEff:
    return PromptXRestormerEff(**kwargs)
