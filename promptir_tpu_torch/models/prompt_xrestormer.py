"""PromptXRestormer: the X-Restormer U-Net with prompt interaction blocks.

Counterpart of promptir_tpu/models/prompt_xrestormer.py (reference
net/prompt_xrestormer.py:322-473). `PromptXBlock` is prompt generation
(bilinear resize with align_corners=True, :351), an XTransformerBlock at
lin_dim + prompt_dim channels with one channel head, and a 3x3 reduce
conv; the blocks run after the latent and decoder levels 3 and 2 of the
symmetric X-Restormer decoder; with `prompt=False` none are built and the
model is the X-Restormer (promptir_tpu/models/prompt_xrestormer.py:90).
`use_bias` reaches the blocks' convs, not the prompt convs, as in JAX.
"""

from __future__ import annotations

import torch

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.xrestormer import XRestormer, XTransformerBlock
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.prompt import PromptGenBlock


class PromptXBlock(PromptGenBlock):
    """Prompt generation (`prompt_param`, `linear_layer`, `conv3x3`, from
    PromptGenBlock) + X-block interaction (`attn`) + 3x3 reduce (`conv`)."""

    def __init__(self, prompt_dim: int, prompt_len: int, prompt_size: int,
                 lin_dim: int, window_size: int = 8,
                 overlap_ratio: float = 0.5, num_channel_heads: int = 1,
                 num_spatial_heads: int = 2, spatial_dim_head: int = 16,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 fused_ffn: bool = False, bias: bool = False):
        super().__init__(prompt_dim, prompt_len, prompt_size, lin_dim,
                         align_corners=True)
        dim = lin_dim + prompt_dim
        self.attn = XTransformerBlock(
            dim, window_size, overlap_ratio, num_channel_heads,
            num_spatial_heads, spatial_dim_head, expansion, bias_free_norm,
            fused_ffn, bias)
        self.conv = Conv(dim, lin_dim, 3)

    def forward(self, x):
        y = torch.cat([x, super().forward(x)], 1)
        return self.conv(self.attn(y))


class PromptXRestormer(XRestormer):
    """Symmetric X-Restormer + PromptXBlocks after latent / dec3 / dec2."""

    def __init__(self, dim: int = 48, spatial_dim_head: int = 16,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 prompt: bool = True, **kwargs):
        super().__init__(dim=dim, spatial_dim_head=spatial_dim_head,
                         expansion=expansion, bias_free_norm=bias_free_norm,
                         **kwargs)
        d = dim
        self.use_prompt = prompt
        if not prompt:
            return

        def block(prompt_dim, prompt_size, lin_dim, sp_heads):
            return PromptXBlock(
                prompt_dim, 5, prompt_size, lin_dim, window_size=8,
                overlap_ratio=0.5, num_channel_heads=1,
                num_spatial_heads=sp_heads, spatial_dim_head=spatial_dim_head,
                expansion=expansion, bias_free_norm=bias_free_norm,
                fused_ffn=self.fused_ffn, bias=self.use_bias)

        self.prompt3 = block(320, 16, 8 * d, 8)
        self.prompt2 = block(128, 32, 4 * d, 4)
        self.prompt1 = block(64, 64, 2 * d, 2)

    def prompt(self, level: int, x):
        if not self.use_prompt:
            return x
        return getattr(self, f"prompt{level}")(x)


@register_model("promptxrestormerir")
def _promptxrestormer(**kwargs) -> PromptXRestormer:
    return PromptXRestormer(**kwargs)
