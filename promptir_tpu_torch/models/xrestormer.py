"""X-Restormer: channel attention and GDFN, then OCAB and a second GDFN.

Counterpart of promptir_tpu/models/xrestormer.py (reference
net/xrestormer.py:287-500): the 4-norm XTransformerBlock (channel-attn ->
channel-ffn -> OCAB -> spatial-ffn) and the symmetric-decoder U-Net
(`up4_3 = Upsample(8d)`, `reduce_chan_level3: 8d -> 4d`, unlike canonical
PromptIR). State-dict names are the reference's, so its checkpoints load
with `strict=True`.

A block's channel half runs through the stats and tail kernels
(`block_forward`), its spatial FFN through the LN+GDFN kernel
(`gdfn_forward`); OCAB is plain PyTorch, as the JAX package leaves it to
XLA. `fused_ffn` is the JAX model's option (xrestormer.py:36-75): served it
changes nothing, since the channel half always runs the whole-block route;
under autograd it trains the channel half as one `LnBlock` in place of
LnMdta then LnGdfn. The skip concatenations are `torch.cat`, as in the JAX model: the seam
kernel does not run here. `use_bias` gives the convs that the JAX model
builds with it a bias; its blocks then run their plain composition
(blocks.plain_branch) and launch no kernel. `scale > 1` upscales the input
bilinearly (align_corners=False) before the network
(parallel/spatial.py:upscale_input, at global rows under the sharded
forward, as promptir_tpu/parallel/spatial.py:146 does); the window check
applies to the upscaled image, and the global residual adds it.

The model runs under the H-sharded forward (`spatial_hooks`): its blocks'
plain composition, OCAB's neighbour rows (ops/ocab.py), the prompts' GAP
and resize at global rows (ops/prompt.py); each stripe a multiple of 8
windows (eval/padding.py:pad_bases, H % 64 n).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.blocks import (
    block_forward,
    gdfn_forward,
    nchw,
    nhwc,
)
from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.embed import OverlapPatchEmbed
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm, layernorm_nhwc
from promptir_tpu_torch.ops.ocab import OCAB
from promptir_tpu_torch.ops.resample import Downsample, FewChannelConv3, Upsample
from promptir_tpu_torch.parallel.spatial import global_rows, upscale_input
from promptir_tpu_torch.precision import compute_dtype


class XTransformerBlock(nn.Module):
    """channel-attn -> channel-ffn -> spatial-attn (OCAB) -> spatial-ffn,
    each with its own LayerNorm and residual; bias-free convs unless
    `bias` (the models' `use_bias`)."""

    def __init__(self, dim: int, window_size: int = 8,
                 overlap_ratio: float = 0.5, num_channel_heads: int = 1,
                 num_spatial_heads: int = 2, spatial_dim_head: int = 16,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 fused_ffn: bool = False, bias: bool = False):
        super().__init__()
        self.fused_ffn = fused_ffn
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.channel_attn = MDTA(dim, num_channel_heads, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.channel_ffn = GDFN(dim, expansion, bias)
        self.norm3 = LayerNorm(dim, bias_free_norm)
        self.spatial_attn = OCAB(dim, window_size, overlap_ratio,
                                 num_spatial_heads, spatial_dim_head, bias)
        self.norm4 = LayerNorm(dim, bias_free_norm)
        self.spatial_ffn = GDFN(dim, expansion, bias)

    def forward(self, x):
        xh = block_forward(self.norm1, self.channel_attn, self.norm2,
                           self.channel_ffn, nhwc(x), whole=self.fused_ffn)
        n3 = self.norm3
        y = layernorm_nhwc(xh, n3.body.weight, n3.body.bias,
                           bias_free=n3.bias_free, eps=n3.eps)
        xh = xh + self.spatial_attn(y)
        return nchw(gdfn_forward(self.norm4, self.spatial_ffn, xh))


class XRestormer(nn.Module):
    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 channel_heads: Sequence[int] = (1, 2, 4, 8),
                 spatial_heads: Sequence[int] = (2, 2, 3, 4),
                 overlap_ratio: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
                 window_size: int = 8, spatial_dim_head: int = 16,
                 expansion: float = 2.66, use_bias: bool = False,
                 bias_free_norm: bool = False, scale: int = 1,
                 fused_ffn: bool = False):
        super().__init__()
        d, nb = dim, num_blocks
        self.window_size = window_size
        self.fused_ffn = fused_ffn
        self.use_bias = use_bias
        self.scale = scale
        block_kw = dict(window_size=window_size,
                        spatial_dim_head=spatial_dim_head,
                        expansion=expansion, bias_free_norm=bias_free_norm,
                        fused_ffn=fused_ffn, bias=use_bias)

        def stack(n, c, level):
            return nn.Sequential(*[
                XTransformerBlock(
                    c, overlap_ratio=overlap_ratio[level],
                    num_channel_heads=channel_heads[level],
                    num_spatial_heads=spatial_heads[level], **block_kw)
                for _ in range(n)
            ])

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, use_bias)
        self.encoder_level1 = stack(nb[0], d, 0)
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stack(nb[1], 2 * d, 1)
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = stack(nb[2], 4 * d, 2)
        self.down3_4 = Downsample(4 * d)
        self.latent = stack(nb[3], 8 * d, 3)

        self.up4_3 = Upsample(8 * d)
        self.reduce_chan_level3 = Conv(8 * d, 4 * d, bias=use_bias)
        self.decoder_level3 = stack(nb[2], 4 * d, 2)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = Conv(4 * d, 2 * d, bias=use_bias)
        self.decoder_level2 = stack(nb[1], 2 * d, 1)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = stack(nb[0], 2 * d, 0)
        self.refinement = stack(num_refinement_blocks, 2 * d, 0)
        self.output = FewChannelConv3(2 * d, out_channels, use_bias)

    def prompt(self, level: int, x):
        """The prompt interaction after encoder/decoder `level` (3 is the
        latent); none in the plain X-Restormer."""
        return x

    def forward(self, inp_img):
        """inp_img: (B, 3, H, W) float; H and W times `scale` multiples of 8
        windows (64): the window must tile the 1/8 level. Returns the
        restored image in float32, `scale` times the input's size."""
        inp_img = upscale_input(inp_img, self.scale)
        h, w = global_rows(inp_img.shape[-2]), inp_img.shape[-1]
        m = 8 * self.window_size
        if h % m or w % m:
            raise ValueError(f"{type(self).__name__}: H and W must be multiples "
                             f"of {m} (8x8 windows at 1/8 scale), got {h}x{w}")
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


@register_model("xrestormerir")
def _xrestormer(**kwargs) -> XRestormer:
    return XRestormer(**kwargs)
