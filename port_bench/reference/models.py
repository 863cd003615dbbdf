"""Plain float32 PromptIR and PromptXRestormer, built from a configuration.

`build(config)` takes the benchmark's configuration dict (configs/*.json:
`family` and the published constructor arguments) and returns the model
on the CPU in float32. Both follow the published forward passes:

  * PromptIR (net/model.py): a 4-level Restormer U-Net with an asymmetric
    decoder (up4_3 = Upsample(4d), reduce_chan_level3 from 6d), prompt
    blocks after the latent and decoder levels 3 and 2 (a prompt, a
    widened TransformerBlock with heads[2] heads, a 1x1 reduce), decoder
    level 1 at 2d channels, and six convolutions the forward never calls
    (kept so that the state dict loads);
  * PromptXRestormer (net/prompt_xrestormer.py): the symmetric X-Restormer
    U-Net of XTransformerBlocks, with a prompt block (a prompt resized with
    align_corners=True, an XTransformerBlock with one channel head, a 3x3
    reduce) after the latent and decoder levels 3 and 2.

The global residual adds the input image; the output is not clipped here
(the served reply is clipped by the caller, as the engine does).
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.layers import (
    Conv2d,
    Downsample,
    PatchEmbed,
    PromptGenBlock,
    TransformerBlock,
    Upsample,
    XTransformerBlock,
)


class PromptIR(nn.Module):
    def __init__(self, dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4,
                 heads=(1, 2, 4, 8), expansion=2.66, bias_free_norm=False):
        super().__init__()
        d, nb, hs = dim, num_blocks, heads

        def stack(n, c, h):
            return nn.Sequential(*[TransformerBlock(c, h, expansion, bias_free_norm)
                                   for _ in range(n)])

        self.patch_embed = PatchEmbed(3, d)
        self.chnl_reduce1 = Conv2d(64, 64)
        self.chnl_reduce2 = Conv2d(128, 128)
        self.chnl_reduce3 = Conv2d(320, 256)
        self.reduce_noise_channel_1 = Conv2d(d + 64, d)
        self.reduce_noise_channel_2 = Conv2d(2 * d + 128, 2 * d)
        self.reduce_noise_channel_3 = Conv2d(4 * d + 256, 4 * d)
        self.encoder_level1 = stack(nb[0], d, hs[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stack(nb[1], 2 * d, hs[1])
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = stack(nb[2], 4 * d, hs[2])
        self.down3_4 = Downsample(4 * d)
        self.latent = stack(nb[3], 8 * d, hs[3])
        self.prompt1 = PromptGenBlock(64, 5, 64, 2 * d)
        self.prompt2 = PromptGenBlock(128, 5, 32, 4 * d)
        self.prompt3 = PromptGenBlock(320, 5, 16, 8 * d)
        self.noise_level3 = TransformerBlock(8 * d + 320, hs[2], expansion, bias_free_norm)
        self.reduce_noise_level3 = Conv2d(8 * d + 320, 4 * d)
        self.up4_3 = Upsample(4 * d)
        self.reduce_chan_level3 = Conv2d(6 * d, 4 * d)
        self.decoder_level3 = stack(nb[2], 4 * d, hs[2])
        self.noise_level2 = TransformerBlock(4 * d + 128, hs[2], expansion, bias_free_norm)
        self.reduce_noise_level2 = Conv2d(4 * d + 128, 4 * d)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = Conv2d(4 * d, 2 * d)
        self.decoder_level2 = stack(nb[1], 2 * d, hs[1])
        self.noise_level1 = TransformerBlock(2 * d + 64, hs[2], expansion, bias_free_norm)
        self.reduce_noise_level1 = Conv2d(2 * d + 64, 2 * d)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = stack(nb[0], 2 * d, hs[0])
        self.refinement = stack(num_refinement_blocks, 2 * d, hs[0])
        self.output = Conv2d(2 * d, 3, 3)

    def _prompt(self, level, x):
        x = torch.cat([x, getattr(self, f"prompt{level}")(x)], 1)
        x = getattr(self, f"noise_level{level}")(x)
        return getattr(self, f"reduce_noise_level{level}")(x)

    def forward(self, img):
        enc1 = self.encoder_level1(self.patch_embed(img))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        x = self._prompt(3, self.latent(self.down3_4(enc3)))
        x = self.reduce_chan_level3(torch.cat([self.up4_3(x), enc3], 1))
        x = self._prompt(2, self.decoder_level3(x))
        x = self.reduce_chan_level2(torch.cat([self.up3_2(x), enc2], 1))
        x = self._prompt(1, self.decoder_level2(x))
        x = self.decoder_level1(torch.cat([self.up2_1(x), enc1], 1))
        return self.output(self.refinement(x)) + img


class PromptXBlock(PromptGenBlock):
    def __init__(self, prompt_dim, prompt_size, lin_dim, spatial_heads,
                 dim_head, expansion, bias_free_norm):
        super().__init__(prompt_dim, 5, prompt_size, lin_dim, align_corners=True)
        dim = lin_dim + prompt_dim
        self.attn = XTransformerBlock(dim, 8, 0.5, 1, spatial_heads, dim_head,
                                      expansion, bias_free_norm)
        self.conv = Conv2d(dim, lin_dim, 3)

    def forward(self, x):
        return self.conv(self.attn(torch.cat([x, super().forward(x)], 1)))


class PromptXRestormer(nn.Module):
    def __init__(self, dim=48, num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
                 channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8),
                 overlap_ratio=(0.5, 0.5, 0.5, 0.5), window_size=8,
                 spatial_dim_head=16, expansion=2.66, bias_free_norm=False):
        super().__init__()
        d, nb = dim, num_blocks

        def stack(n, c, level):
            return nn.Sequential(*[
                XTransformerBlock(c, window_size, overlap_ratio[level],
                                  channel_heads[level], spatial_heads[level],
                                  spatial_dim_head, expansion, bias_free_norm)
                for _ in range(n)])

        def prompt(prompt_dim, size, lin_dim, heads):
            return PromptXBlock(prompt_dim, size, lin_dim, heads,
                                spatial_dim_head, expansion, bias_free_norm)

        self.patch_embed = PatchEmbed(3, d)
        self.encoder_level1 = stack(nb[0], d, 0)
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stack(nb[1], 2 * d, 1)
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = stack(nb[2], 4 * d, 2)
        self.down3_4 = Downsample(4 * d)
        self.latent = stack(nb[3], 8 * d, 3)
        self.up4_3 = Upsample(8 * d)
        self.reduce_chan_level3 = Conv2d(8 * d, 4 * d)
        self.decoder_level3 = stack(nb[2], 4 * d, 2)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = Conv2d(4 * d, 2 * d)
        self.decoder_level2 = stack(nb[1], 2 * d, 1)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = stack(nb[0], 2 * d, 0)
        self.refinement = stack(num_refinement_blocks, 2 * d, 0)
        self.output = Conv2d(2 * d, 3, 3)
        self.prompt3 = prompt(320, 16, 8 * d, 8)
        self.prompt2 = prompt(128, 32, 4 * d, 4)
        self.prompt1 = prompt(64, 64, 2 * d, 2)

    def forward(self, img):
        enc1 = self.encoder_level1(self.patch_embed(img))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        x = self.prompt3(self.latent(self.down3_4(enc3)))
        x = self.reduce_chan_level3(torch.cat([self.up4_3(x), enc3], 1))
        x = self.prompt2(self.decoder_level3(x))
        x = self.reduce_chan_level2(torch.cat([self.up3_2(x), enc2], 1))
        x = self.prompt1(self.decoder_level2(x))
        x = self.decoder_level1(torch.cat([self.up2_1(x), enc1], 1))
        return self.output(self.refinement(x)) + img


FAMILIES = {"promptir": PromptIR, "promptxrestormer": PromptXRestormer}


def build(config: dict) -> nn.Module:
    """The reference model of a configuration file's dict, float32 on the
    CPU (move it with `.to(device)`)."""
    return FAMILIES[config["family"]](**config["model"])
