"""Canonical PromptIR: a 4-level Restormer U-Net with a degradation prompt bank.

Counterpart of promptir_tpu/models/promptir.py (reference
net/model.py:244-380), quirks included, so the reference's 548-tensor state
dict loads with `load_state_dict(strict=True)`:
  * asymmetric decoder: up4_3 = Upsample(4d) and reduce_chan_level3
    (2d + 4d -> 4d);
  * decoder level 1 runs at 2d channels with no reduce after up2_1;
  * prompts (dims 64/128/320, length 5, sizes 64/32/16) join after the
    latent and decoder levels 3 and 2 through a widened TransformerBlock
    (heads[2] for all three) and a 1x1 reduce;
  * the dead convs chnl_reduce{1,2,3} and reduce_noise_channel_{1,2,3};
  * the global residual: output conv + input image.

Activations are NCHW in channels_last memory, so the blocks' kernels see
contiguous NHWC views. The eight level stacks run through
`blocks.run_stack`: block by block (mdta_stats, then block_tail, served),
or with `fused_ffn=True`, served, chained through the merged tail + stats
kernel, 36 launches of it a forward at full depth. In training,
`fused_ffn=True` runs every block, the three noise blocks included, as one
`LnBlock` (mdta_stats and block_tail forward, the whole block recomputed
backward), as the JAX model trains its fused blocks; without it each block
runs LnMdta then LnGdfn. `remat` and `remat_levels` are the JAX model's
(promptir.py:58-120): a block at a remat level runs under a non-reentrant
checkpoint (blocks.run_block), a fused block never. A stack's level is its
width's: d -> 1, 2d -> 2, 4d -> 3, 8d -> 4, so decoder level 1 and the
refinement are level 2; the noise blocks are levels 4, 3 and 2.
`use_bias` gives every conv that the JAX model builds with it a bias
(the blocks, the patch embed, the 1x1 reduces, the dead convs and the
output); the kernels take no bias, so a biased model's blocks run their
plain composition on every device (blocks.plain_branch), its stacks never
chain and its level-1 decoder entry is `torch.cat`: it launches no kernel.
With `decoder=False` the model has no prompts, noise blocks or
reduce_noise_level convs, and up4_3's conv reads the latent's 8d channels,
as flax infers it (the dead convs stay).
The level-1 decoder entry runs through the seam kernel (under `Seam`,
which carries its gradient): up2_1's conv, then pixel-shuffle and the skip
concat in one pass.

Its ops carry the hooks of the exact H-sharded forward
(parallel/spatial.py, `spatial_hooks`): under it the blocks run their
plain composition, the stacks never chain, and the seam, which is
row-local, runs on the stripe.

The forward computes in the model's `compute_dtype` when it has one (a
model for training: float32 weights, bfloat16 activations, as the JAX
model with `dtype=bfloat16`; precision.py), else in the weights' dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.blocks import (
    DeadConv,
    TransformerBlock,
    nchw,
    nhwc,
    run_block,
    run_stack,
)
from promptir_tpu_torch.ops.autodiff import Seam
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.embed import OverlapPatchEmbed
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.resample import Downsample, FewChannelConv3, Upsample
from promptir_tpu_torch.precision import compute_dtype


class PromptIR(nn.Module):
    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66,
                 use_bias: bool = False, bias_free_norm: bool = False,
                 decoder: bool = True,
                 fused_ffn: bool = False, remat: bool = False,
                 remat_levels: Optional[Sequence[int]] = None):
        """`fused_ffn` is named after the JAX model's option
        (promptir_tpu/models/promptir.py:57, 162), which ties the chained
        stacks to its fused kernels. Every route of the port runs the
        kernels, so here it selects, served, the chaining of the level
        stacks (blocks.run_stack, tail_stats), and in training the
        whole-block LnBlock; without it each block runs alone, or as LnMdta
        then LnGdfn. `remat_levels=None` with `remat` checkpoints every
        level."""
        super().__init__()
        self.fused_ffn = fused_ffn
        self.remat = remat
        self.remat_levels = None if remat_levels is None else tuple(remat_levels)
        self.decoder = decoder
        self.use_bias = use_bias
        d, nb, hs = dim, num_blocks, heads

        bias = use_bias

        def stack(n, c, h):
            return nn.Sequential(*[
                TransformerBlock(c, h, expansion, bias_free_norm, bias)
                for _ in range(n)
            ])

        def block(c, h):
            return TransformerBlock(c, h, expansion, bias_free_norm, bias)

        def conv1(cin, cout):
            return Conv(cin, cout, bias=bias)

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, bias)
        # dead layers (checkpoint parity only)
        self.chnl_reduce1 = DeadConv(64, 64, bias)
        self.chnl_reduce2 = DeadConv(128, 128, bias)
        self.chnl_reduce3 = DeadConv(320, 256, bias)
        self.reduce_noise_channel_1 = DeadConv(d + 64, d, bias)
        self.reduce_noise_channel_2 = DeadConv(2 * d + 128, 2 * d, bias)
        self.reduce_noise_channel_3 = DeadConv(4 * d + 256, 4 * d, bias)

        self.encoder_level1 = stack(nb[0], d, hs[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stack(nb[1], 2 * d, hs[1])
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = stack(nb[2], 4 * d, hs[2])
        self.down3_4 = Downsample(4 * d)
        self.latent = stack(nb[3], 8 * d, hs[3])

        if decoder:
            self.prompt1 = PromptGenBlock(64, 5, 64, 2 * d)
            self.prompt2 = PromptGenBlock(128, 5, 32, 4 * d)
            self.prompt3 = PromptGenBlock(320, 5, 16, 8 * d)
            self.noise_level3 = block(8 * d + 320, hs[2])
            self.reduce_noise_level3 = conv1(8 * d + 320, 4 * d)
        self.up4_3 = Upsample(4 * d)
        if not decoder:
            self.up4_3.body[0] = Conv(8 * d, 8 * d, 3)
        self.reduce_chan_level3 = conv1(2 * d + 4 * d, 4 * d)
        self.decoder_level3 = stack(nb[2], 4 * d, hs[2])

        if decoder:
            self.noise_level2 = block(4 * d + 128, hs[2])
            self.reduce_noise_level2 = conv1(4 * d + 128, 4 * d)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = conv1(4 * d, 2 * d)
        self.decoder_level2 = stack(nb[1], 2 * d, hs[1])

        if decoder:
            self.noise_level1 = block(2 * d + 64, hs[2])
            self.reduce_noise_level1 = conv1(2 * d + 64, 2 * d)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = stack(nb[0], 2 * d, hs[0])
        self.refinement = stack(num_refinement_blocks, 2 * d, hs[0])
        self.output = FewChannelConv3(2 * d, out_channels, bias)

    def forward(self, inp_img):
        """inp_img: (B, 3, H, W) float, H and W multiples of 8. Returns the
        restored image in float32."""
        dt = compute_dtype(self)
        inp = inp_img.to(dt).contiguous(memory_format=torch.channels_last)
        cat = torch.cat

        def remat(level):
            return self.remat and (self.remat_levels is None
                                   or level in self.remat_levels)

        def run(s, x, level):
            return nchw(run_stack(s, nhwc(x), self.fused_ffn, remat(level)))

        def prompt(level, x):
            """The prompt interaction after `level`; its noise block is at
            remat level `level + 1` (JAX's promptir.py:242, 313, 325)."""
            if not self.decoder:
                return x
            p = getattr(self, f"prompt{level}")(x)
            x = nchw(run_block(getattr(self, f"noise_level{level}"),
                               nhwc(cat([x, p], 1)), self.fused_ffn,
                               remat(level + 1)))
            return getattr(self, f"reduce_noise_level{level}")(x)

        enc1 = run(self.encoder_level1, self.patch_embed(inp), 1)
        enc2 = run(self.encoder_level2, self.down1_2(enc1), 2)
        enc3 = run(self.encoder_level3, self.down2_3(enc2), 3)
        x = prompt(3, run(self.latent, self.down3_4(enc3), 4))

        x = self.reduce_chan_level3(cat([self.up4_3(x), enc3], 1))
        x = prompt(2, run(self.decoder_level3, x, 3))

        x = self.reduce_chan_level2(cat([self.up3_2(x), enc2], 1))
        x = prompt(1, run(self.decoder_level2, x, 2))

        if self.use_bias:  # a biased model launches no kernel
            x = cat([self.up2_1(x), enc1], 1)
        else:  # up2_1's conv, then pixel-shuffle + skip concat in one pass
            x = nchw(Seam.apply(nhwc(self.up2_1.body[0](x)), nhwc(enc1)))
        x = run(self.refinement, run(self.decoder_level1, x, 2), 2)
        # the global residual in float32, as the JAX package's jitted forward
        # computes it (XLA keeps the bf16 sum in f32 before the final cast)
        return self.output(x).float() + inp.float()


@register_model("promptir")
def _promptir(**kwargs) -> PromptIR:
    return PromptIR(**kwargs)
