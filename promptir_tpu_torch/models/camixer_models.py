"""The CAMixer X-Restormers: PromptIR's asymmetric U-Net with routed blocks.

Counterpart of promptir_tpu/models/camixer_models.py (reference
net/camixer_prompt_xrestormer_eff.py:670-867, camixer_prompt_xrestormer_
effv2.py:776-934, ca_ta_promptxrestormer.py:746-918). Three models share
one skeleton (`CAPromptXRestormer`) and a condition map: `global_predictor`
(a 1x1 to 8 channels, LeakyReLU(0.1), a 3x3 to 2, LeakyReLU(0.1)) on the
level-1 features, resized bilinearly (align_corners=False, in float32,
rounded once) to each level, where every block's mixer sees it:
  * `capromptxrestormereff` (variant "v1"): `CATransformerBlock` with
    CAMixer v1 (deformable keys);
  * `capromptxrestormereffv2` ("v2"): `CATransformerBlock` with CAMixer v2
    (overlapping windows and the relative position bias);
  * `catapromptxrestormer` ("cata"): `CATABlock`, CAMixer v2 and then a
    per-image choice between a hard branch (GDFN, MDTA, GDFN) and an easy
    one (the NAF-style Easy ops), both computed for every image and mixed
    by the `BranchSelector`'s label.
A stage is `CALayer` (keys `<stage>.layer.<i>`, the reference's
XRestormerLayer). The prompt interaction after the latent and decoder
levels 3 and 2 is PromptIR's (PromptGenBlock, then a channel block at
8d + 320, 4d + 128 and 2d + 64 channels, the concatenation's widths, then a
1x1 reduce): Eff's `ChannelTransformerBlock` (one head) for v1 and v2,
`EasyChannelTransformerBlock` for CATA. The state-dict names are the
reference's. `use_bias` biases the convs that the JAX models build with it
(not the mixers', which keep their own); a biased block runs its plain
composition (blocks.plain_branch) and launches no kernel.

The blocks work on NHWC views. Their channel half, x + MDTA(LN(x)) then +
GDFN(LN(x)), runs `blocks.block_forward` (mdta_stats and block_tail when
serving, LnMdta and LnGdfn under autograd), their spatial FFN
`blocks.gdfn_forward` (ln_gdfn); so does the CATA hard branch, whose norm2,
norm3 and norm4 the easy branch shares. The mixers and the Easy ops are
plain PyTorch, as the JAX package leaves them to XLA.

`forward(x, deterministic=True, generator=None)`, as the JAX model's
`__call__`: deterministic, the mixers keep their top-k windows, the
selector its top max(1, round(B * hard_ratio)) images of the batch, and
the forward returns the output. Otherwise every block samples from
`generator` (a torch.Generator on the model's device; the selector draws
before the mixer) and the forward returns (output, mean decision) for v1,
(output, ratio loss) for v2 and (output, ratio loss, hard-ratio loss) for
CATA, each loss 2 * r * (mean - 0.5)^2. It is never keyed on
`self.training`. H and W must be multiples of 8 windows (64).

Under the H-sharded forward (`spatial_hooks`, parallel/spatial.py) the
mixers gather their level (ops/camixer.py), the selector pools the whole
image, and the condition pyramid is resized at global rows
(`conditions`); H need only be a multiple of 64 and of 8 n
(eval/padding.py:pad_bases). Under a data group (parallel/data.py) the
training terms' batch means are the global batch's (`batch_mean`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.blocks import (
    block_forward,
    gdfn_forward,
    nchw,
    nhwc,
)
from promptir_tpu_torch.models.prompt_xrestormer_eff import (
    ChannelTransformerBlock,
)
from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.camixer import (
    BranchSelector,
    CAMixerV1,
    CAMixerV2,
    pointwise,
)
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.easy import (
    EasyChannelAttention,
    EasyChannelTransformerBlock,
    EasyFeedForward,
)
from promptir_tpu_torch.ops.embed import OverlapPatchEmbed
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm, layernorm_nhwc
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.resample import Downsample, FewChannelConv3, Upsample
from promptir_tpu_torch.ops.resize import resize_bilinear
from promptir_tpu_torch.ops.window_attention import conv_nhwc
from promptir_tpu_torch.parallel.data import batch_mean
from promptir_tpu_torch.parallel.spatial import (
    current_spatial_group,
    global_rows,
    sharded_resize_bilinear,
)
from promptir_tpu_torch.precision import compute_dtype

COND_DIM = 2  # the global predictor's channels


def norm_nhwc(norm: LayerNorm, xh):
    return layernorm_nhwc(xh, norm.body.weight, norm.body.bias,
                          bias_free=norm.bias_free, eps=norm.eps)


class CATransformerBlock(nn.Module):
    """channel-attn -> channel-ffn -> CAMixer `mixer` -> spatial-ffn, each
    behind its LayerNorm; bias-free convs unless `bias`. NHWC; returns (x,
    decision)."""

    def __init__(self, dim: int, mixer: nn.Module, num_channel_heads: int = 1,
                 expansion: float = 2.66, bias_free_norm: bool = False,
                 bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.channel_attn = MDTA(dim, num_channel_heads, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.channel_ffn = GDFN(dim, expansion, bias)
        self.norm3 = LayerNorm(dim, bias_free_norm)
        self.spatial_attn = mixer
        self.norm4 = LayerNorm(dim, bias_free_norm)
        self.spatial_ffn = GDFN(dim, expansion, bias)

    def forward(self, xh, cond, deterministic: bool = True, generator=None):
        xh = block_forward(self.norm1, self.channel_attn, self.norm2,
                           self.channel_ffn, xh)
        y, decision = self.spatial_attn(norm_nhwc(self.norm3, xh), cond,
                                        deterministic, generator)
        return gdfn_forward(self.norm4, self.spatial_ffn, xh + y), decision


class CATABlock(nn.Module):
    """CAMixer v2, then the hard and easy branches mixed per image by the
    branch selector's label. NHWC; returns (x, decision, mean label)."""

    def __init__(self, dim: int, window_size: int = 8, ratio: float = 0.5,
                 hard_ratio: float = 0.5, num_channel_heads: int = 1,
                 num_heads: int = 4, dim_head: int = 16,
                 overlap_ratio: float = 0.5, expansion: float = 2.66,
                 bias_free_norm: bool = False, bias: bool = False):
        super().__init__()
        for i in (1, 2, 3, 4):
            setattr(self, f"norm{i}", LayerNorm(dim, bias_free_norm))
        self.branch_selector = BranchSelector(dim, hard_ratio)
        self.spatial_attn = CAMixerV2(dim, window_size, overlap_ratio,
                                      num_heads, dim_head, ratio,
                                      cond_dim=COND_DIM)
        self.hard_spatial_ffn = GDFN(dim, expansion, bias)
        self.hard_channel_attn = MDTA(dim, num_channel_heads, bias)
        self.hard_channel_ffn = GDFN(dim, expansion, bias)
        self.easy_spatial_ffn = EasyFeedForward(dim, expansion, bias)
        self.easy_channel_attn = EasyChannelAttention(dim, bias)
        self.easy_channel_ffn = EasyFeedForward(dim, expansion, bias)

    def forward(self, xh, cond, deterministic: bool = True, generator=None):
        label = self.branch_selector(xh, deterministic, generator)  # (B,)
        y, decision = self.spatial_attn(norm_nhwc(self.norm1, xh), cond,
                                        deterministic, generator)
        xh = xh + y
        hard = gdfn_forward(self.norm2, self.hard_spatial_ffn, xh)
        hard = block_forward(self.norm3, self.hard_channel_attn, self.norm4,
                             self.hard_channel_ffn, hard)
        easy = nchw(xh)
        easy = easy + self.easy_spatial_ffn(self.norm2(easy))
        easy = easy + self.easy_channel_attn(self.norm3(easy))
        easy = easy + self.easy_channel_ffn(self.norm4(easy))
        lbl = label[:, None, None, None].to(hard.dtype)
        return hard * lbl + nhwc(easy) * (1.0 - lbl), decision, label.mean()


class CALayer(nn.Module):
    """A stage of CA blocks on NHWC `x`: returns (x, the mean of the blocks'
    decisions, the mean of their mean labels or None)."""

    def __init__(self, blocks):
        super().__init__()
        self.layer = nn.ModuleList(blocks)

    def forward(self, xh, cond, deterministic: bool = True, generator=None):
        decisions, labels = [], []
        for blk in self.layer:
            xh, decision, *label = blk(xh, cond, deterministic, generator)
            decisions.append(decision)
            labels += label
        return (xh, torch.stack(decisions).mean(),
                torch.stack(labels).mean() if labels else None)


class CAPromptXRestormer(nn.Module):
    """The CA family's skeleton; subclasses set `variant`."""

    variant = "v2"  # "v1" | "v2" | "cata": the train step reads it
    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 channel_heads: Sequence[int] = (1, 2, 4, 8),
                 spatial_heads: Sequence[int] = (1, 2, 4, 8),
                 window_size: int = 8, dim_head: int = 16,
                 overlap_ratio: float = 0.5, ratio: float = 0.5,
                 hard_ratio: float = 0.5, expansion: float = 2.66,
                 use_bias: bool = False, bias_free_norm: bool = False,
                 prompt: bool = True):
        super().__init__()
        d, nb = dim, num_blocks
        self.window_size = window_size
        self.ratio, self.hard_ratio = ratio, hard_ratio
        self.use_prompt = prompt

        def block(c, level):
            if self.variant == "cata":
                return CATABlock(c, window_size, ratio, hard_ratio,
                                 channel_heads[level], spatial_heads[level],
                                 dim_head, overlap_ratio, expansion,
                                 bias_free_norm, use_bias)
            if self.variant == "v1":
                mixer = CAMixerV1(c, window_size, ratio, cond_dim=COND_DIM)
            else:
                mixer = CAMixerV2(c, window_size, overlap_ratio,
                                  spatial_heads[level], dim_head, ratio,
                                  cond_dim=COND_DIM)
            return CATransformerBlock(c, mixer, channel_heads[level],
                                      expansion, bias_free_norm, use_bias)

        def stage(n, c, level):
            return CALayer([block(c, level) for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, use_bias)
        self.global_predictor = nn.Sequential(
            Conv(d, 8, bias=True), nn.LeakyReLU(0.1),
            Conv(8, COND_DIM, 3, bias=True), nn.LeakyReLU(0.1))
        self.encoder_level1 = stage(nb[0], d, 0)
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stage(nb[1], 2 * d, 1)
        self.down2_3 = Downsample(2 * d)
        self.encoder_level3 = stage(nb[2], 4 * d, 2)
        self.down3_4 = Downsample(4 * d)
        self.latent = stage(nb[3], 8 * d, 3)

        self.up4_3 = Upsample(4 * d)
        if not prompt:  # flax infers the latent's 8d channels
            self.up4_3.body[0] = Conv(8 * d, 8 * d, 3)
        self.reduce_chan_level3 = Conv(6 * d, 4 * d, bias=use_bias)
        self.decoder_level3 = stage(nb[2], 4 * d, 2)
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = Conv(4 * d, 2 * d, bias=use_bias)
        self.decoder_level2 = stage(nb[1], 2 * d, 1)
        self.up2_1 = Upsample(2 * d)
        self.decoder_level1 = stage(nb[0], 2 * d, 0)
        self.refinement = stage(num_refinement_blocks, 2 * d, 0)
        self.output = FewChannelConv3(2 * d, out_channels, use_bias)
        if not prompt:
            return
        for level, (pdim, size, lin) in {3: (320, 16, 8 * d),
                                         2: (128, 32, 4 * d),
                                         1: (64, 64, 2 * d)}.items():
            setattr(self, f"prompt{level}", PromptGenBlock(pdim, 5, size, lin))
            if self.variant == "cata":
                inter = EasyChannelTransformerBlock(lin + pdim, expansion,
                                                    bias_free_norm, use_bias)
            else:
                inter = ChannelTransformerBlock(lin + pdim, 1, expansion,
                                                bias_free_norm, bias=use_bias)
            setattr(self, f"noise_level{level}", inter)
            out = 4 * d if level > 1 else 2 * d
            setattr(self, f"reduce_noise_level{level}",
                    Conv(lin + pdim, out, bias=use_bias))

    def prompt(self, level: int, x):
        if not self.use_prompt:
            return x
        p = getattr(self, f"prompt{level}")(x)
        x = getattr(self, f"noise_level{level}")(torch.cat([x, p], 1))
        return getattr(self, f"reduce_noise_level{level}")(x)

    def conditions(self, xh, h: int, w: int):
        """The global predictor's NHWC condition at each level's size (`h`
        the whole image's rows): its pyramid is resized in float32 and
        rounded once, as JAX's; under the sharded forward at global rows,
        each level's stripe kept (JAX models/camixer_models.py:292-306)."""
        gp = self.global_predictor
        g = F.leaky_relu(pointwise(xh, gp[0]), 0.1)
        cond = F.leaky_relu(conv_nhwc(g, gp[2]), 0.1)
        group = current_spatial_group()
        conds = [cond]
        for s in (2, 4, 8):
            c = nchw(cond).float()
            if group is None:
                c = resize_bilinear(c, (h // s, w // s))
            else:
                c = sharded_resize_bilinear(c, (h // s, w // s), group)
            conds.append(nhwc(c.to(cond.dtype)))
        return conds

    def forward(self, inp_img, deterministic: bool = True, generator=None):
        """inp_img: (B, 3, H, W) float, H and W multiples of 8 windows (64).
        Returns the restored image in float32 (with the training terms
        when not `deterministic`, see the module's docstring)."""
        h, w = global_rows(inp_img.shape[-2]), inp_img.shape[-1]
        m = 8 * self.window_size
        if h % m or w % m:
            raise ValueError(f"{type(self).__name__}: H and W must be multiples "
                             f"of {m} (8x8 windows at 1/8 scale), got {h}x{w}")
        dt = compute_dtype(self)
        inp = inp_img.to(dt).contiguous(memory_format=torch.channels_last)
        cat = torch.cat
        decisions, labels = [], []

        def run(stage, x, cond):
            yh, decision, label = stage(nhwc(x), cond, deterministic,
                                        generator)
            decisions.append(decision)
            if label is not None:
                labels.append(label)
            return nchw(yh)

        x = self.patch_embed(inp)
        c1, c2, c3, c4 = self.conditions(nhwc(x), h, w)
        enc1 = run(self.encoder_level1, x, c1)
        enc2 = run(self.encoder_level2, self.down1_2(enc1), c2)
        enc3 = run(self.encoder_level3, self.down2_3(enc2), c3)
        x = self.prompt(3, run(self.latent, self.down3_4(enc3), c4))

        x = self.reduce_chan_level3(cat([self.up4_3(x), enc3], 1))
        x = self.prompt(2, run(self.decoder_level3, x, c3))
        x = self.reduce_chan_level2(cat([self.up3_2(x), enc2], 1))
        x = self.prompt(1, run(self.decoder_level2, x, c2))
        x = run(self.decoder_level1, cat([self.up2_1(x), enc1], 1), c1)
        x = run(self.refinement, x, c1)
        # the global residual in float32, as the JAX package's jitted forward
        # computes it
        out = self.output(x).float() + inp.float()
        if deterministic:
            return out
        decision = batch_mean(torch.stack(decisions).mean())
        if self.variant == "v1":
            return out, decision
        ratio_loss = 2.0 * self.ratio * (decision - 0.5).square()
        if self.variant == "v2":
            return out, ratio_loss
        hard = batch_mean(torch.stack(labels).mean())
        return out, ratio_loss, 2.0 * self.hard_ratio * (hard - 0.5).square()


class CAPromptXRestormerEff(CAPromptXRestormer):
    variant = "v1"


class CAPromptXRestormerEffv2(CAPromptXRestormer):
    variant = "v2"


class CATAPromptXRestormer(CAPromptXRestormer):
    variant = "cata"


@register_model("capromptxrestormereff")
def _ca_v1(**kwargs) -> CAPromptXRestormerEff:
    return CAPromptXRestormerEff(**kwargs)


@register_model("capromptxrestormereffv2")
def _ca_v2(**kwargs) -> CAPromptXRestormerEffv2:
    return CAPromptXRestormerEffv2(**kwargs)


@register_model("catapromptxrestormer")
def _cata(**kwargs) -> CATAPromptXRestormer:
    return CATAPromptXRestormer(**kwargs)
