"""PromptUformerIR: the 9-stage Uformer U-Net with prompt blocks.

Counterpart of promptir_tpu/models/prompt_uformer.py (reference
net/prompt_uformer.py:1130-1381): a 3x3 input projection and LeakyReLU,
four encoder stages of LeWin blocks with 4x4 stride-2 convolutions down, a
bottleneck stage, four decoder stages with 2x2 transposed convolutions up
and the skips concatenated (`[up, skip]`), a 3x3 output projection and the
global residual. Shifted windows on the odd blocks of a stage; per-window
modulators in the decoder stages and the prompt blocks when `modulator`.
The prompt blocks (prompt generation with align_corners=True, a LeWin block
at lin_dim + prompt_dim channels, a bias-free 3x3 reduce) follow the
bottleneck and decoder stages 0-2 with the literal prompt dims
512/512/256/128, sizes 8/16/32/64 and heads 16/8/4/2, whatever the embed
width. Registered as `promptuformerir` with the JAX defaults (embed 32,
depths 1/2/8/8/2/8/8/2/1, modulator on); the reference's state-dict names
load verbatim (855 keys at the defaults, the 44 `relative_position_index`
buffers among them).

The model takes and returns NCHW; inside, the stages work channels-last,
as the JAX model does. H and W must be multiples of 16 * win (128): four
downsamples, then win x win windows; eval/padding.py:pad_bases gives the
base, and a forward off it raises. The global residual is summed in
float32: the JAX model writes a bf16 sum cast to float32, which its jitted
forward keeps in float32 (tests/test_torch_uformer.py measures it).
`drop_path_rate` is the JAX model's stochastic depth: rates from 0 up to it
over the encoder blocks, it at the bottleneck, the encoder's reversed over
the decoder, none in the prompt blocks; sampled only by `forward(x,
deterministic=False, generator=...)` (the trainers apply this model
deterministically, as promptir_tpu/train/trainer.py:71 does).
`cross_modulator` is accepted and read by nothing, as in the JAX body.

Both Uformers run under the H-sharded forward (`spatial_hooks`,
parallel/spatial.py): the LeWin blocks' sharded shifts and gathered deep
levels (ops/window_attention.py), the 4x4/s2 downsamples' strided halo
(ops/conv.py), the row-local transposed 2x2/s2 upsamples, the prompts' GAP
and resize at global rows (ops/prompt.py); H a multiple of 128 and of
16 n (eval/padding.py:pad_bases).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.window_attention import (
    InputProj,
    LeWinTransformerBlock,
    OutputProj,
    UformerDownsample,
    UformerUpsample,
    conv_nhwc,
)
from promptir_tpu_torch.parallel.spatial import global_rows
from promptir_tpu_torch.precision import compute_dtype

# (prompt_dim, prompt_size, heads) of promptlayer_0..3; the block's width
# is the stage's plus prompt_dim
PROMPTS = ((512, 8, 16), (512, 16, 8), (256, 32, 4), (128, 64, 2))


class BasicUformerLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, win_size: int = 8,
                 mlp_ratio: float = 4.0, token_projection: str = "linear",
                 token_mlp: str = "leff", shift_flag: bool = True,
                 modulator: bool = False, drop_path: Sequence[float] = ()):
        super().__init__()
        self.blocks = nn.ModuleList([
            LeWinTransformerBlock(
                dim, num_heads, win_size,
                0 if (i % 2 == 0 or not shift_flag) else win_size // 2,
                mlp_ratio, token_projection, token_mlp, modulator,
                drop_path[i] if i < len(drop_path) else 0.0)
            for i in range(depth)])

    def forward(self, x, deterministic: bool = True, generator=None):
        for blk in self.blocks:
            x = blk(x, deterministic, generator)
        return x


class UformerPromptBlock(PromptGenBlock):
    """The prompt bank's keys (`prompt_param`, `linear_layer`, `conv3x3`) at
    the block's own level, then `attn`, a LeWin block of the concatenation
    (shift 0), and `conv`, a bias-free 3x3 back to lin_dim. NHWC."""

    def __init__(self, prompt_dim: int, prompt_len: int, prompt_size: int,
                 lin_dim: int, num_heads: int, win_size: int = 8,
                 mlp_ratio: float = 4.0, token_projection: str = "linear",
                 token_mlp: str = "leff", modulator: bool = False):
        super().__init__(prompt_dim, prompt_len, prompt_size, lin_dim,
                         align_corners=True)
        width = lin_dim + prompt_dim
        self.attn = LeWinTransformerBlock(
            width, num_heads, win_size, 0, mlp_ratio, token_projection,
            token_mlp, modulator)
        self.conv = Conv(width, lin_dim, 3)

    def forward(self, x):
        prompt = super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return conv_nhwc(self.attn(torch.cat([x, prompt], -1)), self.conv)


class UformerUNet(nn.Module):
    """The skeleton shared with models/camixer_prompt_uformer.py.

    `stage(i, dim)` builds stage i at `dim` channels (0-3 the encoders, 4
    the bottleneck, 5-8 the decoders) and `prompt(i, lin_dim)` prompt
    block i. `unet_forward(x, run)` calls `run(stage, y)` for every stage."""

    spatial_hooks = True  # parallel/spatial.py:spatial_sharded_apply runs it

    def __init__(self, stage: Callable, prompt: Callable, in_chans: int,
                 dd_in: int, embed_dim: int, win_size: int, use_prompt: bool):
        super().__init__()
        e = embed_dim
        self.dd_in, self.win_size, self.use_prompt = dd_in, win_size, use_prompt
        self.input_proj = InputProj(dd_in, e)
        self.output_proj = OutputProj(2 * e, in_chans)
        for i in range(4):
            setattr(self, f"encoderlayer_{i}", stage(i, e * 2 ** i))
            setattr(self, f"dowsample_{i}",
                    UformerDownsample(e * 2 ** i, e * 2 ** (i + 1)))
        self.conv = stage(4, 16 * e)
        # upsample i: from 16e (i = 0, 1) or 2^(4-i) e, to 2^(3-i) e, joined
        # by the skip of as many channels
        for i in range(4):
            cin = 16 * e if i == 0 else e * 2 ** (5 - i)
            setattr(self, f"upsample_{i}", UformerUpsample(cin, e * 2 ** (3 - i)))
            setattr(self, f"decoderlayer_{i}", stage(5 + i, e * 2 ** (4 - i)))
        if use_prompt:
            for i in range(4):
                setattr(self, f"promptlayer_{i}", prompt(i, 16 * e if i < 2
                                                         else e * 2 ** (5 - i)))

    def unet_forward(self, x, run):
        """x: (B, C, H, W). Returns the restored image, float32 NCHW."""
        win = self.win_size
        h, w = global_rows(x.shape[-2]), x.shape[-1]
        if h % (16 * win) or w % (16 * win):
            raise ValueError(
                f"{type(self).__name__}: H and W must be multiples of "
                f"{16 * win} (four downsamples, then {win}x{win} windows), "
                f"got {h}x{w}; pad the image to eval/padding.py:pad_bases")
        inp = x.to(compute_dtype(self)).permute(0, 2, 3, 1).contiguous()
        y = self.input_proj(inp)
        skips = []
        for i in range(4):
            y = run(getattr(self, f"encoderlayer_{i}"), y)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y)
        y = run(self.conv, y)
        for i in range(4):
            if self.use_prompt:
                y = getattr(self, f"promptlayer_{i}")(y)
            y = torch.cat([getattr(self, f"upsample_{i}")(y), skips[3 - i]], -1)
            y = run(getattr(self, f"decoderlayer_{i}"), y)
        # the global residual in float32, as the JAX package's jitted forward
        # computes it (XLA keeps the bf16 sum in f32 before the final cast)
        out = self.output_proj(y).float()
        if self.dd_in == 3:
            out = out + inp.float()
        return out.permute(0, 3, 1, 2)


class PromptUformerIR(UformerUNet):
    def __init__(self, in_chans: int = 3, dd_in: int = 3, embed_dim: int = 32,
                 depths: Sequence[int] = (2,) * 9,
                 num_heads: Sequence[int] = (1, 2, 4, 8, 16, 16, 8, 4, 2),
                 win_size: int = 8, mlp_ratio: float = 4.0,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 drop_path_rate: float = 0.1, shift_flag: bool = True,
                 modulator: bool = False, cross_modulator: bool = False,
                 prompt: bool = True):
        enc = np.linspace(0, drop_path_rate, sum(depths[:4])).tolist()
        at = np.cumsum([0, *depths[:4]]).tolist()
        dec = np.cumsum([0, *depths[5:]]).tolist()
        rates = ([enc[at[i]:at[i + 1]] for i in range(4)]
                 + [[drop_path_rate] * depths[4]]
                 + [enc[::-1][dec[i]:dec[i + 1]] for i in range(4)])

        def stage(i, dim):
            return BasicUformerLayer(
                dim, depths[i], num_heads[i], win_size, mlp_ratio,
                token_projection, token_mlp, shift_flag,
                modulator and i >= 5, rates[i])

        def prompt_block(i, lin):
            pdim, size, heads = PROMPTS[i]
            return UformerPromptBlock(pdim, 5, size, lin, heads, win_size,
                                      mlp_ratio, token_projection, token_mlp,
                                      modulator)

        super().__init__(stage, prompt_block, in_chans, dd_in, embed_dim,
                         win_size, prompt)

    def forward(self, x, deterministic: bool = True, generator=None):
        return self.unet_forward(
            x, lambda stage, y: stage(y, deterministic, generator))


@register_model("promptuformerir")
def _promptuformer(**kwargs) -> PromptUformerIR:
    kwargs.setdefault("depths", (1, 2, 8, 8, 2, 8, 8, 2, 1))
    kwargs.setdefault("modulator", True)
    return PromptUformerIR(**kwargs)
