"""CAPromptUformerIR: the Uformer skeleton with CAMixer v1 stage blocks.

Counterpart of promptir_tpu/models/camixer_prompt_uformer.py (reference
net/camixer_prompt_uformer.py:1249-1712): every stage block is LN,
CAMixer v1 on the token grid, LN, LeFF (`CAUformerBlock`); the skeleton,
the prompt blocks (LeWin interaction, no modulator) and the projections are
PromptUformerIR's (models/prompt_uformer.py). The mixers see only the
per-window coordinate channels. Registered as `capromptuformerir` (variant
"v1", ratio 0.5, depths 1/2/8/8/2/8/8/2/1).

`forward(x, deterministic=True, generator=None)`, as the JAX model's
`__call__`: deterministic, each mixer keeps its top-k windows and the
forward returns the output; otherwise each mixer samples its routing from
`generator` (a torch.Generator on the model's device) and the forward
returns (output, the mean of the stages' mean decisions), whose ratio loss
the train step adds (train/step.py). It is never keyed on `self.training`:
the engine, the runner and the eval step call `model(x)` and get the
deterministic path, as the JAX eval step does. H and W must be multiples of
128, as for PromptUformerIR. Under a data group (parallel/data.py) the
mean decision is the global batch's (`batch_mean`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from promptir_tpu_torch.models import register_model
from promptir_tpu_torch.models.prompt_uformer import (
    PROMPTS,
    UformerPromptBlock,
    UformerUNet,
)
from promptir_tpu_torch.ops.camixer import CAMixerV1
from promptir_tpu_torch.ops.window_attention import LeFF, TorchLayerNorm
from promptir_tpu_torch.parallel.data import batch_mean


class CAUformerBlock(nn.Module):
    """x + CAMixer(LN(x)), then + LeFF(LN(x)); returns (x, decision)."""

    def __init__(self, dim: int, win_size: int = 8, mlp_ratio: float = 4.0,
                 ratio: float = 0.5):
        super().__init__()
        self.norm1 = TorchLayerNorm(dim)
        self.mixer = CAMixerV1(dim, win_size, ratio)
        self.norm2 = TorchLayerNorm(dim)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))

    def forward(self, x, deterministic: bool = True, generator=None):
        y, decision = self.mixer(self.norm1(x), None, deterministic, generator)
        x = x + y
        return x + self.mlp(self.norm2(x)), decision


class CAUformerLayer(nn.Module):
    """A stage; returns (x, the mean of its blocks' decisions)."""

    def __init__(self, dim: int, depth: int, win_size: int = 8,
                 mlp_ratio: float = 4.0, ratio: float = 0.5):
        super().__init__()
        self.blocks = nn.ModuleList([CAUformerBlock(dim, win_size, mlp_ratio,
                                                    ratio)
                                     for _ in range(depth)])

    def forward(self, x, deterministic: bool = True, generator=None):
        decisions = []
        for blk in self.blocks:
            x, d = blk(x, deterministic, generator)
            decisions.append(d)
        return x, torch.stack(decisions).mean()


class CAPromptUformerIR(UformerUNet):
    variant = "v1"  # the stochastic-training marker the train step reads

    def __init__(self, in_chans: int = 3, dd_in: int = 3, embed_dim: int = 32,
                 depths: Sequence[int] = (2,) * 9, win_size: int = 8,
                 mlp_ratio: float = 4.0, ratio: float = 0.5,
                 token_mlp: str = "leff", prompt: bool = True):
        def stage(i, dim):
            return CAUformerLayer(dim, depths[i], win_size, mlp_ratio, ratio)

        def prompt_block(i, lin):
            pdim, size, heads = PROMPTS[i]
            return UformerPromptBlock(pdim, 5, size, lin, heads, win_size,
                                      mlp_ratio, token_mlp=token_mlp)

        super().__init__(stage, prompt_block, in_chans, dd_in, embed_dim,
                         win_size, prompt)
        self.ratio = ratio

    def forward(self, x, deterministic: bool = True, generator=None):
        decisions = []

        def run(stage, y):
            y, d = stage(y, deterministic, generator)
            decisions.append(d)
            return y

        out = self.unet_forward(x, run)
        if deterministic:
            return out
        return out, batch_mean(torch.stack(decisions).mean())


@register_model("capromptuformerir")
def _capu(**kwargs) -> CAPromptUformerIR:
    kwargs.setdefault("depths", (1, 2, 8, 8, 2, 8, 8, 2, 1))
    return CAPromptUformerIR(**kwargs)
