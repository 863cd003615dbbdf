"""Prompt generation block: the degradation prompt bank of PromptIR.

Counterpart of promptir_tpu/ops/prompt.py (reference
net/model.py:218-235). softmax(Linear(GAP(x))) mixes a
learned bank of `prompt_len` maps (uniform [0, 1) init); the mixture is
resized bilinearly to the feature size and passed through a bias-free 3x3
conv. Rounding points as the JAX module's (promptir_tpu/ops/prompt.py:36-38,
63-67): the GAP (an fp32 mean) and the Linear in x's dtype, the softmax
and the mix in float32, the mix rounded to x's dtype before the resize,
which computes in float32 and rounds again.

Under the H-sharded forward (parallel/spatial.py) `x` is a stripe: the GAP
is the whole image's (`global_mean_hw`), and the mix is resized at the
global rows (the stripe's times the group size) and sliced to the stripe,
as the JAX module does (promptir_tpu/ops/prompt.py:34-70).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.resize import resize_bilinear
from promptir_tpu_torch.precision import weight_as
from promptir_tpu_torch.parallel.mesh import group_size
from promptir_tpu_torch.parallel.spatial import (
    current_spatial_group,
    global_mean_hw,
    slice_local_rows,
)


class PromptGenBlock(nn.Module):
    def __init__(self, prompt_dim: int = 128, prompt_len: int = 5,
                 prompt_size: int = 96, lin_dim: int = 192,
                 align_corners: bool = False):
        super().__init__()
        self.prompt_param = nn.Parameter(
            torch.rand(1, prompt_len, prompt_dim, prompt_size, prompt_size)
        )
        self.linear_layer = nn.Linear(lin_dim, prompt_len)
        self.conv3x3 = Conv(prompt_dim, prompt_dim, 3)
        self.align_corners = align_corners

    def forward(self, x):
        h, w = x.shape[-2:]
        dt = x.dtype
        emb = global_mean_hw(x, dims=(-2, -1), keepdim=False).to(dt)
        lin = self.linear_layer
        logits = F.linear(emb, weight_as(lin.weight, dt, "prompt"),
                          weight_as(lin.bias, dt, "prompt"))
        weights = logits.float().softmax(-1)
        prompt = torch.einsum("bl,lchw->bchw", weights,
                              self.prompt_param[0].float()).to(dt)
        group = current_spatial_group()
        if group is None:
            prompt = resize_bilinear(prompt.float(), (h, w), self.align_corners)
        else:
            prompt = slice_local_rows(
                resize_bilinear(prompt.float(), (h * group_size(group), w),
                                self.align_corners), group, dim=2)
        return self.conv3x3(prompt.to(dt))
