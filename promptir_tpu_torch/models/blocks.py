"""Restormer TransformerBlock and PromptIR's dead convs.

Counterpart of promptir_tpu/models/blocks.py. A block computes
  x2 = x + MDTA(LN1(x));  out = x2 + GDFN(LN2(x2)).
`block_forward` replaces the JAX package's `fused_block_apply` and
`apply_block_stack`: every block runs the stats pass, the tiny softmax and
the tail on NHWC views of its channels_last input. It takes the block's
four modules explicitly, so the X-Restormer block's channel half (norm1,
channel_attn, norm2, channel_ffn) runs through it too. `gdfn_forward`
replaces `fused_gdfn_apply` (blocks.py:188): x + GDFN(LN(x)) through the
LN+GDFN kernel. A tensor on the card always goes through the kernels; a
tensor on the CPU through their plain versions. There is no fit gate and
no fallback on the card.
"""

from __future__ import annotations

from torch import nn

from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.cuda.block import block_tail
from promptir_tpu_torch.ops.cuda.gdfn import ln_gdfn
from promptir_tpu_torch.ops.cuda.mdta import attn_from_stats, mdta_stats
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm


def nhwc(x):
    """NHWC view of an NCHW tensor (a copy only if x is not channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x):
    """NCHW (channels_last) view of an NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def block_forward(norm1: LayerNorm, attn: MDTA, norm2: LayerNorm, ffn: GDFN,
                  xh):
    """x2 = x + MDTA(LN1(x)); x2 + GDFN(LN2(x2)) on NHWC `xh`:
    stats kernel -> attn_from_stats -> tail."""
    v, stats = mdta_stats(
        xh, norm1.body.weight, norm1.body.bias, attn.qkv.weight,
        attn.qkv_dwconv.weight, attn.num_heads, bias_free=norm1.bias_free,
        eps=norm1.eps,
    )
    a = attn_from_stats(stats, attn.temperature)
    return block_tail(
        v, xh, a, attn.project_out.weight, norm2.body.weight, norm2.body.bias,
        ffn.project_in.weight, ffn.dwconv.weight, ffn.project_out.weight,
        bias_free=norm2.bias_free, eps=norm2.eps,
    )


def gdfn_forward(norm: LayerNorm, ffn: GDFN, xh):
    """x + GDFN(LN(x)) on NHWC `xh` through the LN+GDFN kernel."""
    return ln_gdfn(
        xh, norm.body.weight, norm.body.bias, ffn.project_in.weight,
        ffn.dwconv.weight, ffn.project_out.weight, bias_free=norm.bias_free,
        eps=norm.eps,
    )


class TransformerBlock(nn.Module):
    """Bias-free convs (the PromptIR family's setting); `bias_free_norm`
    selects the BiasFree LayerNorm."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias_free_norm: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.attn = MDTA(dim, num_heads)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.ffn = GDFN(dim, expansion)

    def forward(self, x):
        return nchw(block_forward(self.norm1, self.attn, self.norm2, self.ffn,
                                  nhwc(x)))


def DeadConv(cin: int, cout: int) -> Conv:
    """A 1x1 conv the reference builds but never calls
    (net/model.py:271-287); released checkpoints hold its weight."""
    return Conv(cin, cout, 1)
