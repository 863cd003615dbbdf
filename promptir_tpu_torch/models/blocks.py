"""Restormer TransformerBlock and PromptIR's dead convs.

Counterpart of promptir_tpu/models/blocks.py. A block computes
  x2 = x + MDTA(LN1(x));  out = x2 + GDFN(LN2(x2)).
`block_forward` replaces the JAX package's `fused_block_apply` and
`apply_block_stack`, on NHWC views of a channels_last input. It takes the
block's four modules explicitly, so the X-Restormer block's channel half
(norm1, channel_attn, norm2, channel_ffn) runs through it too. It has three
routes, chosen by what the caller asks of autograd:
  * inference (no gradient recorded): the stats kernel, the tiny softmax and
    the block tail, the whole-block route (`ln_block`, autodiff.py:286);
  * training (autograd records, and the input or a weight of the block
    requires grad): the per-branch route of blocks.py:174-185, `LnMdta`
    (stats, softmax, the apply kernel) then `LnGdfn`. Each saves only its
    input and weights and recomputes its branch in the backward, so x2 is
    the saved boundary between the two branches' backward passes and no
    backward recompute spans the whole block;
  * training with `whole` (the models' `fused_ffn`, as the JAX package's
    fused blocks train through `ln_block`, blocks.py:135): `LnBlock`, the
    inference route's kernels forward, and one recompute of the whole block
    in the backward, from its input and weights alone.
`run_block` adds the JAX models' `remat` (nn.remat of a TransformerBlock,
promptir.py:58-120): under autograd a block that is not `whole` runs under
a non-reentrant `torch.utils.checkpoint`, so its forward's saved tensors
are dropped and the forward (its kernels included) runs again in the
backward. The reentrant form would run the first forward without grad, on
the inference route, and recompute on the training route. A whole block
is never wrapped: LnBlock is its own remat boundary, as JAX's fused blocks
are (promptir.py:81-90).
The JAX package picks between its routes by whether a stripe fits VMEM
(autodiff.py:256 block_fits). A Hopper block has no VMEM budget to copy;
the port picks by mode, and never falls back.
`run_stack` replaces `apply_block_stack` (blocks.py:254) for a stack of
TransformerBlocks: `run_block` per block, or, when the caller asks for
the chain (PromptIR's `fused_ffn`) and autograd does not record, block n's
tail and block n+1's stats pass in one `tail_stats` (ops/cuda/megablock.py),
so that a stack of n blocks runs one mdta_stats, n - 1 tail_stats and one
block_tail. Under autograd the chain becomes `whole` blocks: the
tail_stats chain is inference only.
`gdfn_forward` replaces `fused_gdfn_apply` (blocks.py:188): x + GDFN(LN(x))
through the LN+GDFN kernel, under `LnGdfn` when autograd records.
The kernels take no conv bias. A block built with one (the models'
`use_bias`) runs its modules' plain composition on every device
(`plain_branch`), as the JAX models run their unfused blocks under
`fused_ffn and not use_bias` (promptir.py:81, xrestormer.py:58): a gate
chosen by the model's configuration, never a fallback on failure. So does
every block under the H-sharded forward (parallel/spatial.py), a gate
chosen by the mode, and no stack chains there: the kernels sum their Gram
over their whole input and zero-pad its top and bottom rows, which on a
stripe would be wrong; the modules' ops carry the sharded reductions.
Weights are cast to the activations' dtype at use, so a model with float32
weights can compute in bfloat16; without autograd the cast copy is kept
beside its weight (`cast_weight`, ops/cuda/packed.py). A tensor on the card
always goes through the kernels; a tensor on the CPU through their plain
versions.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.autodiff import LnBlock, LnGdfn, LnMdta
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.cuda.block import block_tail
from promptir_tpu_torch.ops.cuda.gdfn import ln_gdfn
from promptir_tpu_torch.ops.cuda.mdta import attn_from_stats, mdta_stats
from promptir_tpu_torch.ops.cuda.megablock import tail_stats
from promptir_tpu_torch.ops.cuda.packed import cast_weight
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm
from promptir_tpu_torch.parallel.spatial import current_spatial_group


def records_grad(*tensors) -> bool:
    """True when autograd records and one of the tensors requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def nhwc(x):
    """NHWC view of an NCHW tensor (a copy only if x is not channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x):
    """NCHW (channels_last) view of an NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def biased(conv) -> bool:
    """True when `conv` carries a bias: its block runs the plain route."""
    return conv.bias is not None


def runs_plain(conv) -> bool:
    """True when the block of `conv` runs its plain composition: a biased
    block, or any block under the H-sharded forward."""
    return biased(conv) or current_spatial_group() is not None


def plain_branch(norm, module, xh):
    """xh + module(norm(xh)) on NHWC `xh` through the modules' own
    forward (NCHW, channels_last): the route of a biased block."""
    return xh + nhwc(module(norm(nchw(xh))))


def _cast(dt, *ws):
    return [cast_weight(t, dt) for t in ws]


def block_forward(norm1: LayerNorm, attn: MDTA, norm2: LayerNorm, ffn: GDFN,
                  xh, whole: bool = False):
    """x2 = x + MDTA(LN1(x)); x2 + GDFN(LN2(x2)) on NHWC `xh`; under
    autograd through LnBlock with `whole`, else LnMdta then LnGdfn; a
    biased block, or one under the H-sharded forward, through its modules'
    plain composition."""
    if runs_plain(attn.qkv):
        return plain_branch(norm2, ffn, plain_branch(norm1, attn, xh))
    wa = (norm1.body.weight, norm1.body.bias, attn.qkv.weight,
          attn.qkv_dwconv.weight, attn.project_out.weight)
    wf = (norm2.body.weight, norm2.body.bias, ffn.project_in.weight,
          ffn.dwconv.weight, ffn.project_out.weight)
    if records_grad(xh, *wa, attn.temperature, *wf):
        if whole:
            return LnBlock.apply(xh, *wa, attn.temperature, *wf,
                                 attn.num_heads, norm1.bias_free, norm1.eps)
        x2 = LnMdta.apply(xh, *wa, attn.temperature, attn.num_heads,
                          norm1.bias_free, norm1.eps)
        return LnGdfn.apply(x2, *wf, norm2.bias_free, norm2.eps)
    lnw, lnb, wqkv, wdw, wproj = _cast(xh.dtype, *wa)
    v, stats = mdta_stats(xh, lnw, lnb, wqkv, wdw, attn.num_heads,
                          bias_free=norm1.bias_free, eps=norm1.eps)
    a = attn_from_stats(stats, attn.temperature)
    return block_tail(v, xh, a, wproj, *_cast(xh.dtype, *wf),
                      bias_free=norm2.bias_free, eps=norm2.eps)


def _stats_weights(blk, dt):
    return _cast(dt, blk.norm1.body.weight, blk.norm1.body.bias,
                 blk.attn.qkv.weight, blk.attn.qkv_dwconv.weight)


def _tail_weights(blk, dt):
    return _cast(dt, blk.attn.project_out.weight, blk.norm2.body.weight,
                 blk.norm2.body.bias, blk.ffn.project_in.weight,
                 blk.ffn.dwconv.weight, blk.ffn.project_out.weight)


def run_block(blk, xh, whole: bool = False, remat: bool = False):
    """TransformerBlock `blk` on NHWC `xh` through `block_forward`; under
    autograd, with `remat` and without `whole`, inside a non-reentrant
    checkpoint. A biased block is never `whole`: it checkpoints under
    `remat` as the JAX models' unfused blocks do."""
    whole = whole and not biased(blk.attn.qkv)
    args = (blk.norm1, blk.attn, blk.norm2, blk.ffn, xh)
    if remat and not whole and records_grad(xh, *blk.parameters()):
        return checkpoint(block_forward, *args, use_reentrant=False)
    return block_forward(*args, whole=whole)


def run_stack(stack, xh, chain: bool = False, remat: bool = False):
    """The blocks of `stack` (an nn.Sequential of TransformerBlocks) on NHWC
    `xh`. With `chain`, and without autograd, two or more blocks run
    chained: mdta_stats of block 0; for each n, block n's softmax, then its
    tail fused with block n+1's stats pass (`tail_stats`); block_tail of the
    last block. Otherwise each block runs `run_block`, `whole` when the
    chain was asked for, under a checkpoint with `remat`."""
    blocks = list(stack)
    if (not chain or len(blocks) < 2 or runs_plain(blocks[0].attn.qkv)
            or records_grad(xh, *stack.parameters())):
        for blk in blocks:
            xh = run_block(blk, xh, whole=chain, remat=remat)
        return xh
    dt = xh.dtype
    first = blocks[0]
    v, stats = mdta_stats(xh, *_stats_weights(first, dt), first.attn.num_heads,
                          bias_free=first.norm1.bias_free, eps=first.norm1.eps)
    for blk, nxt in zip(blocks, blocks[1:]):
        a = attn_from_stats(stats, blk.attn.temperature)
        xh, v, stats = tail_stats(
            v, xh, a, *_tail_weights(blk, dt), *_stats_weights(nxt, dt),
            nxt.attn.num_heads, bias_free=blk.norm2.bias_free,
            eps=blk.norm2.eps)
    last = blocks[-1]
    a = attn_from_stats(stats, last.attn.temperature)
    return block_tail(v, xh, a, *_tail_weights(last, dt),
                      bias_free=last.norm2.bias_free, eps=last.norm2.eps)


def gdfn_forward(norm: LayerNorm, ffn: GDFN, xh):
    """x + GDFN(LN(x)) on NHWC `xh` through the LN+GDFN kernel (a biased
    GDFN, or one under the H-sharded forward, through its plain
    composition)."""
    if runs_plain(ffn.project_in):
        return plain_branch(norm, ffn, xh)
    ws = (norm.body.weight, norm.body.bias, ffn.project_in.weight,
          ffn.dwconv.weight, ffn.project_out.weight)
    if records_grad(xh, *ws):
        return LnGdfn.apply(xh, *ws, norm.bias_free, norm.eps)
    return ln_gdfn(xh, *_cast(xh.dtype, *ws), bias_free=norm.bias_free,
                   eps=norm.eps)


class TransformerBlock(nn.Module):
    """Bias-free convs by default (the PromptIR family's setting; `bias`
    is the models' `use_bias`); `bias_free_norm` selects the BiasFree
    LayerNorm."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias_free_norm: bool = False, bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.attn = MDTA(dim, num_heads, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.ffn = GDFN(dim, expansion, bias)

    def forward(self, x):
        return nchw(block_forward(self.norm1, self.attn, self.norm2, self.ffn,
                                  nhwc(x)))


def DeadConv(cin: int, cout: int, bias: bool = False) -> Conv:
    """A 1x1 conv the reference builds but never calls
    (net/model.py:271-287); released checkpoints hold its weight."""
    return Conv(cin, cout, 1, bias=bias)
