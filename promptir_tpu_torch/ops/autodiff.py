"""Autograd for the kernels of the training path.

Counterpart of promptir_tpu/ops/pallas/autodiff.py. The kernels are
forward-only. Each Function below runs its kernel in the forward (for a CPU
tensor, the kernel's plain version) and saves only its inputs and weights.
Its backward recomputes the plain composition from those under
`torch.enable_grad()` and differentiates it with `torch.autograd.grad`, so
the gradients are those of the unfused composition, as `jax.vjp` of the XLA
composition gives them in the JAX package:
  * `LnMdta`: x + MDTA(LN(x)) through ops/cuda/mdta.py:ln_mdta; backward
    through `plain_ln_mdta` (xla_ln_mdta, autodiff.py:89);
  * `LnGdfn`: x + GDFN(LN(x)) through ops/cuda/gdfn.py:ln_gdfn; backward
    through `plain_ln_gdfn` (xla_ln_gdfn, autodiff.py:78);
  * `LnBlock`: the whole TransformerBlock, x2 = x + MDTA(LN1(x)) then
    x2 + GDFN(LN2(x2)), through mdta_stats, the softmax and block_tail
    (the route blocks.py:block_forward serves by); backward through
    `plain_ln_block`, plain_ln_mdta then plain_ln_gdfn (_ln_block,
    autodiff.py:165-203). It saves only x and the weights, so the whole
    block is recomputed in its backward: it is its own remat boundary;
  * `Seam`: the decoder level-1 seam through ops/cuda/seam.py:seam; backward
    through `seam_plain` (_xla_seam, seam.py:137), i.e. the inverse data
    movement.

The compositions run the depthwise 3x3 as a grouped `F.conv2d`, not as nine
shifted multiply-adds: differentiating the shifted form costs some 27
passes over the hidden tensor (autodiff.py:56-76).

Mixed precision: a weight that arrives in float32 while x is bfloat16 is
cast to x's dtype inside the forward and inside the recomputed composition,
so its gradient returns in float32; the casts count as weight copies at
"autodiff" and "recompute" (precision.py:weight_as).

The JAX package ties each block's saved inputs to the incoming cotangent
with an optimization barrier (`_serialize_on`), so that XLA does not hoist
every block's recompute ahead of the backward chain. Eager autograd has no
such reordering and needs no barrier: it runs the block backwards one after
the other, each recompute when its cotangent arrives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda.block import block_tail
from promptir_tpu_torch.ops.cuda.gdfn import ln_gdfn
from promptir_tpu_torch.ops.cuda.mdta import attn_from_stats, ln_mdta, mdta_stats
from promptir_tpu_torch.ops.cuda.seam import seam, seam_plain
from promptir_tpu_torch.ops.norm import layernorm_nhwc
from promptir_tpu_torch.precision import weight_as


def _as(dt, site, *ws):
    return [weight_as(w, dt, site) for w in ws]


def plain_ln_mdta(x, lnw, lnb, wqkv, wdw, wproj, temp, num_heads: int,
                  bias_free: bool = False, eps: float = 1e-5):
    """Unfused x + MDTA(LN(x)) on NHWC `x`, with the rounding points of the
    JAX composition: L2 norms, Gram and softmax in float32, the normalized
    q and k, attn and attn v in x's dtype."""
    b, h, w, c = x.shape
    d = c // num_heads
    dt = x.dtype
    y = layernorm_nhwc(x, lnw, lnb, bias_free=bias_free, eps=eps)
    wqkv, wdw, wproj = _as(dt, "recompute", wqkv, wdw, wproj)
    qkv = y @ wqkv.reshape(3 * c, c).t()
    qkv = dwconv3x3_nhwc(qkv, wdw)
    q, k, v = (t.reshape(b, h * w, num_heads, d) for t in qkv.split(c, dim=-1))

    def l2norm(t):
        sq = t.float().square().sum(1, keepdim=True)
        return t * torch.rsqrt(sq.clamp_min(1e-24)).to(dt)

    attn = torch.einsum("bshi,bshj->bhij", l2norm(q).float(), l2norm(k).float())
    attn = attn * temp.float().reshape(1, num_heads, 1, 1)
    attn = attn.softmax(dim=-1).to(dt)
    o = torch.einsum("bhij,bshj->bshi", attn.float(), v.float()).to(dt)
    return x + o.reshape(b, h, w, c) @ wproj.reshape(c, c).t()


def plain_ln_gdfn(x, lnw, lnb, w1, wdw, w2, bias_free: bool = False,
                  eps: float = 1e-5):
    """Unfused x + GDFN(LN(x)) on NHWC `x`, every step in x's dtype."""
    c = x.shape[-1]
    f = w2.reshape(c, -1).shape[1]
    dt = x.dtype
    y = layernorm_nhwc(x, lnw, lnb, bias_free=bias_free, eps=eps)
    w1, wdw, w2 = _as(dt, "recompute", w1, wdw, w2)
    hid = y @ w1.reshape(2 * f, c).t()
    g1, g2 = dwconv3x3_nhwc(hid, wdw).split(f, dim=-1)
    return x + (F.gelu(g1) * g2) @ w2.reshape(c, f).t()


def plain_ln_block(x, ln1w, ln1b, wqkv, wdwa, wproj, temp, ln2w, ln2b, w1,
                   wdwf, w2, num_heads: int, bias_free: bool = False,
                   eps: float = 1e-5):
    """Unfused TransformerBlock on NHWC `x`: plain_ln_mdta, then
    plain_ln_gdfn on its output."""
    x2 = plain_ln_mdta(x, ln1w, ln1b, wqkv, wdwa, wproj, temp, num_heads,
                       bias_free, eps)
    return plain_ln_gdfn(x2, ln2w, ln2b, w1, wdwf, w2, bias_free, eps)


def _recompute_grads(ctx, fn, grad_out, *config):
    """Gradients of fn(*saved, *config) for the inputs that need them."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, need)]
        out = fn(*ins, *config)
        wrt = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad_out.to(out.dtype)))
    return [next(grads) if n else None for n in need]


class LnMdta(torch.autograd.Function):
    """x + MDTA(LN(x)): the stats and apply kernels forward, the plain
    composition's gradient backward."""

    @staticmethod
    def forward(ctx, x, lnw, lnb, wqkv, wdw, wproj, temp, num_heads,
                bias_free, eps):
        ctx.config = (num_heads, bias_free, eps)
        ctx.save_for_backward(x, lnw, lnb, wqkv, wdw, wproj, temp)
        dt = x.dtype
        return ln_mdta(x, *_as(dt, "autodiff", lnw, lnb, wqkv, wdw, wproj),
                       temp, num_heads, bias_free=bias_free, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, plain_ln_mdta, g, *ctx.config)
        return (*grads, None, None, None)


class LnGdfn(torch.autograd.Function):
    """x + GDFN(LN(x)): the LN+GDFN kernels forward, the plain composition's
    gradient backward."""

    @staticmethod
    def forward(ctx, x, lnw, lnb, w1, wdw, w2, bias_free, eps):
        ctx.config = (bias_free, eps)
        ctx.save_for_backward(x, lnw, lnb, w1, wdw, w2)
        dt = x.dtype
        return ln_gdfn(x, *_as(dt, "autodiff", lnw, lnb, w1, wdw, w2),
                       bias_free=bias_free, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, plain_ln_gdfn, g, *ctx.config)
        return (*grads, None, None)


class LnBlock(torch.autograd.Function):
    """The whole TransformerBlock: mdta_stats, the softmax and block_tail
    forward, the plain composition's gradient backward. The weights reach
    the kernels as fresh casts to x's dtype, so no cached bf16 copy of a
    weight that an optimizer step has changed in place is ever read."""

    @staticmethod
    def forward(ctx, x, ln1w, ln1b, wqkv, wdwa, wproj, temp, ln2w, ln2b, w1,
                wdwf, w2, num_heads, bias_free, eps):
        ctx.config = (num_heads, bias_free, eps)
        ctx.save_for_backward(x, ln1w, ln1b, wqkv, wdwa, wproj, temp, ln2w,
                              ln2b, w1, wdwf, w2)
        dt = x.dtype
        v, stats = mdta_stats(x, *_as(dt, "autodiff", ln1w, ln1b, wqkv, wdwa),
                              num_heads, bias_free=bias_free, eps=eps)
        attn = attn_from_stats(stats, temp)
        return block_tail(v, x, attn, *_as(dt, "autodiff", wproj, ln2w, ln2b,
                                           w1, wdwf, w2),
                          bias_free=bias_free, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, plain_ln_block, g, *ctx.config)
        return (*grads, None, None, None)


class Seam(torch.autograd.Function):
    """[pixel_shuffle(y) | skip]: the seam kernel forward, the inverse data
    movement (the gradient of `seam_plain`) backward."""

    @staticmethod
    def forward(ctx, y, skip):
        ctx.save_for_backward(y, skip)
        return seam(y, skip)

    @staticmethod
    def backward(ctx, g):
        return tuple(_recompute_grads(ctx, seam_plain, g))
