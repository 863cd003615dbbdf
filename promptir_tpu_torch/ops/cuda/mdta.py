"""MDTA statistics pass (kernel 1 of a TransformerBlock) and its softmax.

`mdta_stats` replaces promptir_tpu/ops/pallas/mdta.py:317 mdta_stats:
LN1 -> 1x1 qkv -> depthwise 3x3 of an NHWC input, writing v and the
whole-image Gram q^T k and squared norms of q and k of every head; q and k
never reach memory. The kernel is csrc/mdta_stats.cu. `attn_from_stats`
(promptir_tpu/ops/pallas/mdta.py:211) is the tiny softmax over those
statistics and stays plain PyTorch.

Rounding points, shared by the kernel and the plain version: LN1's output
is rounded to x's dtype; qkv and the taps stay fp32; v is rounded to x's
dtype; the Gram and norms are fp32 sums. In float32 this is the unfused
composition exactly.
"""

from __future__ import annotations

import ctypes
import math

import torch

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import build
from promptir_tpu_torch.ops.norm import layernorm_nhwc

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may opt in to
GEMM_STAGE_FLOATS = 2 * 32 * 65  # gemm_tile's two kTileK x kLd staging tiles
QKV_CHUNK = 64  # qkv rows of one product pass (kTileN)

_P = ctypes.c_void_p
_I = ctypes.c_int


def stats_tile(d: int) -> tuple[int, int]:
    """Interior (rows, cols) of one stats block's tile for head width d:
    large for the d = 48 stacks, smaller where the fp32 q and k of the tile
    would outgrow shared memory (4 x 6 = 24 pixels above d = 352: at the
    one-head d = 704 block their 24 * 1408 fp32 take 135 KB)."""
    if d <= 64:
        return 14, 14
    if d <= 96:
        return 6, 14
    if d <= 352:
        return 6, 6
    return 4, 6


def stats_smem(c: int, num_heads: int) -> int:
    """Shared-memory bytes of one stats block; csrc/mdta_stats.cu carves its
    dynamic shared memory in this order: q and k of the interior pixels
    (pi x 2d fp32), the qkv chunk of the halo pixels (ph x 64 fp32), the
    two product staging tiles, the halo's LN mean and rstd (fp32) and its
    flat pixel indices (int32)."""
    d = c // num_heads
    th, tw = stats_tile(d)
    ph, pi = (th + 2) * (tw + 2), th * tw
    return (pi * 2 * d + ph * QKV_CHUNK + GEMM_STAGE_FLOATS + 2 * ph) * 4 + ph * 4


def _launch(x, lnw, lnb, wqkv, wdw, num_heads, bias_free, eps):
    b, h, w, c = x.shape
    d = c // num_heads
    th, tw = stats_tile(d)
    smem = stats_smem(c, num_heads)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mdta_stats: C={c}, heads={num_heads} needs {smem} "
                         f"bytes of shared memory (> {SMEM_LIMIT})")
    tiles = -(-h // th) * -(-w // tw)
    n = d * d + 2 * d
    v = torch.empty_like(x)
    # partial Grams and norms of every tile: 381 MB at B = 4, (32, 32, 704),
    # one head (48 tiles of 4 x 6 pixels)
    part = torch.empty((b, num_heads, tiles, n), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((b, num_heads, n), device=x.device, dtype=torch.float32)
    fn = build.function("mdta_stats_launch",
                        [_I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 8
                        + [ctypes.c_float, ctypes.c_longlong, _P])
    code = fn(build.dtype_code(x), x.data_ptr(), lnw.data_ptr(),
              None if lnb is None else lnb.data_ptr(), wqkv.data_ptr(),
              wdw.data_ptr(), v.data_ptr(), part.data_ptr(), stats.data_ptr(),
              b, h, w, c, num_heads, th, tw, int(bias_free), eps, smem,
              build.stream_of(x))
    build.check(code, "mdta_stats")
    return v, stats


def mdta_stats(x, ln_w, ln_b, w_qkv, w_dw, num_heads: int, *,
               bias_free: bool = False, eps: float = 1e-5):
    """Stats pass of NHWC `x` (B, H, W, C).

    ln_w, ln_b: (C,) (ln_b is unused when bias_free); w_qkv: the qkv conv
    weight, (3C, C, 1, 1) or (3C, C); w_dw: the depthwise weight, (3C, 1, 3,
    3) or (3C, 9). Returns v (B, H, W, C) in x's dtype and stats (B, heads,
    d*d + 2d) float32: [Gram q^T k (d x d) | ||q||^2 (d) | ||k||^2 (d)] per
    head, summed over the image.
    """
    b, h, w, c = x.shape
    if c % num_heads or (c // num_heads) % 4:
        raise ValueError(f"mdta_stats: head width {c}/{num_heads} must be a "
                         "multiple of 4")
    wqkv = w_qkv.reshape(3 * c, c)
    wdw = w_dw.reshape(3 * c, 9)
    if x.device.type == "cpu":
        return mdta_stats_plain(x, ln_w, ln_b, wqkv, wdw, num_heads,
                                bias_free=bias_free, eps=eps)
    args = [x, ln_w, None if bias_free else ln_b, wqkv, wdw]
    for t in args:
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise TypeError("mdta_stats: weights must match x's device and dtype")
    args = [None if t is None else t.contiguous() for t in args]
    out = _launch(*args, num_heads, bias_free, eps)
    mdta_stats.launches += 1
    return out


mdta_stats.launches = 0


def mdta_stats_plain(x, ln_w, ln_b, w_qkv, w_dw, num_heads: int, *,
                     bias_free: bool = False, eps: float = 1e-5):
    """The same function in plain PyTorch (fp32 arithmetic, the kernel's
    rounding points)."""
    b, h, w, c = x.shape
    d = c // num_heads
    dt = x.dtype
    y = layernorm_nhwc(x.float(), ln_w, ln_b, bias_free=bias_free, eps=eps)
    y = y.to(dt).float()
    qkv = dwconv3x3_nhwc(y @ w_qkv.reshape(3 * c, c).float().t(),
                         w_dw.reshape(3 * c, 9).float())
    q, k, v = qkv.split(c, dim=-1)
    q = q.reshape(b, h * w, num_heads, d)
    k = k.reshape(b, h * w, num_heads, d)
    gram = torch.einsum("bphi,bphj->bhij", q, k).reshape(b, num_heads, d * d)
    stats = torch.cat([gram, q.square().sum(1), k.square().sum(1)], dim=-1)
    return v.to(dt).contiguous(), stats


def attn_from_stats(stats, temperature):
    """(B, heads, d*d + 2d) statistics -> (B, heads, d, d) float32 attention:
    softmax over channels of temperature * q^T k / (||q|| ||k||), with the
    norms clamped at 1e-12 as `F.normalize` clamps them."""
    b, heads, n = stats.shape
    d = math.isqrt(n + 1) - 1
    gram = stats[..., : d * d].reshape(b, heads, d, d)
    nq = stats[..., d * d: d * d + d].sqrt().clamp_min(1e-12)
    nk = stats[..., d * d + d:].sqrt().clamp_min(1e-12)
    logits = gram / (nq[..., :, None] * nk[..., None, :])
    logits = logits * temperature.float().reshape(1, heads, 1, 1)
    return logits.softmax(dim=-1)
