"""MDTA: the statistics pass, its softmax, and the apply pass.

`mdta_stats` replaces promptir_tpu/ops/pallas/mdta.py:317 mdta_stats:
LN1 -> 1x1 qkv -> depthwise 3x3 of an NHWC input, writing v and the
whole-image Gram q^T k and squared norms of q and k of every head; q and k
never reach memory. The kernel is csrc/mdta_stats.cu. `attn_from_stats`
(promptir_tpu/ops/pallas/mdta.py:211) is the tiny softmax over those
statistics and stays plain PyTorch.

`ln_mdta` replaces promptir_tpu/ops/pallas/mdta.py:252 fused_ln_mdta,
x + MDTA(LN(x)): the stats kernel, the softmax, then `mdta_apply`, whose
kernel (csrc/ln_mdta.cu) computes x2 = x + W_proj (attn v) and counts its
launches in `ln_mdta.launches`.

Rounding points, shared by the kernels and the plain versions: LN1's output
is rounded to x's dtype; qkv and the taps stay fp32; v is rounded to x's
dtype; q and k enter the Gram rounded to x's dtype and their squared norms
sum the unrounded fp32 values (the Pallas kernel's rounding,
promptir_tpu/ops/pallas/mdta.py:113-124); attn enters the apply rounded to
x's dtype (promptir_tpu/ops/attention.py:81), attn v is rounded to x's
dtype and the projection is an fp32 product. In float32 this is the unfused
composition exactly.

The kernels dispatch by dtype: float32 takes the SIMT tile of
csrc/common.cuh (gemm_tile), bfloat16 the tensor cores (tc_gemm), whose
shared-memory carving the *_smem functions here mirror.
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
QKV_CHUNK = 64  # qkv rows of one product pass (kTileN; the bf16 route's too)
PIXELS = 64  # pixels of a bf16 apply, tail_a or ln_gdfn_a block (kPT)
PRE_LD = 72  # row stride of the bf16 stats pass's qkv chunk (kPreLd)
# The stats pass's slots (see stats_slots): at least STATS_BLOCKS blocks over
# all images and heads (two per SM of the H100's 132), and more, up to one a
# tile, while their partial Grams fit STATS_BUDGET bytes.
STATS_BLOCKS = 264
STATS_BUDGET = 128 << 20

_P = ctypes.c_void_p
_I = ctypes.c_int


def tc_ld(k: int) -> int:
    """Row stride, in elements, of a bf16 operand tile of k columns
    (csrc/common.cuh:tc_ld)."""
    return -(-k // 16) * 16 + 8


def tc_wbuf(np_: int) -> int:
    """bf16 elements of tc_gemm's weight double buffer for passes of np_
    output channels (TcShape::WBUF)."""
    return 2 * np_ * tc_ld(32)


PROJ_WBUF = tc_wbuf(256)  # the pointwise products' buffer (ProjGemm)


def stats_tc_bytes(ph: int, pi: int, d: int) -> int:
    """Bytes of the bf16 stats pass's scratch for a halo of ph pixels, pi
    interior pixels and head width d (csrc/mdta_stats.cuh:StatsTcSmem): the
    qkv chunk (ph x PRE_LD fp32), q and k channel-major in bf16 (d rounded up
    to 32 rows of tc_ld(pi)), the qkv product's weight buffer, the norms'
    partial sums, the halo's LN1 mean, rstd and pixel indices."""
    rows = -(-d // 32) * 32
    return (ph * PRE_LD * 4 + 2 * rows * tc_ld(pi) * 2 + tc_wbuf(QKV_CHUNK) * 2
            + 256 * 4 + (3 * ph + 3) // 4 * 16)


def stats_rows(ph: int) -> int:
    """Rows of the bf16 stats pass's operand for a halo of ph pixels: 48
    (the 4 x 6 tile), else ph rounded up to 64 (csrc/mdta_stats.cu)."""
    return 48 if ph <= 48 else -(-ph // 64) * 64


STATS_TILES = ((14, 14), (6, 14), (6, 6), (4, 6))


def _stats_bytes(c: int, d: int, tile, dtype) -> int:
    th, tw = tile
    ph, pi = (th + 2) * (tw + 2), th * tw
    if dtype == torch.bfloat16:
        return stats_rows(ph) * tc_ld(c) * 2 + stats_tc_bytes(ph, pi, d)
    return (pi * 2 * d + ph * QKV_CHUNK + GEMM_STAGE_FLOATS + 2 * ph) * 4 + ph * 4


def stats_tile(d: int, c: int = 0, dtype=torch.float32) -> tuple[int, int]:
    """Interior (rows, cols) of one stats block's tile for head width d:
    large for the d = 48 stacks, smaller where the fp32 q and k of the tile
    would outgrow shared memory (4 x 6 = 24 pixels above d = 352: at the
    one-head d = 704 block their 24 * 1408 fp32 take 135 KB). In bfloat16,
    where LN1's output of the whole halo (C channels) is staged for the
    tensor cores, the next smaller of STATS_TILES while that one does not
    fit at width c (6 x 14 for the d = 48 heads at C = 192 and 384)."""
    if d <= 64:
        i = 0
    elif d <= 96:
        i = 1
    elif d <= 352:
        i = 2
    else:
        i = 3
    if dtype == torch.bfloat16:
        while i + 1 < len(STATS_TILES) and _stats_bytes(
                c, d, STATS_TILES[i], dtype) > SMEM_LIMIT:
            i += 1
    return STATS_TILES[i]


def stats_smem(c: int, num_heads: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one stats block; csrc/mdta_stats.cu carves its
    dynamic shared memory in this order. float32 (stats_kernel): q and k of
    the interior pixels (pi x 2d fp32), the qkv chunk of the halo pixels
    (ph x 64 fp32), the two product staging tiles, the halo's LN mean and
    rstd (fp32) and its flat pixel indices (int32). bfloat16
    (stats_tc_kernel): LN1's output on the halo (stats_rows(ph) rows of
    tc_ld(C) bf16), then stats_tc_bytes."""
    d = c // num_heads
    return _stats_bytes(c, d, stats_tile(d, c, dtype), dtype)


def stats_slots(b: int, h: int, w: int, c: int, num_heads: int,
                dtype=torch.float32) -> int:
    """Slots of one (image, head): the stats blocks of it, each summing the
    tiles slot, slot + nslots, ... into its own partial Gram. One a tile
    while the partial Grams fit STATS_BUDGET (every narrow head), else
    enough for about STATS_BLOCKS blocks: the buffer is at most
    max(STATS_BUDGET, (STATS_BLOCKS + b * heads) slots) and does not grow
    with the image."""
    d = c // num_heads
    th, tw = stats_tile(d, c, dtype)
    tiles = -(-h // th) * -(-w // tw)
    per_slot = 4 * b * num_heads * (d * d + 2 * d)
    return min(tiles, max(-(-STATS_BLOCKS // (b * num_heads)),
                          STATS_BUDGET // per_slot))


def stats_partial_bytes(b: int, h: int, w: int, c: int, num_heads: int,
                        dtype=torch.float32) -> int:
    """Bytes of the kernel's partial-Gram buffer (B, heads, nslots, d^2 + 2d)
    fp32 for an input of (b, h, w, c)."""
    d = c // num_heads
    return (4 * b * num_heads * stats_slots(b, h, w, c, num_heads, dtype)
            * (d * d + 2 * d))


def _launch(x, lnw, lnb, wqkv, wdw, num_heads, bias_free, eps):
    b, h, w, c = x.shape
    d = c // num_heads
    th, tw = stats_tile(d, c, x.dtype)
    smem = stats_smem(c, num_heads, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mdta_stats: C={c}, heads={num_heads} needs {smem} "
                         f"bytes of shared memory (> {SMEM_LIMIT})")
    nslots = stats_slots(b, h, w, c, num_heads, x.dtype)
    n = d * d + 2 * d
    v = torch.empty_like(x)
    part = torch.empty((b, num_heads, nslots, n), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((b, num_heads, n), device=x.device, dtype=torch.float32)
    fn = build.function("mdta_stats_launch",
                        [_I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 9
                        + [ctypes.c_float, ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), x.data_ptr(), lnw.data_ptr(),
                  None if lnb is None else lnb.data_ptr(), wqkv.data_ptr(),
                  wdw.data_ptr(), v.data_ptr(), part.data_ptr(),
                  stats.data_ptr(), b, h, w, c, num_heads, th, tw, nslots,
                  int(bias_free), eps, smem, build.stream_of(x))
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
    check_tc_width(x, c, num_heads, "mdta_stats")
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
    gram = torch.einsum("bphi,bphj->bhij", q.to(dt).float(), k.to(dt).float())
    stats = torch.cat([gram.reshape(b, num_heads, d * d), q.square().sum(1),
                       k.square().sum(1)], dim=-1)
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


def apply_mp(c: int) -> int:
    """16-pixel groups of one apply block's tile: 64 pixels up to C = 256,
    else 32 (more blocks for the narrow deep levels), as block_tail's
    tail_a."""
    return 4 if c <= 256 else 2


def ln_mdta_smem(c: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one apply block (csrc/ln_mdta.cu). float32: attn
    v of its pixels (C x 16 mp fp32) and the product staging tiles;
    bfloat16: v (then x2) and attn v of 64 pixels (64 x tc_ld(C) bf16
    each) and the weight double buffer."""
    if dtype == torch.bfloat16:
        return 2 * PIXELS * tc_ld(c) * 2 + PROJ_WBUF * 2
    return (c * 16 * apply_mp(c) + GEMM_STAGE_FLOATS) * 4


def check_tc_width(x, c: int, heads: int, what: str) -> None:
    """The bf16 kernels stage operands in 16-byte pieces, head by head: C
    and the head width must be multiples of 8 (every served width is)."""
    if x.dtype == torch.bfloat16 and (c % 8 or (c // heads) % 8):
        raise ValueError(f"{what}: bf16 needs C and the head width "
                         f"({c}/{heads}) to be multiples of 8")


def kernel_attn(attn, x):
    """attn as the kernels read it: rounded to x's dtype, contiguous (once
    a launch, d^2 values a head)."""
    return attn.to(x.dtype).contiguous()


def mdta_apply(v, x, attn, w_proj):
    """x2 = x + W_proj (attn v) on NHWC tensors: the apply kernel alone.

    v, x: (B, H, W, C); attn: (B, heads, d, d) float32 from
    `attn_from_stats`; w_proj: (C, C[,1,1]). Returns (B, H, W, C) in x's
    dtype. A launch counts in `ln_mdta.launches`.
    """
    b, h, w, c = x.shape
    wproj = w_proj.reshape(c, c)
    if x.device.type == "cpu":
        return mdta_apply_plain(v, x, attn, wproj)
    heads = attn.shape[1]
    if (v.shape != x.shape or attn.dtype != torch.float32
            or attn.shape != (b, heads, c // heads, c // heads)):
        raise ValueError("mdta_apply: v must match x and attn be (B, heads, "
                         "d, d) float32")
    for t in (v, wproj):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("mdta_apply: v and w_proj must match x's device "
                            "and dtype")
    if attn.device != x.device:
        raise TypeError("mdta_apply: attn must be on x's device")
    check_tc_width(x, c, heads, "mdta_apply")
    smem = ln_mdta_smem(c, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mdta_apply: C={c} needs {smem} bytes of shared "
                         f"memory (> {SMEM_LIMIT})")
    v, x, wproj = (t.contiguous() for t in (v, x, wproj))
    attn = kernel_attn(attn, x)
    x2 = torch.empty_like(x)
    fn = build.function("ln_mdta_launch", [_I] + [_P] * 5 + [_I] * 6
                        + [ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), v.data_ptr(), x.data_ptr(),
                  attn.data_ptr(), wproj.data_ptr(), x2.data_ptr(), b, h, w,
                  c, heads, apply_mp(c), smem, build.stream_of(x))
    build.check(code, "ln_mdta")
    ln_mdta.launches += 1
    return x2


def mdta_apply_plain(v, x, attn, w_proj):
    """The same function in plain PyTorch (fp32 arithmetic, the kernel's
    rounding points)."""
    b, h, w, c = x.shape
    heads, d = attn.shape[1], attn.shape[2]
    dt = x.dtype
    vh = v.float().reshape(b, h * w, heads, d)
    av = torch.einsum("bhij,bphj->bphi", attn.to(dt).float(), vh)
    av = av.reshape(b, h, w, c)
    av = av.to(dt).float()
    return (x.float() + av @ w_proj.reshape(c, c).float().t()).to(dt)


def ln_mdta(x, ln_w, ln_b, w_qkv, w_dw, w_proj, temperature, num_heads: int,
            *, bias_free: bool = False, eps: float = 1e-5):
    """x + MDTA(LN(x)) on NHWC `x` (B, H, W, C), float32 or bfloat16: the
    stats pass, the softmax, the apply pass.

    ln_w, ln_b: (C,) (ln_b unused when bias_free); w_qkv: (3C, C[,1,1]);
    w_dw: (3C, 1, 3, 3) or (3C, 9); w_proj: (C, C[,1,1]); temperature:
    (heads[, 1, 1]). Weights in x's dtype (the temperature in any). On the
    CPU each pass runs its plain version.
    """
    v, stats = mdta_stats(x, ln_w, ln_b, w_qkv, w_dw, num_heads,
                          bias_free=bias_free, eps=eps)
    return mdta_apply(v, x, attn_from_stats(stats, temperature), w_proj)


ln_mdta.launches = 0
