"""Block n's tail and block n+1's stats pass in one kernel sequence.

`tail_stats` replaces promptir_tpu/ops/pallas/megablock.py:165
fused_tail_stats_padded: for two consecutive TransformerBlocks of a stack,
  x3 = block_tail(v, x, attn) of block n,
  v2, stats = mdta_stats(x3) of block n+1,
where x3 feeds block n+1's LN1 -> qkv -> depthwise taps from shared memory
instead of a read back from device memory. The kernels are
csrc/tail_stats.cu: block_tail's tail_a, then one merged kernel that
computes x3 on a spatial tile and its 1-pixel ring and runs the stats pass
on it, then the slot reduction of mdta_stats. `stats` has mdta_stats's
layout, so `attn_from_stats(stats, temperature of block n+1)` takes it.

Rounding points are those of the two functions apart: x3 is block_tail's
output bit for bit and v2 mdta_stats's on it; the Gram sums the same
products in another order. The plain version is exactly that composition.

In float32 the merged kernel takes the SIMT tile and its tile rule is
TILES'; in bfloat16 it takes the tensor cores and TC_TILES' tiles, whose
ring fills the W2 product's rows.
"""

from __future__ import annotations

import ctypes

import torch

from promptir_tpu_torch.ops.cuda import build
from promptir_tpu_torch.ops.cuda.block import (
    block_tail_plain,
    tail_operands,
    w2_bytes,
)
from promptir_tpu_torch.ops.cuda.mdta import (
    GEMM_STAGE_FLOATS,
    QKV_CHUNK,
    SMEM_LIMIT,
    STATS_BLOCKS,
    STATS_BUDGET,
    mdta_stats_plain,
    check_tc_width,
    stats_tc_bytes,
    tc_ld,
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# interior (rows, cols) of a merged block's tile, largest first
# (tail_stats_tile picks one): the tiles that two resident blocks an SM
# allow at the promptir stacks' widths.
TILES = ((8, 8), (6, 6), (4, 6))
# bfloat16: (widest C, tile) by width class (csrc/tail_stats.cu:launch_tc):
# the ring, (th + 2)(tw + 2) pixels, fills 256, 128 or 64 rows of the W2
# product, whose accumulators hold all C outputs in registers (96 a thread
# at C = 96, 192 and 384)
TC_TILES = ((48, (14, 14)), (96, (14, 14)), (192, (6, 14)), (384, (6, 6)))
GATE_CHUNK = 32  # gate channels of one chunk of the W2 product (kKC)
SM_SMEM = 233472  # bytes of shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # bytes the runtime keeps per resident block


def _smem(c: int, num_heads: int, tile, dtype=torch.float32) -> int:
    d = c // num_heads
    th, tw = tile
    ph, pi = (th + 2) * (tw + 2), th * tw
    if dtype == torch.bfloat16:
        cols = next(n for n, _ in TC_TILES if c <= n)
        return ph * tc_ld(c) * 2 + max(w2_bytes(th + 2, tw + 2, cols),
                                       stats_tc_bytes(ph, pi, d))
    ldh = (th + 4) * (tw + 4) | 1
    head = -(-(ph * c + 3 * ph) // 4) * 4
    w2_product = (64 * ldh + 64 * 9 + GATE_CHUNK * ph
                  + GEMM_STAGE_FLOATS // 2)
    stats_pass = pi * 2 * d + ph * QKV_CHUNK + GEMM_STAGE_FLOATS
    return 4 * (head + max(w2_product, stats_pass))


def tail_stats_tile(c: int, num_heads: int,
                    dtype=torch.float32) -> tuple[int, int]:
    """Interior (rows, cols) of one merged block's tile for width c and
    block n+1's heads.

    bfloat16: TC_TILES' tile of c's width class (14 x 14 up to C = 96, 6 x
    14 at 192, 6 x 6 at 384), whose ring fills the tensor-core product's
    rows; one block an SM (its accumulators take 96 registers a thread). A
    width above 384, or whose shared memory exceeds a block's, raises.

    float32: the largest of TILES whose shared memory lets two blocks share
    an SM. A SIMT block of 256 threads is latency bound alone, and on the
    H100 a second resident block gained more than the larger ring of a
    smaller tile cost (PERF.md). The promptir stacks get 8 x 8 at C =
    48 and 96 (two heads), 6 x 6 at C = 192 and 96 (one head), 4 x 6 at
    C = 384."""
    if dtype == torch.bfloat16:
        for widest, tile in TC_TILES:
            if c <= widest and _smem(c, num_heads, tile, dtype) <= SMEM_LIMIT:
                return tile
        raise ValueError(f"tail_stats: C={c}, heads={num_heads} fits no tile "
                         f"of the bf16 route (C up to {TC_TILES[-1][0]})")
    two_per_sm = SM_SMEM // 2 - BLOCK_RESERVED
    for tile in TILES:
        if _smem(c, num_heads, tile) <= two_per_sm:
            return tile
    raise ValueError(f"tail_stats: C={c}, heads={num_heads} fits no tile in "
                     f"{two_per_sm} bytes of shared memory")


def tail_stats_smem(c: int, num_heads: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one merged block, as csrc/tail_stats.cu
    (MergedSmem) carves them: x3 on the tile and its 1-pixel ring (ph x C
    fp32, then LN1's output in place), the ring's LN1 mean, rstd and flat
    pixel indices, and one scratch area that the W2 product uses first (h of
    32 gate channels and their partners on a 2-pixel ring, their taps, the
    gated values, a chunk of W2) and the stats pass then (q and k of the
    interior, one qkv chunk of the ring, the product staging tiles). In
    bfloat16 (merged_tc_bytes): x3 on the tile and its ring (bf16, then
    LN1's output in place), then one scratch area for w2_bytes and then
    stats_tc_bytes."""
    return _smem(c, num_heads, tail_stats_tile(c, num_heads, dtype), dtype)


def tail_stats_slots(b: int, h: int, w: int, c: int, num_heads: int,
                     dtype=torch.float32) -> int:
    """Slots of one image: the merged blocks of it, each walking the tiles
    slot, slot + nslots, ... and summing every head's partial Gram into its
    own slot. One a tile while the partial Grams fit STATS_BUDGET, else
    enough for about STATS_BLOCKS blocks, as mdta_stats's slots."""
    d = c // num_heads
    th, tw = tail_stats_tile(c, num_heads, dtype)
    tiles = -(-h // th) * -(-w // tw)
    per_slot = 4 * b * num_heads * (d * d + 2 * d)
    return min(tiles, max(-(-STATS_BLOCKS // b), STATS_BUDGET // per_slot))


def _launch(v, x, attn, wproj, ln2w, ln2b, w1, wdw, w2, ln1w, ln1b, wqkv,
            wdwa, num_heads, bias_free, eps):
    b, h, w, c = x.shape
    heads = attn.shape[1]
    f = w2.shape[1]
    d = c // num_heads
    code = build.dtype_code(x)
    th, tw = tail_stats_tile(c, num_heads, x.dtype)
    smem = tail_stats_smem(c, num_heads, x.dtype)
    carved = build.function("tail_stats_smem", [_I] * 5, ctypes.c_longlong)(
        code, th, tw, c, d)
    if carved != smem:
        raise RuntimeError(f"tail_stats: the kernel carves {carved} bytes of "
                           f"shared memory, the wrapper counted {smem}")
    smem_a = build.function("block_tail_smem", [_I, _I], ctypes.c_longlong)(
        code, c)
    if smem_a > SMEM_LIMIT:
        raise ValueError(f"tail_stats: C={c} needs {smem_a} bytes of shared "
                         f"memory in tail_a (> {SMEM_LIMIT})")
    attn, w1, wdw, w2, f2 = tail_operands(x, attn, w1, wdw, w2, f, "tail_stats")
    nslots = tail_stats_slots(b, h, w, c, num_heads, x.dtype)
    n = d * d + 2 * d
    x2 = torch.empty_like(x)
    hid = torch.empty((b, h, w, f2), device=x.device, dtype=x.dtype)
    x3 = torch.empty_like(x)
    v2 = torch.empty_like(x)
    part = torch.empty((b, num_heads, nslots, n), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((b, num_heads, n), device=x.device, dtype=torch.float32)
    fn = build.function("tail_stats_launch", [_I] + [_P] * 19 + [_I] * 11
                        + [ctypes.c_float, ctypes.c_longlong, _P])
    ptr = [None if t is None else t.data_ptr() for t in
           (v, x, attn, wproj, ln2w, ln2b, w1, wdw, w2, ln1w, ln1b, wqkv, wdwa,
            x2, hid, x3, v2, part, stats)]
    with build.on_card_of(x):
        err = fn(code, *ptr, b, h, w, c, heads, num_heads, f, th, tw, nslots,
                 int(bias_free), eps, smem, build.stream_of(x))
    build.check(err, "tail_stats")
    return x3, v2, stats


def tail_stats(v, x, attn, w_proj, ln2_w, ln2_b, w1, w_dw, w2, ln1_w, ln1_b,
               w_qkv, w_dwa, num_heads: int, *, bias_free: bool = False,
               eps: float = 1e-5):
    """Block n's tail and block n+1's stats pass on NHWC tensors.

    v, x: (B, H, W, C); attn: (B, heads_n, d_n, d_n) float32 from
    `attn_from_stats` of block n; block n's tail weights w_proj (C, C[,1,1]),
    ln2_w, ln2_b (C,), w1 (2F, C[,1,1]), w_dw (2F, 1, 3, 3) or (2F, 9),
    w2 (C, F[,1,1]); block n+1's stats weights ln1_w, ln1_b (C,), w_qkv
    (3C, C[,1,1]), w_dwa (3C, 1, 3, 3) or (3C, 9) and its `num_heads`.
    The LN biases are unused when bias_free (both blocks' norms share it).
    Returns x3 (B, H, W, C) and v2 (B, H, W, C) in x's dtype and block
    n+1's stats (B, num_heads, d*d + 2d) float32.
    """
    b, h, w, c = x.shape
    if c % num_heads or (c // num_heads) % 4:
        raise ValueError(f"tail_stats: head width {c}/{num_heads} must be a "
                         "multiple of 4")
    f = w2.shape[1]
    ws = [w_proj.reshape(c, c), ln2_w, ln2_b, w1.reshape(2 * f, c),
          w_dw.reshape(2 * f, 9), w2.reshape(c, f), ln1_w, ln1_b,
          w_qkv.reshape(3 * c, c), w_dwa.reshape(3 * c, 9)]
    if x.device.type == "cpu":
        return tail_stats_plain(v, x, attn, *ws, num_heads,
                                bias_free=bias_free, eps=eps)
    if v.shape != x.shape or attn.shape[0] != b or attn.dtype != torch.float32:
        raise ValueError("tail_stats: v must match x and attn be (B, heads, "
                         "d, d) float32")
    if bias_free:
        ws[2] = ws[7] = None
    for t in [v, *ws]:
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise TypeError("tail_stats: v and weights must match x's device "
                            "and dtype")
    if attn.device != x.device:
        raise TypeError("tail_stats: attn must be on x's device")
    check_tc_width(x, c, num_heads, "tail_stats")
    v, x, attn = v.contiguous(), x.contiguous(), attn.contiguous()
    ws = [None if t is None else t.contiguous() for t in ws]
    out = _launch(v, x, attn, *ws, num_heads, bias_free, eps)
    tail_stats.launches += 1
    return out


tail_stats.launches = 0


def tail_stats_plain(v, x, attn, w_proj, ln2_w, ln2_b, w1, w_dw, w2, ln1_w,
                     ln1_b, w_qkv, w_dwa, num_heads: int, *,
                     bias_free: bool = False, eps: float = 1e-5):
    """The same function in plain PyTorch: block_tail_plain, then
    mdta_stats_plain on its output."""
    x3 = block_tail_plain(v, x, attn, w_proj, ln2_w, ln2_b, w1, w_dw, w2,
                          bias_free=bias_free, eps=eps)
    v2, stats = mdta_stats_plain(x3, ln1_w, ln1_b, w_qkv, w_dwa, num_heads,
                                 bias_free=bias_free, eps=eps)
    return x3, v2, stats
