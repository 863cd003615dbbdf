"""MDTA: the statistics pass, its Gram, its softmax, and the apply pass.

`mdta_stats` replaces promptir_tpu/ops/pallas/mdta.py:317 mdta_stats:
LN1 -> 1x1 qkv -> depthwise 3x3 of an NHWC input, writing v and the
whole-image Gram q^T k and squared norms of q and k of every head. Its
kernel (csrc/mdta_stats.cu) takes all heads of a spatial tile in one block.
`stats_plan` picks, from (B, H, W, C, heads, dtype), one of two routes and
the tile: narrow heads keep the Gram in the stats pass (q and k never reach
memory); wide heads write q and k out and `mdta_gram` (the Gram kernel,
same source, counted in `mdta_gram.launches`) takes q^T k over all pixels.
`attn_from_stats` (promptir_tpu/ops/pallas/mdta.py:211) is the tiny softmax
over those statistics and stays plain PyTorch.

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
csrc/common.cuh (gemm_tile), bfloat16 the tensor cores, whose
shared-memory carving the *_smem functions here mirror.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import build
from promptir_tpu_torch.ops.norm import layernorm_nhwc

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may opt in to
NUM_SMS = 132  # SMs of the H100 SXM
GEMM_STAGE_FLOATS = 2 * 32 * 65  # gemm_tile's two kTileK x kLd staging tiles
QKV_CHUNK = 64  # qkv rows of one product pass (kTileN; the bf16 route's too)
PIXELS = 64  # pixels of a bf16 tail_a block (kPT)
PRE_LD = 72  # row stride of the bf16 stats passes' qkv chunk (kPreLd)
WEIGHT_CHUNK = 64  # k depth of a streamed weight chunk of mdta_stats (kKC)
# a tile's product rows stand for this many more in stats_tile's cost: the
# per-tile work that does not grow with the tile (x staging, LN, barriers)
TILE_OVERHEAD_ROWS = 64
# mdta_stats' narrow route: every head's running Gram and norms, heads *
# (d^2 + 2d) fp32, within this many bytes of the block's shared memory
STATS_SUMS_BUDGET = 80 << 10
# the float32 Gram (csrc/mdta_stats.cu:gram_kernel): 64 x 64 output tiles
# over pixel slices, summed by slot_sum_kernel
GRAM_TILE = 64  # output rows and columns of one Gram block (kGT)
GRAM_MAX_SLICES = 32  # pixel slices of one head's Gram, at most
GRAM_MIN_SPAN = 512  # pixels of one slice, at least (but for the last)
# the bf16 Gram (csrc/mdta_gram.cu:gram_tc_kernel)
GRAM_ROWS = 192  # output rows of a tile: three consumer warpgroups (kGRows)
GRAM_MAX_COLS = 192  # output columns of a tile, at most (kGMaxCols)
GRAM_CHUNK = 64  # pixels of a ring stage; a slice's span is a multiple (kGChunk)
GRAM_STAGES = 4  # stages of the ring (kGStages)
GRAM_MAX_CLUSTER = 16  # blocks of a cluster, one pixel slice each (kGMaxSlices)
# clusters of n Gram blocks (one block an SM) that an H100 SXM holds at once,
# cudaOccupancyMaxActiveClusters on the card (csrc/mdta_gram.cu:
# mdta_gram_tc_max_clusters): its SMs sit in GPCs of 16 to 18, so 8 of the
# 132 SMs idle at n = 8 and 12 at n = 4
GRAM_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# a slice takes at least this many chunks: the cluster's reduction costs
# ~5 us whatever the slices (the kernel's timeline on the card), a chunk ~1
GRAM_MIN_CHUNKS = 4
# past this many tiles a head, one block a tile: each tile reads its rows'
# q and its columns' k, so a head of 4 x 4 tiles (d = 704) reads q and k 4
# times over L2, and splitting its pixels too (128 blocks) made the launch
# slower (21.5 against 17.6 us at B4 32x32, H100)
GRAM_SPLIT_TILES = 4
# bytes a block (kGSmem): the ring of q and k boxes (three of each, 64
# channels by GRAM_CHUNK pixels), 1024 to align it, two barriers a stage
GRAM_SMEM = GRAM_STAGES * 2 * 3 * GRAM_CHUNK * 128 + 1024 + 2 * GRAM_STAGES * 8
# tail_stats' slots (ops/cuda/megablock.py:tail_stats_slots): at least
# STATS_BLOCKS blocks over all images, and more, up to one a tile, while
# their partial Grams fit STATS_BUDGET bytes.
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
    """Bytes of tail_stats' bf16 stats scratch for a halo of ph pixels, pi
    interior pixels and head width d (csrc/mdta_stats.cuh:StatsTcSmem): the
    qkv chunk (ph x PRE_LD fp32), q and k channel-major in bf16 (d rounded up
    to 32 rows of tc_ld(pi)), the qkv product's weight buffer, the norms'
    partial sums, the halo's LN1 mean, rstd and pixel indices."""
    rows = -(-d // 32) * 32
    return (ph * PRE_LD * 4 + 2 * rows * tc_ld(pi) * 2 + tc_wbuf(QKV_CHUNK) * 2
            + 256 * 4 + (3 * ph + 3) // 4 * 16)


def stats_rows(ph: int) -> int:
    """Rows of a bf16 stats pass's qkv product for a halo of ph pixels: 48
    (the 4 x 6 tile), else ph rounded up to 64."""
    return 48 if ph <= 48 else -(-ph // 64) * 64


# interior (rows, cols) of a stats block's tile, largest first
STATS_TILES = ((14, 14), (14, 6), (6, 6), (4, 6))
RESIDENT_C = 96  # widest C whose W_qkv stays in the bf16 stats block (resident)


class StatsPlan(NamedTuple):
    """How mdta_stats runs at one input: the route ("narrow": the Gram in
    the stats pass; "wide": q and k out, then the Gram kernel), the tile,
    the stats blocks of one image (each a slot of the slot buffer), the
    block's shared-memory bytes, and the Gram kernel's pixel slices (0 on
    the narrow route; in bf16 the blocks of a cluster, gram_plan, whose
    partial tiles stay in shared memory; in float32 slices through device
    memory, gram_slices)."""
    route: str
    tile: tuple
    nslots: int
    smem: int
    slices: int


def stats_route(c: int, num_heads: int) -> str:
    """"narrow" where all heads' running Gram and norms, heads * (d^2 + 2d)
    fp32, fit STATS_SUMS_BUDGET (d = 48 up to C = 384, d = 96 at C = 96,
    d = 40 at C = 160), else "wide" (d = 80 at C = 320: 105 KB; d = 176
    at C = 704; every one-head width from 160)."""
    d = c // num_heads
    return ("narrow" if num_heads * (d * d + 2 * d) * 4 <= STATS_SUMS_BUDGET
            else "wide")


def pass_rows(m: int) -> int:
    """qkv rows of one product pass of the bf16 stats block whose product
    has m rows: 128 for the small tiles (m <= 64), else 64
    (csrc/mdta_stats.cu:pass_rows)."""
    return 128 if m <= 64 else 64


def resident(c: int, m: int) -> bool:
    """W_qkv stays in the bf16 stats block for its life (no weight stream)
    up to C = RESIDENT_C at the 256- and 128-row products
    (csrc/mdta_stats.cu:resident)."""
    return c <= RESIDENT_C and m >= 128


def stats_tc_smem(c: int, num_heads: int, tile, wide: bool) -> int:
    """Bytes of the bf16 stats block (csrc/mdta_stats.cu:TcCarve): x and
    then LN1's output on the halo (stats_rows(ph) rows of tc_ld(C) bf16),
    the weight ring (4 chunks of 64 rows, or 3 of 128, by WEIGHT_CHUNK
    columns) or, resident, all 3C rows of W_qkv and a pass of zero rows,
    one pass's qkv (ph x (rows + 8) fp32), q and k of the interior
    pixel-major in bf16 (narrow only), the running sums, the taps' partial
    norms (512 fp32)."""
    d = c // num_heads
    th, tw = tile
    ph, pi = (th + 2) * (tw + 2), th * tw
    m = stats_rows(ph)
    np_ = pass_rows(m)
    ring = ((3 * c + np_) * tc_ld(c) * 2 if resident(c, m)
            else (4 if np_ == 64 else 3) * np_ * tc_ld(WEIGHT_CHUNK) * 2)
    sld = 2 * d if wide else d * d + 2 * d
    qk = 0 if wide else 2 * -(-pi // 16) * 16 * tc_ld(d) * 2
    return (m * tc_ld(c) * 2 + ring + ph * (np_ + 8) * 4 + qk
            + num_heads * sld * 4 + 512 * 4)


def stats_f32_smem(c: int, num_heads: int, tile) -> int:
    """Bytes of the float32 stats block (csrc/mdta_stats.cu:stats_kernel):
    q and k of the interior (pi x 2d fp32), the qkv chunk of the halo (ph x
    64 fp32), the product staging tiles, the halo's LN mean and rstd (fp32)
    and flat pixel indices (int32)."""
    d = c // num_heads
    th, tw = tile
    ph, pi = (th + 2) * (tw + 2), th * tw
    return (pi * 2 * d + ph * QKV_CHUNK + GEMM_STAGE_FLOATS + 2 * ph) * 4 + ph * 4


def stats_smem(c: int, num_heads: int, dtype=torch.float32, tile=None) -> int:
    """Shared-memory bytes of one stats block at `tile` (by default the
    largest that fits, stats_tile)."""
    tile = tile or stats_tile(c, num_heads, dtype)
    if dtype == torch.bfloat16:
        return stats_tc_smem(c, num_heads, tile,
                             stats_route(c, num_heads) == "wide")
    return stats_f32_smem(c, num_heads, tile)


def _tiles(h: int, w: int, tile) -> int:
    return -(-h // tile[0]) * -(-w // tile[1])


def stats_tile(c: int, num_heads: int, dtype=torch.float32, b=None, h=None,
               w=None) -> tuple[int, int]:
    """The stats block's tile: of STATS_TILES that fit SMEM_LIMIT, the one
    whose busiest block (stats_plan's slots) does the least work, counted as
    its tiles times (product rows + TILE_OVERHEAD_ROWS), the larger tile on
    a tie; without an image, the largest. Raises when none fits."""
    fit = [t for t in STATS_TILES
           if stats_smem(c, num_heads, dtype, t) <= SMEM_LIMIT]
    if not fit:
        raise ValueError(f"mdta_stats: C={c}, heads={num_heads} fits no tile")
    if b is None:
        return fit[0]

    def cost(t):
        n = _tiles(h, w, t)
        rows = stats_rows((t[0] + 2) * (t[1] + 2)) + TILE_OVERHEAD_ROWS
        return -(-n // _slots(b, n)) * rows

    return min(fit, key=cost)


def _slots(b: int, tiles: int) -> int:
    """Stats blocks of one image: about one an SM over the batch, at most
    one a tile."""
    return min(tiles, max(1, NUM_SMS // b))


def gram_slices(b: int, h: int, w: int, c: int, num_heads: int) -> int:
    """Pixel slices of the wide route's float32 Gram: enough for about 2 NUM_SMS
    blocks over the batch's heads and output tiles, at most
    GRAM_MAX_SLICES and at least GRAM_MIN_SPAN pixels each."""
    d = c // num_heads
    blocks = b * num_heads * -(-d // GRAM_TILE) ** 2
    return max(1, min(GRAM_MAX_SLICES, -(-2 * NUM_SMS // blocks),
                      -(-h * w // GRAM_MIN_SPAN)))


def up_to(n: int, m: int) -> int:
    """n rounded up to a multiple of m."""
    return -(-n // m) * m


class GramPlan(NamedTuple):
    """How the bf16 Gram kernel splits the wide route's Gram at one input:
    output tiles of GRAM_ROWS rows by `cols` columns (`tiles_m` x `tiles_n`
    a head), `items` = B * heads * tiles (image, head, tile), each taken by
    a cluster of `slices` blocks, block r of a cluster the pixels [r span,
    (r + 1) span) of the image; `clusters` persistent clusters walk the
    items (cluster c the items c, c + clusters, ...)."""
    cols: int
    tiles_m: int
    tiles_n: int
    items: int
    slices: int
    span: int
    clusters: int


@functools.lru_cache(maxsize=None)
def gram_plan(b: int, h: int, w: int, c: int, num_heads: int) -> GramPlan:
    """The bf16 Gram kernel's work split: the fewest column tiles of at most
    GRAM_MAX_COLS (each a multiple of 16 columns: wgmma's N), row tiles of
    GRAM_ROWS; the most pixel slices a tile (clusters of 16, 8, 4, 2 or 1
    blocks, spans of whole GRAM_CHUNKs, at least GRAM_MIN_CHUNKS each)
    whose clusters, one an item, the card holds at once (GRAM_CLUSTERS),
    one where a head has more than GRAM_SPLIT_TILES tiles; past 132 items,
    132 persistent clusters of one block."""
    d, px = c // num_heads, h * w
    tiles_m = -(-d // GRAM_ROWS)
    tiles_n = -(-d // GRAM_MAX_COLS)
    cols = up_to(-(-d // tiles_n), 16)
    items = b * num_heads * tiles_m * tiles_n
    want = 1 if tiles_m * tiles_n > GRAM_SPLIT_TILES else next(
        n for n in (16, 8, 4, 2, 1) if n == 1 or (
            items <= GRAM_CLUSTERS[n] and px >= n * GRAM_MIN_CHUNKS * GRAM_CHUNK))
    span = up_to(-(-px // want), GRAM_CHUNK)
    slices = -(-px // span)
    return GramPlan(cols, tiles_m, tiles_n, items, slices, span,
                    min(items, GRAM_CLUSTERS.get(slices, NUM_SMS // slices)))


@functools.lru_cache(maxsize=None)
def gram_launch_args(b: int, h: int, w: int, c: int, num_heads: int, ld: int):
    """gram_plan's launch as the kernel library takes it, one int array
    made once a shape (csrc/mdta_gram.cu:mdta_gram_tc_launch): [ld, B, P,
    C, heads, cols, slices, span, clusters, GRAM_SMEM], ld the floats
    between two (image, head) rows of the output."""
    p = gram_plan(b, h, w, c, num_heads)
    return (ctypes.c_int * 10)(ld, b, h * w, c, num_heads, p.cols, p.slices,
                               p.span, p.clusters, GRAM_SMEM)


def gram_items(plan: GramPlan, d: int, num_heads: int, px: int):
    """What each block of the bf16 Gram kernel takes, in the order the
    kernel's loops take it: (cluster, rank, image-head, rows (i0, i1),
    columns (j0, j1), pixels (p0, p1)) for each item a cluster walks and
    each rank of the cluster. The item's output sums the ranks' partial
    tiles over rank 0, 1, ..., slices - 1, in that order."""
    per = plan.tiles_m * plan.tiles_n
    for cl in range(plan.clusters):
        for item in range(cl, plan.items, plan.clusters):
            bh, t = divmod(item, per)
            i0 = (t // plan.tiles_n) * GRAM_ROWS
            j0 = (t % plan.tiles_n) * plan.cols
            for r in range(plan.slices):
                yield (cl, r, bh, (i0, min(d, i0 + GRAM_ROWS)),
                       (j0, min(d, j0 + plan.cols)),
                       (r * plan.span, min(px, (r + 1) * plan.span)))


@functools.lru_cache(maxsize=None)
def stats_plan(b: int, h: int, w: int, c: int, num_heads: int,
               dtype=torch.float32) -> StatsPlan:
    """The route, tile, slots and Gram slices of mdta_stats at an input of
    (b, h, w, c): about one block an SM over the batch (NUM_SMS // b an
    image, at most one a tile), each walking its image's tiles."""
    route = stats_route(c, num_heads)
    tile = stats_tile(c, num_heads, dtype, b, h, w)
    nslots = _slots(b, _tiles(h, w, tile))
    slices = 0
    if route == "wide":
        slices = (gram_plan(b, h, w, c, num_heads).slices
                  if dtype == torch.bfloat16
                  else gram_slices(b, h, w, c, num_heads))
    return StatsPlan(route, tile, nslots, stats_smem(c, num_heads, dtype, tile),
                     slices)


def stats_partial_bytes(b: int, h: int, w: int, c: int, num_heads: int,
                        dtype=torch.float32) -> int:
    """Bytes of the stats pass's slot buffer (B, heads, nslots, sld) fp32,
    sld = d^2 + 2d (narrow) or 2d (wide), plus the wide float32 route's Gram
    slices (B, heads, slices, d^2) fp32 (the bf16 Gram sums its slices in
    shared memory), at an input of (b, h, w, c). Neither grows with the
    image."""
    d = c // num_heads
    plan = stats_plan(b, h, w, c, num_heads, dtype)
    sld = d * d + 2 * d if plan.route == "narrow" else 2 * d
    slices = plan.slices if dtype == torch.float32 else 0
    return 4 * b * num_heads * (plan.nslots * sld + slices * d * d)


def _launch(x, lnw, lnb, wqkv, wdw, num_heads, bias_free, eps):
    b, h, w, c = x.shape
    d = c // num_heads
    plan = stats_plan(b, h, w, c, num_heads, x.dtype)
    wide = plan.route == "wide"
    (th, tw), code = plan.tile, build.dtype_code(x)
    _check_carving(code, th, tw, c, num_heads, int(wide), plan.smem)
    v = torch.empty_like(x)
    q, k = (torch.empty_like(x), torch.empty_like(x)) if wide else (v, v)
    sld = 2 * d if wide else d * d + 2 * d
    part = torch.empty((b, num_heads, plan.nslots, sld), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((b, num_heads, d * d + 2 * d), device=x.device,
                        dtype=torch.float32)
    fn = build.function("mdta_stats_launch",
                        [_I] + [_P] * 10 + [_I] * 10
                        + [ctypes.c_float, ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(code, x.data_ptr(), lnw.data_ptr(),
                  None if lnb is None else lnb.data_ptr(), wqkv.data_ptr(),
                  wdw.data_ptr(), v.data_ptr(), q.data_ptr(), k.data_ptr(),
                  part.data_ptr(), stats.data_ptr(), b, h, w, c, num_heads,
                  th, tw, plan.nslots, int(bias_free), int(wide), eps,
                  plan.smem, build.stream_of(x))
    build.check(code, "mdta_stats")
    mdta_stats.launches += 1
    if wide:
        _gram_into(q, k, num_heads, stats, d * d + 2 * d)
    return v, stats


@functools.lru_cache(maxsize=None)
def _check_carving(code, th, tw, c, num_heads, wide, smem):
    """Raise unless the kernel carves `smem` bytes for this block (once a
    shape: both sides are pure functions of it)."""
    carved = build.function("mdta_stats_smem", [_I] * 6, ctypes.c_longlong)(
        code, th, tw, c, num_heads, wide)
    if carved != smem:
        raise RuntimeError(f"mdta_stats: the kernel carves {carved} bytes, "
                           f"stats_smem computed {smem}")


def mdta_stats(x, ln_w, ln_b, w_qkv, w_dw, num_heads: int, *,
               bias_free: bool = False, eps: float = 1e-5):
    """Stats pass of NHWC `x` (B, H, W, C).

    ln_w, ln_b: (C,) (ln_b is unused when bias_free); w_qkv: the qkv conv
    weight, (3C, C, 1, 1) or (3C, C); w_dw: the depthwise weight, (3C, 1, 3,
    3) or (3C, 9). Returns v (B, H, W, C) in x's dtype and stats (B, heads,
    d*d + 2d) float32: [Gram q^T k (d x d) | ||q||^2 (d) | ||k||^2 (d)] per
    head, summed over the image. A launch of the stats kernel counts in
    `mdta_stats.launches`; on the wide route the Gram kernel's in
    `mdta_gram.launches`.
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
    return _launch(*args, num_heads, bias_free, eps)


mdta_stats.launches = 0


def _gram_into(q, k, num_heads, stats, ld):
    """The Gram kernel's launch into stats, rows of ld floats a (image,
    head), the Gram at [:d*d] of each: in bf16 one launch by gram_plan, in
    float32 (ld = d*d + 2d) the slices of gram_slices and their sum."""
    b, h, w, c = q.shape
    d = c // num_heads
    with build.on_card_of(q):
        if q.dtype == torch.bfloat16:
            fn = build.function("mdta_gram_tc_launch",
                                [_P] * 3 + [ctypes.POINTER(_I), _P])
            code = fn(q.data_ptr(), k.data_ptr(), stats.data_ptr(),
                      gram_launch_args(b, h, w, c, num_heads, ld),
                      build.stream_of(q))
        else:
            slices = gram_slices(b, h, w, c, num_heads)
            part = torch.empty((b, num_heads, slices, d * d), device=q.device,
                               dtype=torch.float32)
            fn = build.function("mdta_gram_launch",
                                [_I] + [_P] * 4 + [_I] * 5 + [_P])
            code = fn(build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                      part.data_ptr(), stats.data_ptr(), b, h * w, c,
                      num_heads, slices, build.stream_of(q))
    build.check(code, "mdta_gram")
    mdta_gram.launches += 1


def mdta_gram(q, k, num_heads: int):
    """The wide route's Gram kernel alone: q^T k of each head over all
    pixels of NHWC q and k (B, H, W, C) in the dtype that enters the Gram
    (bf16 or float32). Returns (B, heads, d, d) float32."""
    b, h, w, c = q.shape
    d = c // num_heads
    if q.device.type == "cpu":
        return mdta_gram_plain(q, k, num_heads)
    if k.shape != q.shape or k.device != q.device or k.dtype != q.dtype:
        raise TypeError("mdta_gram: k must match q's shape, device and dtype")
    if c % num_heads or d % 4:
        raise ValueError(f"mdta_gram: head width {c}/{num_heads} must be a "
                         "multiple of 4")
    check_tc_width(q, c, num_heads, "mdta_gram")
    q, k = q.contiguous(), k.contiguous()
    if q.dtype == torch.bfloat16:  # the kernel writes d*d a row
        stats = torch.empty((b, num_heads, d, d), device=q.device,
                            dtype=torch.float32)
        _gram_into(q, k, num_heads, stats, d * d)
        return stats
    stats = torch.empty((b, num_heads, d * d + 2 * d), device=q.device,
                        dtype=torch.float32)
    _gram_into(q, k, num_heads, stats, d * d + 2 * d)
    return stats[..., : d * d].reshape(b, num_heads, d, d)


mdta_gram.launches = 0


def mdta_gram_plain(q, k, num_heads: int):
    """The same Gram in plain PyTorch (fp32 sums of q and k as given)."""
    b, h, w, c = q.shape
    d = c // num_heads
    return torch.einsum("bphi,bphj->bhij",
                        q.float().reshape(b, h * w, num_heads, d),
                        k.float().reshape(b, h * w, num_heads, d))


def _qkv_plain(x, ln_w, ln_b, w_qkv, w_dw, bias_free, eps):
    """LN1 (rounded to x's dtype), the 1x1 qkv and the taps, fp32."""
    c = x.shape[-1]
    y = layernorm_nhwc(x.float(), ln_w, ln_b, bias_free=bias_free, eps=eps)
    y = y.to(x.dtype).float()
    qkv = dwconv3x3_nhwc(y @ w_qkv.reshape(3 * c, c).float().t(),
                         w_dw.reshape(3 * c, 9).float())
    return qkv.split(c, dim=-1)


def stats_pass_plain(x, ln_w, ln_b, w_qkv, w_dw, num_heads: int, *,
                     bias_free: bool = False, eps: float = 1e-5):
    """The wide route's stats pass in plain PyTorch: v, q and k (B, H, W, C)
    in x's dtype (q and k as they enter the Gram) and the squared norms of
    the unrounded q and k, (B, heads, 2d) float32."""
    b, h, w, c = x.shape
    d = c // num_heads
    q, k, v = _qkv_plain(x, ln_w, ln_b, w_qkv, w_dw, bias_free, eps)
    norms = torch.cat([t.reshape(b, h * w, num_heads, d).square().sum(1)
                       for t in (q, k)], dim=-1)
    dt = x.dtype
    return v.to(dt).contiguous(), q.to(dt), k.to(dt), norms


def mdta_stats_plain(x, ln_w, ln_b, w_qkv, w_dw, num_heads: int, *,
                     bias_free: bool = False, eps: float = 1e-5):
    """The same function in plain PyTorch (fp32 arithmetic, the kernel's
    rounding points)."""
    b, h, w, c = x.shape
    d = c // num_heads
    dt = x.dtype
    q, k, v = _qkv_plain(x, ln_w, ln_b, w_qkv, w_dw, bias_free, eps)
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
    """16-pixel groups of one float32 apply block's tile: 64 pixels up to
    C = 256, else 32 (more blocks for the narrow deep levels), as
    block_tail's tail_a."""
    return 4 if c <= 256 else 2


APPLY_PIXELS = (64, 32)  # pixels of a bf16 apply tile (the instantiations)
APPLY_MAX_COLS = 192  # output columns of a bf16 apply block, at most (NT 6)
APPLY_RING = 3  # stages of the bf16 apply's W_proj ring (csrc/ln_mdta.cu:kNS)
APPLY_ATTN_BUDGET = 64 << 10  # bytes of attn staged at once, all heads if they fit
APPLY_MAX_SPLIT = 16  # column blocks of one pixel tile, at most
# the apply plan's cost: a tile's chain of latencies (v and x in, the
# products, the stores) counted as APPLY_LATENCY_BYTES more bytes than it
# moves, and APPLY_SLAB_BYTES more for each slab of attn staged, each SM
# moving 1/NUM_SMS of the card's rate
APPLY_LATENCY_BYTES = 48 << 10
APPLY_SLAB_BYTES = 24 << 10


class ApplyPlan(NamedTuple):
    """How the bf16 apply runs at one input: pixels a tile, output columns
    a block (the C outputs split over ceil(C / cols) blocks), the heads and
    rows of attn staged at a time (a slab), the persistent blocks of an
    image and column block (each walking every slots-th tile), whether
    W_proj's rows stay resident in the block, the block's shared-memory
    bytes."""
    pixels: int
    cols: int
    heads_staged: int
    attn_rows: int
    slots: int
    resident: bool
    smem: int


def apply_weight_smem(c: int, cols: int) -> tuple[bool, int]:
    """(resident, bytes) of the bf16 apply block's W_proj rows: resident
    (32 ceil(cols / 32) rows of C rounded up to 64, + 8, bf16) where that
    takes no more room than the ring (APPLY_RING x 32 ceil(cols / 32) x
    tc_ld(64) bf16), else the ring (csrc/ln_mdta.cu:apply_tc_bytes)."""
    npc = 32 * -(-cols // 32)
    res = npc * (-(-c // 64) * 64 + 8) * 2
    ring = APPLY_RING * npc * tc_ld(64) * 2
    return (True, res) if res <= ring else (False, ring)


def apply_base_smem(c: int, pixels: int, cols: int) -> int:
    """Bytes of one bf16 apply block besides its slab of attn: v and attn v
    (pixels x tc_ld(C) bf16 each), x then x2 of its columns (pixels x (cols
    + 8) bf16), W_proj's rows (apply_weight_smem); with W_proj resident, a
    second buffer of v and of x (the next tile's, in flight)."""
    resident, wbytes = apply_weight_smem(c, cols)
    return ((2 + resident) * pixels * tc_ld(c) * 2
            + (1 + resident) * pixels * (cols + 8) * 2 + wbytes)


def attn_slab(c: int, heads: int, room: int = APPLY_ATTN_BUDGET):
    """(heads, rows) of attn a bf16 apply block stages at a time within
    `room` bytes (at most APPLY_ATTN_BUDGET): all heads, d rounded up to 16
    rows of tc_ld(d) bf16 each, where they fit, else the most rows of one
    head (a multiple of 16); None where not even 16 rows fit."""
    d = c // heads
    d16 = -(-d // 16) * 16
    row = tc_ld(d) * 2
    room = min(room, APPLY_ATTN_BUDGET)
    if heads * d16 * row <= room:
        return heads, d16
    rows = min(d16, room // row // 16 * 16)
    return (1, rows) if rows >= 16 else None


def _apply_slots(b: int, tiles: int, colblocks: int, smem: int) -> int:
    """Persistent blocks of one image and column block: about one wave
    (NUM_SMS x blocks an SM by shared memory, at most 2) over the launch,
    at most one a tile."""
    occ = max(1, min(2, 233472 // (smem + 1024)))
    return max(1, min(tiles, -(-NUM_SMS * occ // (b * colblocks))))


def _apply_cost(b, h, w, c, heads, pixels, cols, slab, slots, smem,
                resident):
    """The plan's cost of a bf16 apply launch in bytes of one SM: its waves
    of NUM_SMS x occ blocks (occ: blocks an SM by shared memory, at most 2),
    each wave the bytes its occ blocks move through one SM (each of the
    block's tiles: v and its x and x2 columns; W_proj's rows of the block
    and the image's attn in fp32, once a block where resident or held whole,
    else once a tile) plus, for the block's tiles, APPLY_LATENCY_BYTES a
    tile and APPLY_SLAB_BYTES a slab of attn staged (slab: heads, rows)."""
    d = c // heads
    tiles = -(-h * w // pixels)
    occ = max(1, min(2, 233472 // (smem + 1024)))
    waves = -(-b * slots * -(-c // cols) // (NUM_SMS * occ))
    per_block = -(-tiles // slots)
    once = slab == (heads, -(-d // 16) * 16)
    slabs = heads // slab[0] * -(-d // slab[1])
    moved = (per_block * pixels * (c + 2 * cols) * 2
             + (1 if resident else per_block) * cols * c * 2
             + (1 if once else per_block) * c * d * 4)
    return waves * (occ * moved + per_block * APPLY_LATENCY_BYTES
                     + (1 if once else per_block * slabs) * APPLY_SLAB_BYTES)


@functools.lru_cache(maxsize=None)
def apply_plan(b: int, h: int, w: int, c: int, heads: int) -> ApplyPlan:
    """Tiles, column blocks and persistent blocks of the bf16 apply at an
    input of (b, h, w, c): of APPLY_PIXELS, column counts (C split into 1
    to APPLY_MAX_SPLIT blocks, a multiple of 8, at most APPLY_MAX_COLS)
    whose block, with the largest slab of attn that fits (attn_slab), fits
    SMEM_LIMIT, and blocks an image (about one wave, _apply_slots, or one a
    tile): the blocks that hold all of attn before those that stage it in
    slabs; of those that hold it, the least _apply_cost, on a tie the fewer
    blocks. Where none holds it (C = 704 with 4 heads), the widest column
    blocks first: every block stages the image's attn in slabs from L2, and
    fewer blocks stage less of it, which _apply_cost does not see. Raises
    when none fits."""
    best = None
    tiles_of = {p: -(-h * w // p) for p in APPLY_PIXELS}
    for pixels in APPLY_PIXELS:
        for split in range(1, APPLY_MAX_SPLIT + 1):
            cols = -(-c // split // 8) * 8
            if cols > APPLY_MAX_COLS or cols < 8:
                continue
            base = apply_base_smem(c, pixels, cols)
            slab = attn_slab(c, heads, SMEM_LIMIT - base)
            if slab is None:
                continue
            smem = base + slab[0] * slab[1] * tc_ld(c // heads) * 2
            colblocks = -(-c // cols)
            resident = apply_weight_smem(c, cols)[0]
            tiles = tiles_of[pixels]
            whole = slab == (heads, -(-(c // heads) // 16) * 16)
            for slots in {_apply_slots(b, tiles, colblocks, smem), tiles}:
                key = (not whole, 0 if whole else -cols,
                       _apply_cost(b, h, w, c, heads, pixels, cols, slab,
                                   slots, smem, resident),
                       b * slots * colblocks)
                if best is None or key < best[0]:
                    best = (key, ApplyPlan(pixels, cols, *slab, slots,
                                           resident, smem))
    if best is None:
        raise ValueError(f"mdta_apply: bf16 has no block for C={c}, "
                         f"heads={heads}")
    return best[1]


def ln_mdta_smem(c: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one apply block (csrc/ln_mdta.cu). float32:
    attn v of its pixels (C x 16 mp fp32) and the product staging tiles;
    bfloat16: the one-head block of apply_plan at one 64 x 64 image."""
    if dtype == torch.bfloat16:
        return apply_plan(1, 64, 64, c, 1).smem
    return (c * 16 * apply_mp(c) + GEMM_STAGE_FLOATS) * 4


def check_tc_width(x, c: int, heads: int, what: str) -> None:
    """The bf16 kernels stage operands in 16-byte pieces, head by head: C
    and the head width must be multiples of 8 (every served width is)."""
    if x.dtype == torch.bfloat16 and (c % 8 or (c // heads) % 8):
        raise ValueError(f"{what}: bf16 needs C and the head width "
                         f"({c}/{heads}) to be multiples of 8")


def kernel_attn(attn, x):
    """attn as block_tail's kernels read it: rounded to x's dtype,
    contiguous (once a launch, d^2 values a head)."""
    return attn.to(x.dtype).contiguous()


def mdta_apply(v, x, attn, w_proj):
    """x2 = x + W_proj (attn v) on NHWC tensors: the apply kernel alone.

    v, x: (B, H, W, C); attn: (B, heads, d, d) float32 from
    `attn_from_stats`; w_proj: (C, C[,1,1]). Returns (B, H, W, C) in x's
    dtype. A launch counts in `ln_mdta.launches`. In bfloat16 the kernel
    reads attn in float32 and rounds it to bfloat16 as it stages it.
    """
    b, h, w, c = x.shape
    wproj = w_proj if w_proj.dim() == 2 else w_proj.reshape(c, c)
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
    if x.dtype == torch.bfloat16:
        mp, cols, ha, ar, slots, res, smem = apply_plan(b, h, w, c, heads)
    else:
        mp, cols, ha, ar, slots, res = apply_mp(c), c, heads, c // heads, 1, 0
        smem = ln_mdta_smem(c, x.dtype)
        if smem > SMEM_LIMIT:
            raise ValueError(f"mdta_apply: C={c} needs {smem} bytes of "
                             f"shared memory (> {SMEM_LIMIT})")
    v, x, attn, wproj = (t.contiguous() for t in (v, x, attn, wproj))
    x2 = torch.empty_like(x)
    fn = build.function("ln_mdta_launch", [_I] + [_P] * 5 + [_I] * 11
                        + [ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), v.data_ptr(), x.data_ptr(),
                  attn.data_ptr(), wproj.data_ptr(), x2.data_ptr(), b, h, w,
                  c, heads, mp, cols, ha, ar, slots, int(res), smem,
                  build.stream_of(x))
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
