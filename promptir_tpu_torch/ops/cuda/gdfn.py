"""LN + GDFN, the X-Restormer spatial feed-forward.

`ln_gdfn` replaces promptir_tpu/ops/pallas/gdfn.py:536 fused_ln_gdfn:
  out = x + W2 (gelu(h1) * h2),  [h1, h2] = dw3x3(W1 LN(x)).
Its kernels are csrc/ln_gdfn.cu. In bfloat16 one pass keeps h on the chip
(ln_gdfn_tc_kernel): a block takes a spatial tile and all C outputs,
recomputes LN and W1 on the tile's 1-pixel halo, and sums W2 over the gate
chunks in registers; `ln_gdfn_plan` picks the tile and, where the tiles do
not fill the card, a split of the gate chunks over blocks whose fp32
partial sums a second small kernel adds to x in slot order. The weights go
in their packed copy (ops/cuda/packed.py). In float32 two SIMT kernels
split at h (ln_gdfn_a, then the gdfn_out kernel that block_tail's tail_b
also is, csrc/gdfn.cuh); one `ln_gdfn` call launches both.

Rounding points, shared by the kernels and the plain version: LN(x), the
hidden h and the gated gelu(h1) * h2 are each rounded to x's dtype; the
products, LN statistics and taps are fp32. In float32 this is the unfused
composition exactly (promptir_tpu/ops/pallas/autodiff.py:78 xla_ln_gdfn).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import build, packed
from promptir_tpu_torch.ops.cuda.mdta import (
    GEMM_STAGE_FLOATS,
    NUM_SMS,
    SMEM_LIMIT,
    tc_ld,
)
from promptir_tpu_torch.ops.norm import layernorm_nhwc

_P = ctypes.c_void_p
_I = ctypes.c_int
THREADS = 256


PIXELS = 64  # pixels of a float32 ln_gdfn_a block (kPT)
SM_SMEM = 233472  # bytes of shared memory of one SM (common.cuh:kSmSmem)
BLOCK_RESERVED = 1024  # bytes the runtime keeps per resident block
GATE_CHUNK = packed.GATE_CHUNK  # gate channels of one W2 chunk
HS_LD = 2 * GATE_CHUNK + 8  # staged h: a chunk's 64 channels a pixel + 8
# the bf16 kernel's tiles, each with the NT2 it is instantiated at
# (csrc/ln_gdfn.cu:launch_fused): NT2 = ceil(C / 64) output tiles a warp
FUSED_TILES = {(8, 8): (1, 2, 3, 4, 5, 6), (4, 8): (11, 12)}


def fused_ks(nt2: int, c: int) -> int:
    """k16 steps of one streamed W1 piece (csrc/ln_gdfn.cu:fused_ks): 3 up
    to C = 128, 5 at 129-192 off the multiples of 64, else 4; the served
    widths take whole pieces."""
    return 3 if nt2 <= 2 else 5 if nt2 == 3 and c % 64 else 4
MAX_SPLIT = 8  # gate-chunk splits of one tile, at most
# the plan's cost units are SM cycles: shared-memory bytes over 128 a
# cycle for the products' operands, GATE_CYCLES a gate per lane over the
# SM's 128 lanes, BARRIER_CYCLES a barrier, the split's partial sums over
# the card's bytes a cycle (3.35 TB/s at 1.755 GHz) and LAUNCH_CYCLES for
# the second launch
GATE_CYCLES = 60
BARRIER_CYCLES = 100
CARD_BYTES_PER_CYCLE = 1909
LAUNCH_CYCLES = 4000
# two blocks an SM do this much more work in a time than one
PAIR_OVERLAP = 1.5


class GdfnPlan(NamedTuple):
    """How the bf16 ln_gdfn runs at one input: the tile, the gate-chunk
    split (blocks a tile, 1 for none), the block's shared-memory bytes and
    the blocks an SM may hold."""
    tile: tuple
    split: int
    smem: int
    occupancy: int


class _Tile(NamedTuple):
    ph: int  # halo pixels
    npx: int  # tile pixels
    mh: int  # W1 product rows (the halo padded)
    wm1: int
    wn1: int
    wm2: int
    wn2: int


def _tile_layout(th: int, tw: int) -> _Tile:
    """The warp layouts of csrc/ln_gdfn.cu:FusedTile."""
    ph, npx = (th + 2) * (tw + 2), th * tw
    m1t = -(-ph // 16)
    wm1 = 4 if m1t >= 4 else 1
    mh = wm1 * -(-m1t // wm1) * 16
    m2t = npx // 16
    wm2 = m2t // min(4, m2t)
    return _Tile(ph, npx, mh, wm1, 8 // wm1, wm2, 8 // wm2)


def fused_nt2(tile, c: int) -> int | None:
    """NT2 of the bf16 kernel at `tile` and width c, None where it has no
    instantiation."""
    nt = -(-c // 64)
    return nt if nt in FUSED_TILES.get(tuple(tile), {}) else None


def _config(tile, c: int):
    """(NP, W1 piece depth KP, ring stages NS, W2 buffers NB, blocks an SM
    by the launch bounds) of csrc/ln_gdfn.cu:FusedConfig."""
    t = _tile_layout(*tile)
    nt2 = fused_nt2(tile, c)
    np_ = t.wn2 * 8 * nt2
    acc = (t.mh // t.wm1 // 16) * (8 // t.wn1) * 4 + min(4, t.npx // 16) * nt2 * 4
    minb = 2 if tile[0] == 8 and acc <= 64 else 1
    return (np_, 16 * fused_ks(nt2, c), (2 if np_ <= 64 else 4),
            (1 if tile[0] == 4 else 2), minb)


def fused_smem(tile, c: int) -> int:
    """Bytes of one bf16 block (csrc/ln_gdfn.cu:FusedSmem): LN(x) on the
    halo (MH x tc_ld(C) bf16), the W1 ring (NS x 64 x tc_ld(KP) bf16), W2's
    chunk buffers (NB x NP x 40 bf16) and depthwise weights (NB x 64 x 9
    fp32), h on the halo (PH x 72 bf16), the gates (NPX x 40 bf16)."""
    t = _tile_layout(*tile)
    np_, kp, ns, nb, _ = _config(tile, c)
    ld_g = tc_ld(GATE_CHUNK)
    return (t.mh * tc_ld(c) * 2 + ns * 2 * GATE_CHUNK * tc_ld(kp) * 2
            + nb * np_ * ld_g * 2 + nb * 2 * GATE_CHUNK * 9 * 4
            + t.ph * HS_LD * 2 + t.npx * ld_g * 2)


def _tiles(h: int, w: int, tile) -> int:
    return -(-h // tile[0]) * -(-w // tile[1])


def chunk_cycles(tile, c: int) -> float:
    """The plan's cost of one gate chunk of one block: W1's operands over
    the halo (tc_ld-free bytes of the ldmatrix reads), the gates, W2's
    operands, and the chunk's barriers."""
    t = _tile_layout(*tile)
    np_, kp = _config(tile, c)[:2]
    steps = -(-c // kp) * kp // 16
    w1 = steps * (t.wn1 * t.mh + t.wm1 * 2 * GATE_CHUNK) * 32 / 128
    w2 = 2 * (t.wn2 * t.npx + t.wm2 * np_) * 32 / 128
    gates = t.npx * GATE_CHUNK * GATE_CYCLES / 128
    return w1 + w2 + gates + (-(-c // kp) + 2) * BARRIER_CYCLES


def chunk_ranges(nk: int, split: int) -> list[range]:
    """The gate chunks of each of `split` blocks of one tile, as the kernel
    takes them (csrc/ln_gdfn.cu: kc0 = z nk / S, kc1 = (z + 1) nk / S)."""
    return [range(z * nk // split, (z + 1) * nk // split) for z in range(split)]


def occupancy(tile, c: int) -> int:
    """Blocks of the bf16 kernel an SM holds: by shared memory, at most the
    launch bounds' (2 at the 8-row tiles with small accumulators, else 1)."""
    by_smem = SM_SMEM // (fused_smem(tile, c) + BLOCK_RESERVED)
    return max(0, min(by_smem, _config(tile, c)[4]))


def plan_cycles(b: int, h: int, w: int, c: int, f: int, tile,
                split: int) -> float:
    """The plan's cost of a launch: the busiest SM's waves of blocks, each
    block its share of the gate chunks (chunk_cycles) plus LN on the halo,
    two blocks an SM doing PAIR_OVERLAP times one's work in a time; a split
    adds its partial sums' traffic (written and read) and a second launch."""
    t = _tile_layout(*tile)
    occ = occupancy(tile, c)
    blocks = b * _tiles(h, w, tile) * split
    waves = -(-blocks // (NUM_SMS * occ))
    per_block = (-(-packed.packed_f(f) // GATE_CHUNK // split)
                 * chunk_cycles(tile, c) + t.ph * c / 8)
    cost = waves * per_block * occ / (PAIR_OVERLAP if occ > 1 else 1)
    if split > 1:
        cost += ((split + 1) * b * h * w * c * 4 / CARD_BYTES_PER_CYCLE
                 + LAUNCH_CYCLES)
    return cost


@functools.lru_cache(maxsize=None)
def ln_gdfn_plan(b: int, h: int, w: int, c: int, f: int) -> GdfnPlan:
    """The tile and gate-chunk split of the bf16 ln_gdfn at an input of
    (b, h, w, c) with F = f hidden channels: of the tiles with an
    instantiation at c that fit SMEM_LIMIT, and splits from 1 to MAX_SPLIT
    (at most the Fp / 32 chunks), the pair of least plan_cycles; on a tie
    the fewer blocks. Raises when no tile takes c."""
    fit = [t for t in FUSED_TILES if fused_nt2(t, c) is not None
           and fused_smem(t, c) <= SMEM_LIMIT and occupancy(t, c) > 0]
    if not fit or c % 8:
        raise ValueError(f"ln_gdfn: bf16 takes C a multiple of 8 with a tile "
                         f"of {tuple(FUSED_TILES)}, got {c}")
    nk = packed.packed_f(f) // GATE_CHUNK
    best = min(((plan_cycles(b, h, w, c, f, t, s), _tiles(h, w, t) * s, t, s)
                for t in fit for s in range(1, min(MAX_SPLIT, nk) + 1)),
               key=lambda r: r[:2])
    tile, split = best[2], best[3]
    return GdfnPlan(tile, split, fused_smem(tile, c), occupancy(tile, c))


def ln_gdfn_smem(c: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one block at width c. float32: an ln_gdfn_a
    block of 64 pixels (the x tile C x 64 fp32, the product staging tiles
    and the LN reduction); bfloat16: the one-pass block at the largest tile
    that takes c (fused_smem)."""
    if dtype == torch.bfloat16:
        tiles = [t for t in FUSED_TILES if fused_nt2(t, c) is not None]
        if not tiles:
            raise ValueError(f"ln_gdfn: bf16 has no tile for C={c}")
        return fused_smem(tiles[0], c)
    return (c * PIXELS + GEMM_STAGE_FLOATS + THREADS + 2 * PIXELS) * 4


def _launch(x, lnw, lnb, w1, wdw, w2, f, bias_free, eps):
    """Launch on contiguous x and weights: in bfloat16 the packed copy
    (ops/cuda/packed.py), in float32 w1 (2F, C), wdw (2F, 9), w2 (C, F)."""
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        plan = ln_gdfn_plan(b, h, w, c, f)
        (th, tw), split, smem = plan.tile, plan.split, plan.smem
        # the split's fp32 partial sums
        hid = (torch.empty((split, b, h, w, c), device=x.device,
                           dtype=torch.float32) if split > 1 else None)
    else:
        th = tw = 0
        split = 1
        smem = ln_gdfn_smem(c, x.dtype)
        if smem > SMEM_LIMIT:
            raise ValueError(f"ln_gdfn: C={c} needs {smem} bytes of shared "
                             f"memory (> {SMEM_LIMIT})")
        hid = torch.empty((b, h, w, 2 * f), device=x.device, dtype=x.dtype)
    fn = build.function("ln_gdfn_launch",
                        [_I] + [_P] * 8 + [_I] * 6
                        + [ctypes.c_float] + [_I] * 3
                        + [ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), x.data_ptr(), lnw.data_ptr(),
                  None if lnb is None else lnb.data_ptr(), w1.data_ptr(),
                  wdw.data_ptr(), w2.data_ptr(),
                  None if hid is None else hid.data_ptr(), out.data_ptr(), b,
                  h, w, c, f, int(bias_free), eps, th, tw, split, smem,
                  build.stream_of(x))
    build.check(code, "ln_gdfn")
    return out


def _aligned(t):
    """t contiguous at a 16-byte aligned address (the bf16 kernel reads the
    LN weights 16 bytes at a time): t itself, or a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ln_gdfn(x, ln_w, ln_b, w1, w_dw, w2, *, bias_free: bool = False,
            eps: float = 1e-5):
    """x + GDFN(LN(x)) on NHWC `x` (B, H, W, C), float32 or bfloat16.

    ln_w, ln_b: (C,) (ln_b unused when bias_free); w1: (2F, C[,1,1]);
    w_dw: (2F, 1, 3, 3) or (2F, 9); w2: (C, F[,1,1]). Returns (B, H, W, C)
    in x's dtype.
    """
    if x.dim() != 4:
        raise ValueError(f"ln_gdfn: x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_gdfn: x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    f = w2.shape[1] if w2.dim() >= 2 else -1
    if (w2.numel() != c * f or w1.numel() != 2 * f * c
            or w_dw.numel() != 2 * f * 9 or ln_w.shape != (c,)
            or not (bias_free or (ln_b is not None and ln_b.shape == (c,)))):
        raise ValueError(
            f"ln_gdfn: weights w1 {tuple(w1.shape)}, w_dw "
            f"{tuple(w_dw.shape)}, w2 {tuple(w2.shape)}, ln_w "
            f"{tuple(ln_w.shape)}, ln_b "
            f"{None if ln_b is None else tuple(ln_b.shape)} do not fit C={c}")
    if x.device.type == "cpu":
        return ln_gdfn_plain(x, ln_w, ln_b, w1.reshape(2 * f, c),
                             w_dw.reshape(2 * f, 9), w2.reshape(c, f),
                             bias_free=bias_free, eps=eps)
    dev, dt = x.device, x.dtype
    for t in (ln_w, None if bias_free else ln_b, w1, w_dw, w2):
        if t is not None and (t.device != dev or t.dtype != dt):
            raise TypeError("ln_gdfn: weights must match x's device and dtype")
    if dt == torch.bfloat16:  # the packed copy, made once for these weights
        w1, w_dw, w2 = packed.gdfn_weights(w1, w_dw, w2)
    else:
        w1, w_dw, w2 = (w1.reshape(2 * f, c).contiguous(),
                        w_dw.reshape(2 * f, 9).contiguous(),
                        w2.reshape(c, f).contiguous())
    out = _launch(x.contiguous(), _aligned(ln_w),
                  None if bias_free else _aligned(ln_b), w1, w_dw, w2, f,
                  bias_free, eps)
    ln_gdfn.launches += 1
    return out


ln_gdfn.launches = 0


def ln_gdfn_plain(x, ln_w, ln_b, w1, w_dw, w2, *, bias_free: bool = False,
                  eps: float = 1e-5):
    """The same function in plain PyTorch (fp32 arithmetic, the kernels'
    rounding points)."""
    c = x.shape[-1]
    f = w2.shape[1]
    dt = x.dtype

    def rt(t):
        return t.to(dt).float()

    y = rt(layernorm_nhwc(x.float(), ln_w, ln_b, bias_free=bias_free, eps=eps))
    hid = rt(y @ w1.reshape(2 * f, c).float().t())
    g1, g2 = dwconv3x3_nhwc(hid, w_dw.reshape(2 * f, 9).float()).split(f, dim=-1)
    g = rt(F.gelu(g1) * g2)
    return (x.float() + g @ w2.reshape(c, f).float().t()).to(dt)
