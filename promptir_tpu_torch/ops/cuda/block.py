"""TransformerBlock tail (kernel 2 of a block).

`block_tail` replaces promptir_tpu/ops/pallas/block.py:158 fused_block_tail:
  x2 = x + W_proj (attn v);  out = x2 + W2 (gelu(h1) * h2),
  [h1, h2] = dw3x3(W1 LN2(x2)).
The kernels are csrc/block_tail.cu: tail_a up to the hidden tensor, tail_b
from it (one `block_tail` call launches both). In float32 they take the
SIMT tile, in bfloat16 the tensor cores, with the weights' packed copy
(ops/cuda/packed.py) and attn rounded to bfloat16 once a launch.

Rounding points, shared by the kernels and the plain version: attn (as it
enters the apply), attn v, x2, LN2(x2), the hidden h and the gated
gelu(h1) * h2 are each rounded to x's dtype; the products, LN statistics
and taps are fp32. In float32 this is the unfused composition exactly.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import build, packed
from promptir_tpu_torch.ops.cuda.mdta import (
    PIXELS,
    PROJ_WBUF,
    SMEM_LIMIT,
    check_tc_width,
    kernel_attn,
    mdta_apply_plain,
    tc_ld,
    tc_wbuf,
)
from promptir_tpu_torch.ops.norm import layernorm_nhwc

_P = ctypes.c_void_p
_I = ctypes.c_int
HS_LD = 2 * packed.GATE_CHUNK + 8  # staged h: a chunk's 64 channels a pixel + 8
# the bf16 gdfn_out's accumulator columns (csrc/gdfn.cuh:launch_gdfn_out_tc):
# 16 NT on an 8 x 8 tile up to C = 384, 32 NT on a 4 x 8 tile above
OUT_NT = (3, 6, 10, 12, 20, 24)
OUT_NT_WIDE = (22, 24)
TC_MAX_WIDTH = 32 * OUT_NT_WIDE[-1]


def w2_bytes(rh: int, rw: int, np_: int) -> int:
    """Bytes of the bf16 W2 product's scratch for a region of rh x rw
    pixels and np_ accumulator columns (csrc/gdfn.cuh:W2Smem): h of a chunk
    on the region's halo, its depthwise weights, the gates, two W2 chunks."""
    return ((rh + 2) * (rw + 2) * HS_LD * 2 + 64 * 9 * 4
            + rh * rw * tc_ld(packed.GATE_CHUNK) * 2 + tc_wbuf(np_) * 2)


def gdfn_out_tile(c: int):
    """(tile, accumulator columns) of the bf16 gdfn_out kernel at width c."""
    for nt in OUT_NT:
        if c <= 16 * nt:
            return (8, 8), 16 * nt
    for nt in OUT_NT_WIDE:
        if c <= 32 * nt:
            return (4, 8), 32 * nt
    raise ValueError(f"gdfn_out: bf16 takes C up to {TC_MAX_WIDTH}, got {c}")


def tail_tc_smem(c: int) -> tuple[int, int]:
    """Shared-memory bytes of the bf16 tail's two kernels at width c:
    tail_a_tc (64 pixels: v then x2 then LN2(x2), attn v, each 64 x
    tc_ld(C) bf16, and the weight double buffer) and gdfn_out_tc (w2_bytes
    on its tile)."""
    tile, cols = gdfn_out_tile(c)
    return 2 * PIXELS * tc_ld(c) * 2 + PROJ_WBUF * 2, w2_bytes(*tile, cols)


def tail_operands(x, attn, w1, wdw, w2, f: int, what: str):
    """What tail_a's launch takes beside v and x: attn in the kernels' dtype
    and, in bfloat16, the packed weights (else w1, wdw, w2 as they are), and
    the hidden tensor's channels a pixel (2Fp in bfloat16, 2F in float32)."""
    if x.dtype != torch.bfloat16:
        return attn, w1, wdw, w2, 2 * f
    c = x.shape[-1]
    if c > TC_MAX_WIDTH:
        raise ValueError(f"{what}: bf16 takes C up to {TC_MAX_WIDTH}, got {c}")
    check_tc_width(x, c, attn.shape[1], what)
    return (kernel_attn(attn, x), *packed.gdfn_weights(w1, wdw, w2),
            2 * packed.packed_f(f))


def _launch(v, x, attn, wproj, lnw, lnb, w1, wdw, w2, bias_free, eps):
    b, h, w, c = x.shape
    heads = attn.shape[1]
    f = w2.shape[1]
    smem = build.function("block_tail_smem", [_I, _I], ctypes.c_longlong)(
        build.dtype_code(x), c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"block_tail: C={c} needs {smem} bytes of shared "
                         f"memory (> {SMEM_LIMIT})")
    attn, w1, wdw, w2, f2 = tail_operands(x, attn, w1, wdw, w2, f, "block_tail")
    x2 = torch.empty_like(x)
    hid = torch.empty((b, h, w, f2), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    fn = build.function("block_tail_launch",
                        [_I] + [_P] * 12 + [_I] * 7 + [ctypes.c_float, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), v.data_ptr(), x.data_ptr(),
                  attn.data_ptr(), wproj.data_ptr(), lnw.data_ptr(),
                  None if lnb is None else lnb.data_ptr(), w1.data_ptr(),
                  wdw.data_ptr(), w2.data_ptr(), x2.data_ptr(), hid.data_ptr(),
                  out.data_ptr(), b, h, w, c, heads, f, int(bias_free), eps,
                  build.stream_of(x))
    build.check(code, "block_tail")
    return out


def block_tail(v, x, attn, w_proj, ln_w, ln_b, w1, w_dw, w2, *,
               bias_free: bool = False, eps: float = 1e-5):
    """Tail of a TransformerBlock on NHWC tensors.

    v, x: (B, H, W, C); attn: (B, heads, d, d) float32 from
    `attn_from_stats`; w_proj (C, C[,1,1]); ln_w, ln_b (C,) (ln_b unused
    when bias_free); w1 (2F, C[,1,1]); w_dw (2F, 1, 3, 3) or (2F, 9);
    w2 (C, F[,1,1]). Returns (B, H, W, C) in x's dtype.
    """
    b, h, w, c = x.shape
    f = w2.shape[1]
    wproj = w_proj.reshape(c, c)
    w1m = w1.reshape(2 * f, c)
    wdw = w_dw.reshape(2 * f, 9)
    w2m = w2.reshape(c, f)
    if x.device.type == "cpu":
        return block_tail_plain(v, x, attn, wproj, ln_w, ln_b, w1m, wdw, w2m,
                                bias_free=bias_free, eps=eps)
    if v.shape != x.shape or attn.shape[0] != b or attn.dtype != torch.float32:
        raise ValueError("block_tail: v must match x and attn be (B, heads, "
                         "d, d) float32")
    ws = [wproj, ln_w, None if bias_free else ln_b, w1m, wdw, w2m]
    for t in [v, *ws]:
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise TypeError("block_tail: v and weights must match x's device "
                            "and dtype")
    if attn.device != x.device:
        raise TypeError("block_tail: attn must be on x's device")
    v, x, attn = v.contiguous(), x.contiguous(), attn.contiguous()
    ws = [None if t is None else t.contiguous() for t in ws]
    out = _launch(v, x, attn, *ws, bias_free, eps)
    block_tail.launches += 1
    return out


block_tail.launches = 0


def block_tail_plain(v, x, attn, w_proj, ln_w, ln_b, w1, w_dw, w2, *,
                     bias_free: bool = False, eps: float = 1e-5):
    """The same function in plain PyTorch (fp32 arithmetic, the kernels'
    rounding points)."""
    c = x.shape[-1]
    f = w2.shape[1]
    dt = x.dtype

    def rt(t):
        return t.to(dt).float()

    x2 = mdta_apply_plain(v, x, attn, w_proj).float()
    y2 = rt(layernorm_nhwc(x2, ln_w, ln_b, bias_free=bias_free, eps=eps))
    hid = rt(y2 @ w1.reshape(2 * f, c).float().t())
    g1, g2 = dwconv3x3_nhwc(hid, w_dw.reshape(2 * f, 9).float()).split(f, dim=-1)
    g = rt(F.gelu(g1) * g2)
    return (x2 + g @ w2.reshape(c, f).float().t()).to(dt)
